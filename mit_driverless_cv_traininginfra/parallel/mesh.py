"""Device mesh + sharding helpers — the replacement for the reference's
``nn.DataParallel`` wrap (CVC-YOLOv3/train.py:193-195).

The reference's only parallelism is single-process data parallelism
(replicate → scatter → gather each step). Here DP is expressed the XLA way:
a 1-D ``Mesh`` over all devices, batch arrays sharded on the ``data`` axis,
params/state replicated, and ONE ``jax.jit`` of the whole train step — XLA
inserts the gradient all-reduce itself (psum on the backward pass, NCCL
between GPUs), overlapping it with computation. DP is the parity surface (SURVEY.md §2.5)
and the right default for these model sizes.

Beyond parity, two more axes are exposed over a 2-D
``(data, model)`` mesh — both pure placement changes on the SAME jitted
step functions (GSPMD inserts the collectives; no model code changes):

- **Tensor parallel** (``shard_channels``): conv kernels sharded on the
  output-channel dim over ``model``, per-channel vectors (bias / BN
  scale / BN running stats / Adam moments) sharded to match. Splits the
  weight and optimizer memory footprint across devices — the lever when
  a future model no longer fits one device's memory.
- **Spatial parallel** (``shard_spatial``): NHWC image batches sharded on
  the height dim over ``model``; XLA's spatial partitioner inserts the
  conv halo exchanges. The lever for resolutions whose activations don't
  fit one device (the batch dim stays on ``data``).

Both are certified value-preserving against the single-device step in
``tests/test_parallel_tp.py`` and exercised by ``dryrun_multichip``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh: a flat list of the devices (GPUs of one
    host are joined all to all, so the order does not matter).
    ``n_devices`` defaults to all."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def make_mesh_2d(n_data: int, n_model: int, devices=None) -> Mesh:
    """2-D ``(data, model)`` mesh: DP on the first axis, TP/SP on the second
    (the TP/SP collectives are per layer; the DP all-reduce is once per
    step)."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_model
    if len(devices) < need:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"have {len(devices)}")
    return Mesh(np.asarray(devices[:need]).reshape(n_data, n_model),
                (DATA_AXIS, MODEL_AXIS))


# Leaf names whose LAST dim is out-channels in this framework's pytrees:
# conv kernels HWIO ("w"), conv bias ("b"), BN scale/bias, BN running
# mean/var — and, because optax moment trees mirror the param tree, the
# Adam mu/nu leaves reuse the same names. Anything else (anchor tables,
# step counters, future non-channel state) replicates.
CHANNEL_LEAF_NAMES = frozenset({"w", "b", "scale", "bias", "mean", "var"})


def _leaf_name(path) -> Optional[str]:
    """Innermost dict-key / attribute name on a tree path, if any."""
    for entry in reversed(path):
        if hasattr(entry, "key"):          # DictKey
            return str(entry.key)
        if hasattr(entry, "name"):         # GetAttrKey (NamedTuple fields)
            return str(entry.name)
    return None


def shard_channels(mesh: Mesh, tree, key_allow=CHANNEL_LEAF_NAMES):
    """Tensor-parallel placement for a params/state/optimizer pytree.

    A leaf is sharded on its LAST dim over ``model`` only when BOTH hold:
    its innermost key name is in ``key_allow`` (the known
    channel-carrying leaves — see ``CHANNEL_LEAF_NAMES``) AND that dim is
    divisible by the model-axis size. Conv kernels HWIO split on O, and
    the per-output-channel vectors (bias, BN scale/bias, BN running
    mean/var, Adam mu/nu) split to match, so each device holds 1/mp of the
    weights AND optimizer state. Everything else — indivisible channel
    counts (a 3-channel stem under mp that doesn't divide it), scalars
    like the Adam count, and any leaf whose name isn't allowlisted (the
    divisible-last-dim heuristic alone would silently shard e.g. an
    (N, 2) anchor table on a non-channel dim) — replicates. Apply to the
    whole TrainState; the jitted step then runs tensor-parallel with
    GSPMD-inserted collectives. Pass ``key_allow=None`` to disable the
    name filter (positional heuristic only — caller asserts every
    divisible last dim is channels).
    """
    mp = mesh.shape[MODEL_AXIS]

    def place(path, x):
        x = jnp.asarray(x) if not hasattr(x, "ndim") else x
        named_ok = key_allow is None or _leaf_name(path) in key_allow
        if (named_ok and x.ndim >= 1 and x.shape[-1] >= mp
                and x.shape[-1] % mp == 0):
            spec = P(*([None] * (x.ndim - 1) + [MODEL_AXIS]))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, tree)


def spatial_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC images: batch over ``data``, height over ``model`` (XLA spatial
    partitioning — the partitioner inserts conv halo exchanges)."""
    return NamedSharding(mesh, P(DATA_AXIS, MODEL_AXIS))


def shard_spatial(mesh: Mesh, images):
    """Place an NHWC image batch with H split over the ``model`` axis."""
    return jax.device_put(images, spatial_sharding(mesh))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the mesh."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Place a host batch pytree with the leading axis sharded over the mesh."""
    s = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def replicate(mesh: Mesh, tree):
    """Replicate params/state across the mesh."""
    r = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, r), tree)


def pad_batch_to_devices(arr, n_devices: int, mode: str = "repeat"):
    """Pad the leading axis to a multiple of the mesh size so the last
    partial batch keeps the compiled shape. Returns (padded, n_real).

    mode="repeat" (default) wraps around onto real samples — zero padding
    would poison the YOLO loss (an all-zero target row decodes to a
    log(1e-16) wh target at cell (0,0)); repeating merely over-weights a
    few samples in the one partial batch per epoch.
    """
    n = arr.shape[0]
    rem = (-n) % n_devices
    if rem == 0:
        return arr, n
    if mode == "repeat":
        idx = np.arange(rem) % n
        pad = np.asarray(arr)[idx]
    else:
        pad = np.zeros((rem,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([np.asarray(arr), pad], axis=0), n
