"""Checkpointing: full-state resume + legacy-format interop.

Three channels (SURVEY.md §5 checkpoint/resume):
- **resume state**: the full TrainState (params, BN state, optimizer state,
  step) as one ``.npz`` of its leaves plus a few scalar metadata entries,
  written atomically (temp file, fsync, rename) so a crash mid-save leaves
  the previous checkpoint intact;
- **Darknet .weights**: byte-compatible export/import lives in
  ``models.darknet`` (save/load_darknet_weights);
- **torch .pt**: RektNet checkpoints in the reference layout
  ``{epoch, model: state_dict, optimizer}`` (train_eval.py:103-110) so
  reference tooling can consume our training runs and vice versa. Needs
  torch, imported only when a ``.pt`` is written.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import jax
import numpy as np

STATE_FILE = "state_latest.npz"
_LEAF = "leaf_{:05d}"
_META = "meta_"


def save_state(path: str, tree, **meta) -> None:
    """Write every leaf of ``tree`` (host copies) and the scalar ``meta``
    entries to ``path`` atomically."""
    arrays = {_LEAF.format(i): np.asarray(leaf)
              for i, leaf in enumerate(jax.tree_util.tree_leaves(tree))}
    arrays.update({_META + k: np.asarray(v) for k, v in meta.items()})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def restore_state(path: str, like) -> Tuple[object, Dict[str, object]]:
    """Read a :func:`save_state` file into the structure of ``like``.

    Returns ``(tree, meta)``. Raises ValueError when the file's leaf count,
    shapes or dtypes differ from ``like`` (a checkpoint of another model or
    optimizer)."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(path) as data:
        names = sorted(k for k in data.files if not k.startswith(_META))
        if len(names) != len(leaves):
            raise ValueError(f"{path}: {len(names)} leaves, expected "
                             f"{len(leaves)}")
        got = []
        for i, want in enumerate(leaves):
            have = data[_LEAF.format(i)]
            want_dtype = np.asarray(want).dtype
            if have.shape != np.shape(want) or have.dtype != want_dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {have.dtype}{list(have.shape)}, "
                    f"expected {want_dtype}{list(np.shape(want))}")
            got.append(have)
        meta = {k[len(_META):]: data[k].item() for k in data.files
                if k.startswith(_META)}
    return jax.tree_util.tree_unflatten(treedef, got), meta


def require_torch(what: str) -> None:
    """Raise a clear error now, not at the first checkpoint, when torch is
    not installed and ``what`` needs it."""
    import importlib.util

    if importlib.util.find_spec("torch") is None:
        raise RuntimeError(f"{what} writes reference-layout torch .pt files "
                           "and needs torch, which is not installed")


# ---------------------------------------------------------------------------
# RektNet torch interop
# ---------------------------------------------------------------------------

_RES_BN = ["bn1", "bn2", "shortcut_bn"]


def rektnet_params_to_state_dict(params, state):
    """Our pytree → reference ``KeypointNet`` state_dict (numpy tensors,
    torch naming: conv/bn/res{1..4}.{conv1,bn1,conv2,bn2,shortcut_conv,
    shortcut_bn}/out). Conv weights transpose HWIO→OIHW."""
    import torch

    sd = {}

    # np.array(..., copy=True): jax arrays expose read-only buffers, which
    # torch.from_numpy would wrap with an undefined-behavior warning
    def put_conv(prefix, p):
        w_oihw = np.array(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
        sd[f"{prefix}.weight"] = torch.from_numpy(w_oihw)
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(p["b"]))

    def put_bn(prefix, bn_p, bn_s):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.array(bn_p["scale"]))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(bn_p["bias"]))
        sd[f"{prefix}.running_mean"] = torch.from_numpy(np.array(bn_s["mean"]))
        sd[f"{prefix}.running_var"] = torch.from_numpy(np.array(bn_s["var"]))
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    put_conv("conv", {"w": params["stem"]["w"], "b": params["stem"]["b"]})
    put_bn("bn", params["stem"]["bn"], state["stem"])
    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        put_conv(f"res{i}.conv1", p["conv1"])
        put_bn(f"res{i}.bn1", p["bn1"], s["bn1"])
        put_conv(f"res{i}.conv2", p["conv2"])
        put_bn(f"res{i}.bn2", p["bn2"], s["bn2"])
        put_conv(f"res{i}.shortcut_conv", p["shortcut_conv"])
        put_bn(f"res{i}.shortcut_bn", p["shortcut_bn"], s["shortcut_bn"])
    put_conv("out", params["out"])
    return sd


def _rektnet_param_entries(tree):
    """Yield (torch_key, numpy array) for every *parameter* (no BN buffers)
    of a params-shaped pytree, in the reference ``KeypointNet``'s module
    registration order (keypoint_net.py:17-25, resnet.py:12-20) — i.e. the
    order of ``model.parameters()``. Conv weights transpose HWIO→OIHW.
    Works on params themselves and on any same-structured tree (Adam mu/nu).
    """
    def conv(prefix, p):
        yield f"{prefix}.weight", np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
        yield f"{prefix}.bias", np.asarray(p["b"])

    def bn(prefix, p):
        yield f"{prefix}.weight", np.asarray(p["scale"])
        yield f"{prefix}.bias", np.asarray(p["bias"])

    yield from conv("conv", {"w": tree["stem"]["w"], "b": tree["stem"]["b"]})
    yield from bn("bn", tree["stem"]["bn"])
    for i in range(1, 5):
        p = tree[f"res{i}"]
        yield from conv(f"res{i}.conv1", p["conv1"])
        yield from bn(f"res{i}.bn1", p["bn1"])
        yield from conv(f"res{i}.conv2", p["conv2"])
        yield from bn(f"res{i}.bn2", p["bn2"])
        yield from conv(f"res{i}.shortcut_conv", p["shortcut_conv"])
        yield from bn(f"res{i}.shortcut_bn", p["shortcut_bn"])
    yield from conv("out", tree["out"])


def _find_adam_state(opt_state):
    """Locate the ScaleByAdamState (mu/nu/count) inside an arbitrarily
    nested optax state (inject_hyperparams wrapper, chains)."""
    found = []

    def visit(node):
        if found:
            return
        if hasattr(node, "mu") and hasattr(node, "nu") and hasattr(node, "count"):
            found.append(node)
            return
        if hasattr(node, "inner_state"):
            visit(node.inner_state)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)

    visit(opt_state)
    return found[0] if found else None


def rektnet_optimizer_state_dict(opt_state, lr: Optional[float] = None):
    """Our optax Adam state → ``torch.optim.Adam.state_dict()`` layout, so
    the ``optimizer`` slot of the ``.pt`` checkpoint is resumable by the
    reference's own tooling (train_eval.py:108-110 saves
    ``optimizer.state_dict()``; a resume does ``load_state_dict``).

    optax's ``mu``/``nu`` are exactly torch Adam's biased first/second
    moments (``exp_avg``/``exp_avg_sq``); ``count`` is torch's ``step``
    (both count completed updates, and both apply bias correction from it).
    Returns {} if no Adam state is found (e.g. SGD)."""
    import torch

    adam = _find_adam_state(opt_state)
    if adam is None:
        return {}
    step = int(np.asarray(adam.count))
    mus = [a for _, a in _rektnet_param_entries(adam.mu)]
    nus = [a for _, a in _rektnet_param_entries(adam.nu)]
    state = {
        i: {
            "step": torch.tensor(float(step)),
            "exp_avg": torch.from_numpy(
                np.ascontiguousarray(m.astype(np.float32))),
            "exp_avg_sq": torch.from_numpy(
                np.ascontiguousarray(v.astype(np.float32))),
        }
        for i, (m, v) in enumerate(zip(mus, nus))
    }
    if lr is None:
        try:
            lr = float(np.asarray(opt_state.hyperparams["lr"]))
        except (AttributeError, KeyError, TypeError):
            lr = 1e-3
    group = {
        "lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
        "amsgrad": False, "maximize": False, "foreach": None,
        "capturable": False, "differentiable": False, "fused": None,
        "params": list(range(len(mus))),
    }
    return {"state": state, "param_groups": [group]}


def save_rektnet_pt(path: str, params, state, epoch: int = 0,
                    optimizer_state=None) -> None:
    """Write a reference-layout ``.pt`` checkpoint (train_eval.py:103-110).

    Pass ``optimizer_state`` (an optax state or a ready torch-layout dict)
    so the checkpoint carries real Adam moments like the reference's does.
    """
    import torch

    if optimizer_state is not None and not isinstance(optimizer_state, dict):
        optimizer_state = rektnet_optimizer_state_dict(optimizer_state)
    ckpt = {
        "epoch": epoch,
        "model": rektnet_params_to_state_dict(params, state),
        "optimizer": optimizer_state if optimizer_state is not None else {},
    }
    torch.save(ckpt, path)
