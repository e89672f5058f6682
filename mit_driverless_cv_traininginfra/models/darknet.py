"""Spec-driven Darknet/YOLOv3 graph executor — functional form.

Capability parity with the reference ``CVC-YOLOv3/models.py`` (create_modules
:15-110, Darknet.forward :312-338, YOLOLayer decode :140-220, weight IO
:339-422), designed for XLA rather than translated:

- The graph topology comes from the frozen :class:`NetworkSpec` (a static
  jit argument), so the Python loop over blocks unrolls at trace time into
  one flat XLA program — route/shortcut become pure ``concat``/``add`` ops
  the compiler fuses freely.
- NHWC activations, HWIO weights; every conv+BN+leaky triple becomes one
  convolution with a fused elementwise epilogue.
- BatchNorm is folded into a scale/bias affine at inference time
  (:func:`fold_bn`) — no extra memory traffic on the serving path.
- Head decode keeps the reference arithmetic exactly (sigmoid xy/conf/cls,
  exp wh, height-based stride — including the reference's quirk of using
  the *height* stride for both axes, models.py:145,160).

Weight interop: Darknet ``.weights`` files (5×int32 header + float32 stream)
import/export byte-compatibly, including the 80-class→1-class ``preyolo``
slicing warm start (models.py:380-394).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    NetworkSpec,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra.models.rektnet import (
    BN_EPS,
    batch_norm,
    conv2d,
    update_running,
)

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(spec: NetworkSpec, key, dtype=jnp.float32):
    """(params, state): params[i] exists for conv blocks only; state[i] holds
    BN running stats. Keys are stringified block indices (pytree-friendly,
    stable across spec edits)."""
    params: Dict[str, dict] = {}
    state: Dict[str, dict] = {}
    chans = spec.out_channels
    keys = jax.random.split(key, len(spec.blocks))
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        cin = chans[i]
        fan_in = b.size * b.size * cin
        std = (2.0 / fan_in) ** 0.5
        w = jax.random.normal(keys[i], (b.size, b.size, cin, b.filters), dtype) * std
        p = {"w": w}
        if b.batch_normalize:
            p["bn"] = {"scale": jnp.ones((b.filters,), dtype),
                       "bias": jnp.zeros((b.filters,), dtype)}
            state[str(i)] = {"mean": jnp.zeros((b.filters,), dtype),
                             "var": jnp.ones((b.filters,), dtype)}
        else:
            p["b"] = jnp.zeros((b.filters,), dtype)
        params[str(i)] = p
    return params, state


def fold_bn(params, state, spec: NetworkSpec):
    """Fold BN into conv weight/bias for inference: w' = w·γ/σ, b' = β−μγ/σ.

    Output params have only {w, b} per conv — the serving path then never
    touches running stats and XLA emits a single fused conv+bias+leaky op.
    """
    folded: Dict[str, dict] = {}
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        p = params[str(i)]
        if b.batch_normalize:
            s = state[str(i)]
            inv = p["bn"]["scale"] / jnp.sqrt(s["var"] + BN_EPS)
            folded[str(i)] = {
                "w": p["w"] * inv[None, None, None, :],
                "b": p["bn"]["bias"] - s["mean"] * inv,
            }
        else:
            folded[str(i)] = {"w": p["w"], "b": p["b"]}
    return folded


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _maxpool(x, size: int, stride: int):
    """torch MaxPool2d semantics incl. the reference's k=2,s=1 zero-pad
    special case (models.py:74-84)."""
    if size == 2 and stride == 1:
        x = jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
        pad = [(0, 0), (0, 0)]
    else:
        p = (size - 1) // 2
        pad = [(p, p), (p, p)]
    return jax.lax.reduce_window(
        x,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(1, size, size, 1),
        window_strides=(1, stride, stride, 1),
        padding=[(0, 0)] + pad + [(0, 0)],
    )


def _upsample(x, stride: int):
    """Nearest-neighbour ×stride (models.py:86-88)."""
    x = jnp.repeat(x, stride, axis=1)
    return jnp.repeat(x, stride, axis=2)


def _leaky(x, slope: float):
    return jnp.where(x >= 0, x, x * slope)


def _packed_stem_train(spec, params, state, x, train, new_state):
    """Exact space-to-depth TRAINING stem (blocks 0–1, live BatchNorm).

    The serving pass proved the rewrite (stem_opt.py: a 3-channel conv1
    contracts K=27 per output; packed it is K=108×N=128); this is its
    training twin, same arithmetic including the BN:

    - packed weights are rebuilt from the canonical ``params`` every step
      via the differentiable :func:`~.stem_opt.pack_stem_weights_jnp`
      scatter, so checkpoints/grads stay in the reference layout;
    - BN statistics are computed on the packed layout through a PURE
      RESHAPE (B, h, w, 4·C1) → (B, h, 4w, C1): the four parity planes
      partition the full-resolution positions, so per-channel mean/var —
      and therefore the running-stat updates — equal the plain path's
      exactly (up to f32 summation order).

    Returns block-1's output (B, H/2, W/2, C2); callers must ensure the
    graph never routes to block 0's output (true for the YOLOv3 graph;
    guarded by ``stem_is_packable`` at the step level).
    """
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        pack_input,
        pack_stem_weights_jnp,
    )

    p0, p1 = params["0"], params["1"]
    w1p, w2p = pack_stem_weights_jnp(p0["w"], p1["w"])
    y = conv2d(pack_input(x), w1p, None, stride=1, padding=1)
    B, h, w, c4 = y.shape
    C1 = c4 // 4
    y = y.reshape(B, h, w * 4, C1)
    y, stats = batch_norm(y, {**p0["bn"], **state["0"]}, train)
    if train:
        new_state["0"] = update_running(state["0"], stats)
    y = _leaky(y.reshape(B, h, w, c4), spec.net.leaky_slope)
    out = jax.lax.conv_general_dilated(
        y, w2p, (1, 1), [(1, 0), (1, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    out, stats = batch_norm(out, {**p1["bn"], **state["1"]}, train)
    if train:
        new_state["1"] = update_running(state["1"], stats)
    return _leaky(out, spec.net.leaky_slope)


def forward_features(
    spec: NetworkSpec,
    params,
    state,
    x,
    train: bool = False,
    packed_stem=None,
    train_packed_stem: bool = False,
):
    """Run the backbone+necks; returns (head_outputs, new_state).

    head_outputs: list of raw pre-yolo maps, one per yolo head, each NHWC
    (B, H, W, A*(5+C)). Decode/loss are separate fns so train and eval
    share this graph (reference interleaves them in Darknet.forward).
    ``params`` may be folded (no 'bn') or unfolded; ``state`` unused when
    folded. ``packed_stem`` (serving only): space-to-depth-rewritten stem
    weights from :mod:`stem_opt` — blocks 0/1 are replaced by the exact
    packed equivalent (nothing downstream references block 0's output in
    the YOLOv3 graph).
    """
    outputs: List[jnp.ndarray] = []
    layer_outputs: List[jnp.ndarray] = []
    new_state = dict(state) if train else state
    start = 0
    if packed_stem is not None and not train:
        from mit_driverless_cv_traininginfra.models.stem_opt import (
            apply_packed_stem,
        )

        x = apply_packed_stem(packed_stem, x, spec.net.leaky_slope)
        layer_outputs = [x, x]  # slot 0 is never routed to in this graph
        start = 2
    elif train_packed_stem:
        x = _packed_stem_train(spec, params, state, x, train, new_state)
        layer_outputs = [x, x]  # slot 0 is never routed to in this graph
        start = 2
    for i, b in list(enumerate(spec.blocks))[start:]:
        if isinstance(b, ConvBlock):
            p = params[str(i)]
            pad = (b.size - 1) // 2
            has_bn = "bn" in p
            x = conv2d(x, p["w"], None if has_bn else p["b"],
                       stride=b.stride, padding=pad)
            if has_bn:
                bn_all = {**p["bn"], **state[str(i)]}
                x, stats = batch_norm(x, bn_all, train)
                if train:
                    new_state[str(i)] = update_running(state[str(i)], stats)
            if b.activation == "leaky":
                x = _leaky(x, spec.net.leaky_slope)
            elif b.activation == "ReLU":
                x = jax.nn.relu(x)
        elif isinstance(b, MaxPoolBlock):
            x = _maxpool(x, b.size, b.stride)
        elif isinstance(b, UpsampleBlock):
            x = _upsample(x, b.stride)
        elif isinstance(b, RouteBlock):
            x = jnp.concatenate([layer_outputs[li] for li in b.layers], axis=-1)
        elif isinstance(b, ShortcutBlock):
            x = layer_outputs[-1] + layer_outputs[b.from_layer]
        elif isinstance(b, YoloBlock):
            outputs.append(x)
        layer_outputs.append(x)
    return outputs, new_state


def decode_head(
    head_out,
    anchors: Sequence[Tuple[float, float]],
    img_height: int,
    num_classes: int,
    with_classes: bool = True,
):
    """YOLO anchor decode, eval branch (models.py:140-169, 213-220).

    head_out: (B, H, W, A*(5+C)) NHWC raw conv output.
    Returns (B, A*H*W, 5+C): [cx, cy, w, h] in input pixels, conf, cls.

    ``with_classes=False`` skips the class sigmoid/materialisation and
    returns (B, A*H*W, 5) — the single-class serving path never reads the
    class columns (the reference's detect/NMS use conf only,
    detect.py:84-93), and at batch 128 the 80 class channels are ~435 MB
    of pure HBM writes.
    """
    b, gh, gw, _ = head_out.shape
    na = len(anchors)
    nattr = 5 + num_classes
    stride = img_height / gh
    # Decode in f32 regardless of the head dtype: pixel coordinates reach
    # 416 where bf16's ulp is 2.0 (±1 px box-center error per head). The
    # convs stay bf16/int8 — this is the same boundary detections_int8
    # draws (quantize.py casts heads to f32 before decode), now uniform.
    head_out = head_out.astype(jnp.float32)
    # NHWC channel order equals the torch (B, A, 5+C, H, W) channel split.
    pred = head_out.reshape(b, gh, gw, na, nattr)
    pred = jnp.transpose(pred, (0, 3, 1, 2, 4))  # (B, A, H, W, 5+C)

    xy = jax.nn.sigmoid(pred[..., 0:2])
    wh = pred[..., 2:4]
    conf = jax.nn.sigmoid(pred[..., 4:5])

    grid_x = jnp.arange(gw, dtype=pred.dtype)[None, None, None, :]
    grid_y = jnp.arange(gh, dtype=pred.dtype)[None, None, :, None]
    anc = jnp.asarray(anchors, dtype=pred.dtype) / stride  # (A, 2) (w, h)
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]

    boxes = jnp.stack(
        [
            xy[..., 0] + grid_x,
            xy[..., 1] + grid_y,
            jnp.exp(wh[..., 0]) * aw,
            jnp.exp(wh[..., 1]) * ah,
        ],
        axis=-1,
    )
    if with_classes:
        cls = jax.nn.sigmoid(pred[..., 5:])
        out = jnp.concatenate([boxes * stride, conf, cls], axis=-1)
        return out.reshape(b, na * gh * gw, nattr)
    out = jnp.concatenate([boxes * stride, conf], axis=-1)
    return out.reshape(b, na * gh * gw, 5)


def head_predictions(head_out, num_anchors: int, num_classes: int):
    """Raw training-branch views (models.py:147-169): returns dict of
    sigmoid/linear components shaped (B, A, H, W, ...) for the loss."""
    b, gh, gw, _ = head_out.shape
    nattr = 5 + num_classes
    pred = head_out.reshape(b, gh, gw, num_anchors, nattr)
    pred = jnp.transpose(pred, (0, 3, 1, 2, 4))
    return {
        "x": jax.nn.sigmoid(pred[..., 0]),
        "y": jax.nn.sigmoid(pred[..., 1]),
        "w": pred[..., 2],
        "h": pred[..., 3],
        "conf": jax.nn.sigmoid(pred[..., 4]),
        # raw conf for the loss: BCE is computed from logits there — the
        # post-sigmoid form has 0·inf = NaN gradients where the sigmoid
        # saturates (yolo_loss._bce_logits)
        "conf_logit": pred[..., 4],
        "cls": jax.nn.sigmoid(pred[..., 5:]),
    }


def detections(spec: NetworkSpec, params, state, x, packed_stem=None,
               with_classes: bool = True):
    """Full eval forward: concat per-head decodes along the box axis
    (models.py:338). Returns (B, ΣA·H·W, 5+C) (or 5 if with_classes=False)."""
    heads, _ = forward_features(spec, params, state, x, train=False,
                                packed_stem=packed_stem)
    yolo_blocks = [b for b in spec.blocks if isinstance(b, YoloBlock)]
    decoded = [
        decode_head(h, yb.anchors, spec.net.height, spec.net.num_classes,
                    with_classes=with_classes)
        for h, yb in zip(heads, yolo_blocks)
    ]
    return jnp.concatenate(decoded, axis=1)


# ---------------------------------------------------------------------------
# Darknet .weights interop (models.py:339-422)
# ---------------------------------------------------------------------------


def load_darknet_weights(
    spec: NetworkSpec,
    params,
    state,
    weights_path: str,
    start_weights_dim: Optional[Sequence[int]] = None,
):
    """Read a Darknet ``.weights`` file into (params, state, header).

    Walking order per conv block: BN [bias, scale, mean, var] then conv
    weight (OIHW); preyolo blocks: conv bias then conv weight, with the
    ``start_weights_dim`` slicing that warm-starts an 80-class head into a
    smaller one by taking the first ``num_b`` filters (models.py:380-394).
    """
    from mit_driverless_cv_traininginfra.data.uri import resolve_uri

    weights_path = resolve_uri(weights_path)  # gs:// via local mirror
    if start_weights_dim is None:
        start_weights_dim = spec.net.start_weights_dim
    with open(weights_path, "rb") as fp:
        header = np.fromfile(fp, dtype=np.int32, count=5)
        weights = np.fromfile(fp, dtype=np.float32)

    params = jax.tree_util.tree_map(lambda x: x, params)  # shallow copy
    state = jax.tree_util.tree_map(lambda x: x, state)
    ptr = 0
    yolo_count = 0
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        key = str(i)
        p = dict(params[key])
        cout = b.filters
        k = b.size
        cin = p["w"].shape[2]
        if b.batch_normalize:
            s = dict(state[key])
            bn = dict(p["bn"])
            bn["bias"] = jnp.asarray(weights[ptr : ptr + cout]); ptr += cout
            bn["scale"] = jnp.asarray(weights[ptr : ptr + cout]); ptr += cout
            s["mean"] = jnp.asarray(weights[ptr : ptr + cout]); ptr += cout
            s["var"] = jnp.asarray(weights[ptr : ptr + cout]); ptr += cout
            num_w = cout * cin * k * k
            w = weights[ptr : ptr + num_w].reshape(cout, cin, k, k); ptr += num_w
            p["w"] = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
            p["bn"] = bn
            state[key] = s
        else:
            orig_dim = start_weights_dim[yolo_count] if start_weights_dim else cout
            yolo_count += 1
            p["b"] = jnp.asarray(weights[ptr : ptr + cout])
            ptr += orig_dim
            num_w_orig = orig_dim * cin * k * k
            w = weights[ptr : ptr + num_w_orig].reshape(orig_dim, cin, k, k)
            ptr += num_w_orig
            p["w"] = jnp.asarray(np.transpose(w[:cout], (2, 3, 1, 0)))
        params[key] = p
    return params, state, header


def save_darknet_weights(
    spec: NetworkSpec,
    params,
    state,
    path: str,
    header: Optional[np.ndarray] = None,
    cutoff: int = -1,
):
    """Write params back to Darknet ``.weights`` byte format
    (models.py:399-422). ``cutoff`` is a literal Python slice endpoint.

    Reference quirk: the reference's default ``cutoff=-1`` slices
    ``module_defs[:-1]`` and so never writes the LAST module's weights.
    For every real cfg the last block is a weightless yolo block and the
    bytes are identical, but for a hypothetical conv-final spec the
    reference drops that conv — we reproduce the slice verbatim so
    round-trips through the torch loader stay byte-aligned."""
    if header is None:
        header = np.zeros(5, dtype=np.int32)
    blocks = spec.blocks[:cutoff]
    with open(path, "wb") as fp:
        np.asarray(header, dtype=np.int32).tofile(fp)
        for i, b in enumerate(blocks):
            if not isinstance(b, ConvBlock):
                continue
            p = params[str(i)]
            w_oihw = np.asarray(jnp.transpose(p["w"], (3, 2, 0, 1)), dtype=np.float32)
            if b.batch_normalize:
                s = state[str(i)]
                np.asarray(p["bn"]["bias"], np.float32).tofile(fp)
                np.asarray(p["bn"]["scale"], np.float32).tofile(fp)
                np.asarray(s["mean"], np.float32).tofile(fp)
                np.asarray(s["var"], np.float32).tofile(fp)
            else:
                np.asarray(p["b"], np.float32).tofile(fp)
            w_oihw.tofile(fp)
