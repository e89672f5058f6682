"""Post-training int8 quantization for the serving path.

int8 tensor-core rates are twice the bf16 ones on current GPUs; whether
the serving graph gains from that is a measurement (PERF.md). This module
provides the standard PTQ recipe:

- **weights**: per-output-channel symmetric int8
  (``s_w[c] = max|w[..., c]| / 127``);
- **activations**: per-tensor symmetric int8 with scales calibrated by
  recording per-conv-input absolute maxima over calibration batches;
- **compute**: quantize input on the fly → int8 conv with int32
  accumulation → dequantize with the fused ``s_x · s_w[c]`` scale → bias →
  activation. The int32 accumulator is converted to f32 straight away:
  that is the idiom XLA hands to cuDNN's int8 convolution (s8 operands,
  f32 output); a conv that returned int32 would not lower on the GPU.
  Keeping inter-op activations in bf16 (rather than threading int8 scales
  through routes/shortcuts) costs two cheap elementwise ops per conv and
  keeps the graph transformation local and exact-shaped.

Pre-yolo head convs stay bf16 (standard practice: the detection head is
scale-sensitive and a negligible FLOP fraction).
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    NetworkSpec,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra.models.darknet import (
    _leaky,
    _maxpool,
    _upsample,
)
from mit_driverless_cv_traininginfra.models.rektnet import conv2d


def calibrate(spec: NetworkSpec, folded_params, frames) -> Dict[str, float]:
    """Run the folded f32 graph on calibration frames and record the
    absolute max of every conv input. Returns {block_idx: amax}."""
    amax = _conv_input_amax(spec, folded_params,
                            jnp.asarray(frames, jnp.float32))
    return {k: float(v) for k, v in amax.items()}


@functools.partial(jax.jit, static_argnames=("spec",))
def _conv_input_amax(spec: NetworkSpec, folded_params, x):
    amax = {}
    layer_outputs = []
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock):
            amax[str(i)] = jnp.max(jnp.abs(x))
            p = folded_params[str(i)]
            x = conv2d(x, p["w"], p["b"], stride=b.stride,
                       padding=(b.size - 1) // 2)
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
        layer_outputs.append(x)
    return amax


def quantize_params(spec: NetworkSpec, folded_params, amax: Dict[str, float],
                    act_dtype=jnp.bfloat16):
    """Folded bf16/f32 params → int8 serving params.

    Per conv block: {wq int8 HWIO, scale (Cout,) = s_x·s_w, b, s_x_inv}.
    Pre-yolo convs are passed through unquantized.
    """
    qparams: Dict[str, dict] = {}
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        p = folded_params[str(i)]
        if b.is_preyolo:
            qparams[str(i)] = {
                "w": jnp.asarray(p["w"], act_dtype),
                "b": jnp.asarray(p["b"], act_dtype),
            }
            continue
        if str(i) not in amax:
            # a silent 1.0 fallback would give this conv an input scale of
            # 1/127 and saturate any |x|>1 activation — surface the
            # spec/calibration mismatch instead
            raise KeyError(
                f"calibration amax missing for conv block {i}; re-run "
                f"calibrate_amax against this spec")
        qparams[str(i)] = _quantize_conv(p["w"], p["b"], amax[str(i)])
    return qparams


def _quantize_conv(w, b, amax_in: float):
    w = jnp.asarray(w, jnp.float32)
    s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = jnp.clip(jnp.round(w / s_w), -127, 127).astype(jnp.int8)
    s_x = max(float(amax_in), 1e-12) / 127.0
    return {
        "wq": wq,
        "scale": jnp.asarray(s_x * s_w, jnp.float32),
        "b": jnp.asarray(b, jnp.float32),
        "sx_inv": jnp.float32(1.0 / s_x),
    }


def _qconv(x, q, stride: int, padding, act_dtype, dilation: int = 1):
    """On-the-fly input quantization → int8 conv → fused dequant+bias."""
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) * q["sx_inv"]),
                  -127, 127).astype(jnp.int8)
    return _qconv_q8in(xq, q, stride, padding, act_dtype, dilation)


def _qconv_q8in(xq, q, stride: int, padding, act_dtype, dilation: int = 1):
    """int8-input variant of :func:`_qconv` — for producers that already
    emit activations quantized with this conv's input scale (the entry
    path's resq output)."""
    if isinstance(padding, int):
        padding = [(padding, padding), (padding, padding)]
    acc = jax.lax.conv_general_dilated(
        xq, q["wq"], (stride, stride), padding,
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * q["scale"] + q["b"]).astype(act_dtype)


def quantize_packed_stem(packed, amax: Dict[str, float]):
    """int8 version of the space-to-depth stem (stem_opt): conv1p's input
    scale is the frame amax (block '0' input) and conv2p's is the plain
    conv1 output amax (block '1' input) — packing only reorders pixels."""
    return {
        "c1": _quantize_conv(packed["w1"], packed["b1"], amax["0"]),
        "c2": _quantize_conv(packed["w2"], packed["b2"], amax["1"]),
    }


def forward_features_int8(spec: NetworkSpec, qparams, x,
                          act_dtype=jnp.bfloat16, packed_stem_q=None,
                          entry_q=None):
    """int8 twin of ``forward_features`` (inference only). Returns the raw
    pre-yolo head outputs.

    ``packed_stem_q`` (from :func:`quantize_packed_stem`) replaces blocks
    0/1 with the int8 space-to-depth stem — without it the 3-channel first
    conv alone costs as much as a third of the backbone.

    ``entry_q`` (from :mod:`ops.entry`.quantize_entry) replaces
    blocks 0-4 with the entry path — the 4×4/s2 conv1 then conv2p/res1
    (takes precedence over ``packed_stem_q``; requires
    ``entry_block_applicable(spec)``)."""
    from mit_driverless_cv_traininginfra.models.stem_opt import pack_input

    outputs = []
    layer_outputs = []
    x = jnp.asarray(x, act_dtype)
    start = 0
    if entry_q is not None:
        from mit_driverless_cv_traininginfra.ops.entry import (
            entry_forward_int8,
        )

        resq = entry_forward_int8(entry_q, x, spec.net.leaky_slope)
        x = _leaky(_qconv_q8in(resq, qparams["5"], 2, 1, act_dtype),
                   spec.net.leaky_slope)
        # blocks 0-4 are never routed to (entry_block_applicable); pad the
        # output list so absolute/relative indexing stays aligned
        layer_outputs = [x] * 6
        start = 6
    elif packed_stem_q is not None:
        xp = pack_input(x)
        h = _qconv(xp, packed_stem_q["c1"], 1, 1, act_dtype)
        h = _leaky(h, spec.net.leaky_slope)
        x = _qconv(h, packed_stem_q["c2"], 1, [(1, 0), (1, 0)], act_dtype)
        x = _leaky(x, spec.net.leaky_slope)
        layer_outputs = [x, x]  # slot 0 never routed to in this graph
        start = 2
    for i, b in list(enumerate(spec.blocks))[start:]:
        if isinstance(b, ConvBlock):
            q = qparams[str(i)]
            pad = (b.size - 1) // 2
            if "wq" in q:
                x = _qconv(x, q, b.stride, pad, act_dtype)
            else:
                x = conv2d(x, q["w"], q["b"], stride=b.stride, padding=pad)
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
    return outputs


# ---------------------------------------------------------------------------
# RektNet
# ---------------------------------------------------------------------------


def calibrate_rektnet(folded, crops) -> Dict[str, float]:
    """Record per-conv input amax over calibration crops for the BN-folded
    RektNet (rektnet.fold_bn output)."""
    amax = _rektnet_input_amax(folded, jnp.asarray(crops, jnp.float32))
    return {k: float(v) for k, v in amax.items()}


@jax.jit
def _rektnet_input_amax(folded, x):
    amax = {}

    def note(name, v):
        amax[name] = jnp.max(jnp.abs(v))
        return v

    h = jax.nn.relu(conv2d(note("stem", x), folded["stem"]["w"],
                           folded["stem"]["b"], padding=3))
    for i in range(1, 5):
        p = folded[f"res{i}"]
        a1 = jax.nn.relu(conv2d(note(f"res{i}.conv1", h), p["conv1"]["w"],
                                p["conv1"]["b"], padding=2, dilation=2))
        b2 = conv2d(note(f"res{i}.conv2", a1), p["conv2"]["w"],
                    p["conv2"]["b"], padding=1)
        sc = conv2d(h, p["shortcut_conv"]["w"], p["shortcut_conv"]["b"])
        amax[f"res{i}.shortcut_conv"] = amax[f"res{i}.conv1"]
        h = jax.nn.relu(sc + b2)
    amax["out"] = jnp.max(jnp.abs(h))
    return amax


def quantize_rektnet_params(folded, amax: Dict[str, float]):
    """BN-folded RektNet params → int8. The 1×1 output head stays f32
    (negligible FLOPs, heatmap-logit-sensitive)."""
    q = {"stem": _quantize_conv(folded["stem"]["w"], folded["stem"]["b"],
                                amax["stem"]),
         "out": {"w": jnp.asarray(folded["out"]["w"], jnp.float32),
                 "b": jnp.asarray(folded["out"]["b"], jnp.float32)}}
    for i in range(1, 5):
        p = folded[f"res{i}"]
        q[f"res{i}"] = {
            "conv1": _quantize_conv(p["conv1"]["w"], p["conv1"]["b"],
                                    amax[f"res{i}.conv1"]),
            "conv2": _quantize_conv(p["conv2"]["w"], p["conv2"]["b"],
                                    amax[f"res{i}.conv2"]),
            "shortcut_conv": _quantize_conv(p["shortcut_conv"]["w"],
                                            p["shortcut_conv"]["b"],
                                            amax[f"res{i}.shortcut_conv"]),
        }
    return q


def apply_rektnet_int8(q, x, act_dtype=jnp.bfloat16, hm_only: bool = False):
    """int8 serving twin of ``rektnet.apply_folded``."""
    from mit_driverless_cv_traininginfra.models.rektnet import soft_argmax_2d

    h = jax.nn.relu(_qconv(x, q["stem"], 1, 3, act_dtype))
    for i in range(1, 5):
        p = q[f"res{i}"]
        a1 = jax.nn.relu(_qconv(h, p["conv1"], 1, 2, act_dtype, dilation=2))
        b2 = _qconv(a1, p["conv2"], 1, 1, act_dtype)
        sc = _qconv(h, p["shortcut_conv"], 1, 0, act_dtype)
        h = jax.nn.relu(sc + b2)
    logits = conv2d(h.astype(jnp.float32), q["out"]["w"], q["out"]["b"])
    if hm_only:
        return logits
    logits_bkhw = jnp.transpose(logits, (0, 3, 1, 2))
    points, probs = soft_argmax_2d(logits_bkhw)
    return probs, points


def detections_int8(spec: NetworkSpec, qparams, x, act_dtype=jnp.bfloat16,
                    packed_stem_q=None, with_classes: bool = True,
                    entry_q=None):
    """int8 eval forward + standard decode. Returns (B, ΣA·H·W, 5+C)
    (or 5 if with_classes=False)."""
    from mit_driverless_cv_traininginfra.models.darknet import decode_head

    heads = forward_features_int8(spec, qparams, x, act_dtype, packed_stem_q,
                                  entry_q=entry_q)
    yolo_blocks = [b for b in spec.blocks if isinstance(b, YoloBlock)]
    decoded = [
        decode_head(h.astype(jnp.float32), yb.anchors, spec.net.height,
                    spec.net.num_classes, with_classes=with_classes)
        for h, yb in zip(heads, yolo_blocks)
    ]
    return jnp.concatenate(decoded, axis=1)
