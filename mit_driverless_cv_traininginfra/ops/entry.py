"""int8 serving entry: conv1 as one 4×4 stride-2 conv, then blocks 1-4.

The packed stem of :mod:`models.stem_opt` computes conv1 at stride 1 on a
space-to-depth input. That packed conv1 is *exactly* a 4×4/s2 conv 3→128
on the raw frames (``build_conv1_4x4``): packed output channel (a,b,co) at
(I,J) is the original conv1 output at (2I+a, 2J+b), whose 3×3 receptive
fields jointly cover the 4×4 input patch at (2I-1, 2J-1). The rewrite
needs no space-to-depth transpose and half the MACs (K=48, no structural
zeros); the int8 output is bit-identical to the packed path (same
per-channel weight absmax ⇒ same scales). Requantize-to-conv2p-scale is
fused into the conv epilogue.

Blocks 1-4 (reference graph: conv s2 → 1×1 → 3×3 → shortcut,
CVC-YOLOv3/models.py:15-110) follow as int8 convs with int32 accumulation
and the same f32-mul → bf16-cast dequant points as
models.quantize._qconv; the result ``resq`` is block 4's output quantized
with block 5's input scale, which block 5 consumes directly.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
    ShortcutBlock,
)


def entry_block_applicable(spec: NetworkSpec) -> bool:
    """True iff blocks 0-4 are the standard YOLOv3 entry pattern at an
    even input size: [conv3×3 s1 c32, conv3×3 s2 c64, conv1×1 c32,
    conv3×3 c64, shortcut] with leaky activations, and no later block
    routes to blocks 0-3 (block 4's output is the entry path's output)."""
    b = spec.blocks
    if len(b) < 6 or spec.net.width != spec.net.height:
        return False
    if spec.net.height % 32 != 0:
        return False
    want = [(3, 1, 32), (3, 2, 64), (1, 1, 32), (3, 1, 64)]
    for blk, w in zip(b[:4], want):
        if (not isinstance(blk, ConvBlock) or blk.size != w[0]
                or blk.stride != w[1] or blk.filters != w[2]
                or blk.activation != "leaky" or not blk.batch_normalize):
            return False
    # from_layer is a relative (negative) index into layer_outputs (which
    # holds blocks 0..i-1 when block i runs): -3 at block 4 → block 1.
    if not isinstance(b[4], ShortcutBlock) or 4 + b[4].from_layer != 1:
        return False
    # the consumer (quantize.forward_features_int8 entry_q path) feeds the
    # entry path's q8 output straight into block 5 as an int8 3×3/s2 conv with
    # padding 1 — block 5 must actually BE that conv and be quantizable
    # (not preyolo), or the hardcoded stride/pad silently mis-shapes it
    b5 = b[5]
    if (not isinstance(b5, ConvBlock) or b5.size != 3 or b5.stride != 2
            or b5.activation != "leaky" or not b5.batch_normalize
            or b5.is_preyolo):
        return False
    for i, blk in enumerate(b[5:], start=5):
        # routes carry absolute indices when non-negative, python-style
        # relative ones when negative (layer_outputs has i entries).
        # The fused path pads layer_outputs slots 0-5 with block-5's
        # output, so ONLY index 5 aliases correctly — a reference to
        # block 4 (the shortcut's bf16 output) would silently read
        # block 5's instead (advisor finding r2). Reject < 5.
        layers = getattr(blk, "layers", None)
        if layers and any((li if li >= 0 else i + li) < 5 for li in layers):
            return False
        frm = getattr(blk, "from_layer", None)  # shortcuts: relative
        if frm is not None and i + frm < 5:
            return False
    return True


# ---------------------------------------------------------------------------
# conv1 as 4×4 stride-2 (XLA)
# ---------------------------------------------------------------------------


def build_conv1_4x4(folded_params) -> Dict[str, np.ndarray]:
    """Folded block-'0' weights (3,3,3,C1) → 4×4/s2 weights (4,4,3,4·C1)
    with packed-phase output order (a·2+b)·C1+co (cites stem_opt tap
    algebra; tests/test_pallas_entry.py pins it to the packed conv1)."""
    w1 = np.asarray(folded_params["0"]["w"], np.float32)
    b1 = np.asarray(folded_params["0"]["b"], np.float32)
    C, C1 = w1.shape[2], w1.shape[3]
    w4 = np.zeros((4, 4, C, 4 * C1), np.float32)
    for a in range(2):
        for b in range(2):
            for dy in range(3):
                for dx in range(3):
                    w4[a + dy, b + dx, :,
                       (a * 2 + b) * C1:(a * 2 + b + 1) * C1] += w1[dy, dx]
    return {"w": w4, "b": np.concatenate([b1] * 4)}


def quantize_entry(folded_params, amax: Dict[str, float],
                   conv1_dtype: str = "int8"):
    """Quantized parameter bundle for the int8 entry path.

    amax: calibration dict from models.quantize.calibrate — keys '0'..'3'
    are the conv input absmaxes of blocks 0-3, '5' is block 5's (the
    requant scale of the entry path's resq output).

    ``conv1_dtype``: 'int8' (default) quantizes the 4×4 conv1 weights;
    'bf16' stores them bf16 and conv1 runs as a bf16 conv (int8 buys
    little on a 3-channel input; tools/bench_conv1_4x4.py times both).
    The consumer dispatches on the bundle keys, so no API threading; both
    modes emit the same int8 hq for conv2p."""
    c4 = build_conv1_4x4(folded_params)
    w4, b4 = c4["w"], c4["b"]
    s_w = np.maximum(np.abs(w4).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    sx = {k: max(float(amax[k]), 1e-12) / 127.0 for k in ("0", "1", "2",
                                                          "3", "5")}
    if conv1_dtype == "bf16":
        ep = {
            "c1_wb": jnp.asarray(w4, jnp.bfloat16),
            "c1_b": jnp.asarray(b4, jnp.float32),
            "hq_sx_inv": jnp.float32(1.0 / sx["1"]),
        }
    else:
        ep = {
            "c1_wq": jnp.asarray(np.clip(np.round(w4 / s_w), -127, 127),
                                 jnp.int8),
            "c1_scale": jnp.asarray(sx["0"] * s_w, jnp.float32),
            "c1_b": jnp.asarray(b4, jnp.float32),
            "c1_sx_inv": jnp.float32(1.0 / sx["0"]),
            "hq_sx_inv": jnp.float32(1.0 / sx["1"]),
        }

    def q(w):
        w = np.asarray(w, np.float32)
        s = np.maximum(np.abs(w).max(axis=tuple(range(w.ndim - 1))) / 127.0,
                       1e-12)
        return (jnp.asarray(np.clip(np.round(w / s), -127, 127), jnp.int8),
                s)

    # conv2p taps (2,2,128,64) from the packed-stem rewrite of block 1
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        build_packed_stem,
    )

    packed = build_packed_stem(
        {"0": folded_params["0"], "1": folded_params["1"]})
    w2q, s2 = q(np.asarray(packed["w2"], np.float32))
    ep["w2"] = w2q.reshape(4, 128, 64)
    ep["w2_scale"] = jnp.asarray(sx["1"] * s2, jnp.float32).reshape(1, 64)
    ep["w2_b"] = jnp.asarray(packed["b2"], jnp.float32).reshape(1, 64)

    w1x1q, s1x1 = q(folded_params["2"]["w"])           # (1,1,64,32)
    ep["w1x1"] = w1x1q.reshape(64, 32)
    ep["w1x1_scale"] = jnp.asarray(sx["2"] * s1x1,
                                   jnp.float32).reshape(1, 32)
    ep["w1x1_b"] = jnp.asarray(folded_params["2"]["b"],
                               jnp.float32).reshape(1, 32)

    w3q, s3 = q(folded_params["3"]["w"])               # (3,3,32,64)
    # flattened (K=288, 64) with k = (dy*3+dx)*32 + c; _entry_rest_xla
    # reshapes it back to HWIO
    ep["w3im"] = w3q.reshape(9 * 32, 64)
    ep["w3_scale"] = jnp.asarray(sx["3"] * s3, jnp.float32).reshape(1, 64)
    ep["w3_b"] = jnp.asarray(folded_params["3"]["b"],
                             jnp.float32).reshape(1, 64)

    # requant input-scale inverses: out2→r1c1, t→r1c3, res→block5
    ep["sx"] = jnp.asarray([1.0 / sx["2"], 1.0 / sx["3"], 1.0 / sx["5"]],
                           jnp.float32).reshape(1, 3)
    return ep


def conv1_4x4_q8(frames, ep, leaky_slope: float):
    """frames (B,H,W,3) [0,1] → hq (B,H/2,W/2,128) int8 (requant fused).

    Dispatches on the bundle: ``c1_wb`` present → bf16 conv (the layout-
    bound variant quantize_entry(conv1_dtype='bf16') builds), else the
    int8 conv with on-the-fly input quantization."""
    if "c1_wb" in ep:
        acc = jax.lax.conv_general_dilated(
            frames.astype(jnp.bfloat16), ep["c1_wb"], (2, 2),
            [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)
        h = (acc + ep["c1_b"]).astype(jnp.bfloat16)
    else:
        xq = jnp.clip(jnp.round(frames.astype(jnp.float32) * ep["c1_sx_inv"]),
                      -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            xq, ep["c1_wq"], (2, 2), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        h = (acc.astype(jnp.float32) * ep["c1_scale"]
             + ep["c1_b"]).astype(jnp.bfloat16)
    h = jnp.where(h >= 0, h, h * leaky_slope)
    return jnp.clip(jnp.round(h.astype(jnp.float32) * ep["hq_sx_inv"]),
                    -127, 127).astype(jnp.int8)


# ---------------------------------------------------------------------------
# blocks 1-4: hq → resq
# ---------------------------------------------------------------------------


def _q8(x, sx_inv):
    return jnp.clip(jnp.round(x.astype(jnp.float32) * sx_inv),
                    -127, 127).astype(jnp.int8)


def _deq_leaky(acc, scale, b, slope):
    # Multiply in bf16, matching models.darknet._leaky's weak-python-float
    # multiply on bf16 tensors; the sign is preserved by the bf16 round, so
    # comparing the f32 value picks the same branch.
    y32 = acc.astype(jnp.float32) * scale + b
    y = y32.astype(jnp.bfloat16)
    return jnp.where(y32 >= 0, y, y * jnp.asarray(slope, jnp.bfloat16))


def entry_forward_int8(ep, frames, leaky_slope: float):
    """frames (B,H,W,3) → resq (B,H/2,W/2,64) int8: the 4×4/s2 conv1 then
    blocks 1-4 (int8 convs, f32 dequant epilogues)."""
    hq = conv1_4x4_q8(frames, ep, leaky_slope)
    return _entry_rest_xla(hq, ep, leaky_slope)


def _entry_rest_xla(hq, ep, leaky_slope: float):
    acc = jax.lax.conv_general_dilated(
        hq, ep["w2"].reshape(2, 2, 128, 64), (1, 1), [(1, 0), (1, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    out2 = _deq_leaky(acc, ep["w2_scale"][0], ep["w2_b"][0], leaky_slope)
    tacc = jax.lax.conv_general_dilated(
        _q8(out2, ep["sx"][0, 0]), ep["w1x1"].reshape(1, 1, 64, 32),
        (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    t = _deq_leaky(tacc, ep["w1x1_scale"][0], ep["w1x1_b"][0], leaky_slope)
    racc = jax.lax.conv_general_dilated(
        _q8(t, ep["sx"][0, 1]), ep["w3im"].reshape(3, 3, 32, 64),
        (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    b3 = _deq_leaky(racc, ep["w3_scale"][0], ep["w3_b"][0], leaky_slope)
    return _q8(b3 + out2, ep["sx"][0, 2])
