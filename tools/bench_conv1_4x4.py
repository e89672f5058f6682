"""Microbench: conv1p as a single 4x4 stride-2 conv on raw frames.

The packed stem's conv1p (3x3 over the 2x2-packed grid, 12->128) is exactly
a 4x4 stride-2 conv 3->128 on the original frames: packed output channel
(a,b,co) at (I,J) is original conv1 output at (2I+a, 2J+b), which reads
frame rows 2I+a+dy-1, i.e. the 4x4 patch starting at (2I-1, 2J-1).
w4[a+dy, b+dx, c, (2a+b)*32+co] = w1[dy, dx, c, co].

This kills both the space-to-depth transpose and the narrow-12-channel
conv layout, and halves the MACs (K=48 vs K=108 with structural zeros).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from mit_driverless_cv_traininginfra.utils.jaxcache import (
    enable_compile_cache,
)

enable_compile_cache()

import jax.numpy as jnp
import numpy as np


from mit_driverless_cv_traininginfra.utils.profiling import time_ms


def _time_ms(fn, iters=32):
    return time_ms(fn, iters)


def conv1_4x4_weights(folded_params):
    """folded blocks '0' (3,3,3,32) -> w4 (4,4,3,128) with packed-channel
    output order (a*2+b)*32+co, b4 (128,)."""
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
    b4 = np.concatenate([b1] * 4)
    return w4, b4


def main():
    import bench as bench_mod
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate, quantize_packed_stem, quantize_params,
    )
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        build_packed_stem, pack_input, slice_preyolo,
    )
    from mit_driverless_cv_traininginfra.models.quantize import _qconv

    batch = 128
    spec = flagship_spec(416)
    params, state, _, _ = bench_mod._train_synthetic(spec)
    folded = fold_bn(params, state, spec)
    spec, folded = slice_preyolo(spec, folded)
    packed = build_packed_stem(folded)
    rng = np.random.default_rng(42)
    frames_np, _ = yolo_batch(rng, batch, size=416)
    cal = jnp.asarray(frames_np[:8], jnp.float32)
    amax = calibrate(spec, folded, cal)
    yolo_q = quantize_params(spec, folded, amax)
    stem_q = quantize_packed_stem(packed, amax)

    w4, b4 = conv1_4x4_weights(folded)
    # int8 quantization of w4, per output channel
    s_w = np.maximum(np.abs(w4).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    w4q = jnp.asarray(np.clip(np.round(w4 / s_w), -127, 127), jnp.int8)
    s_x = max(float(amax["0"]), 1e-12) / 127.0
    scale4 = jnp.asarray(s_x * s_w, jnp.float32)
    b4 = jnp.asarray(b4, jnp.float32)
    sx_inv = jnp.float32(1.0 / s_x)
    sx2_inv = stem_q["c2"]["sx_inv"]
    slope = spec.net.leaky_slope

    frames = jax.device_put(jnp.asarray(frames_np, jnp.bfloat16),
                            jax.devices()[0])

    def v4_(f):
        xq = jnp.clip(jnp.round(f.astype(jnp.float32) * sx_inv),
                      -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            xq, w4q, (2, 2), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        h = (acc.astype(jnp.float32) * scale4 + b4).astype(jnp.bfloat16)
        h = jnp.where(h >= 0, h, h * slope)
        return jnp.clip(jnp.round(h.astype(jnp.float32) * sx2_inv),
                        -127, 127).astype(jnp.int8)

    v4 = jax.jit(v4_)

    # bf16 variant (no input quantize; weights bf16)
    w4b = jnp.asarray(w4, jnp.bfloat16)
    b4b = jnp.asarray(b4, jnp.bfloat16)

    def v4b_(f):
        acc = jax.lax.conv_general_dilated(
            f, w4b, (2, 2), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)
        h = (acc + b4b.astype(jnp.float32)).astype(jnp.bfloat16)
        h = jnp.where(h >= 0, h, h * slope)
        return jnp.clip(jnp.round(h.astype(jnp.float32) * sx2_inv),
                        -127, 127).astype(jnp.int8)

    v4b = jax.jit(v4b_)

    # baseline: the packed-stem conv1 stage exactly as the int8 serving
    # graph runs it (forward_features_int8's packed_stem_q path), with the
    # same conv2-input requant tail as the 4×4 variants
    def old_(f):
        h = _qconv(pack_input(f), stem_q["c1"], 1, 1, jnp.bfloat16)
        h = jnp.where(h >= 0, h, h * slope)
        return jnp.clip(jnp.round(h.astype(jnp.float32) * sx2_inv),
                        -127, 127).astype(jnp.int8)

    old = jax.jit(old_)

    print(f"old packed conv1p    : {_time_ms(lambda: old(frames)):8.2f} ms/batch")
    print(f"new 4x4s2 int8       : {_time_ms(lambda: v4(frames)):8.2f} ms/batch")
    print(f"new 4x4s2 bf16       : {_time_ms(lambda: v4b(frames)):8.2f} ms/batch")

    # agreement check (int8 quantization of w4 differs from w1p path only by
    # per-channel scale grouping; compare int8 4x4 vs old packed path)
    ha = np.asarray(old(frames[:2]), np.int32)
    hb = np.asarray(v4(frames[:2]), np.int32)
    print("int8 hq agree frac:", float((ha == hb).mean()),
          "maxdiff:", int(np.abs(ha - hb).max()))
    hc = np.asarray(v4b(frames[:2]), np.int32)
    print("bf16 hq agree frac:", float((ha == hc).mean()),
          "maxdiff:", int(np.abs(ha - hc).max()))


if __name__ == "__main__":
    main()
