"""Deployment-latency study: steady-state device time per frame at small
batch (B=1 single camera, B=2/4 camera micro-batching), max_det=8, crop
capacity 8/frame — the racing operating point. Each timing runs a chain
of calls and waits for the last with jax.block_until_ready."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from mit_driverless_cv_traininginfra.utils.jaxcache import (
    enable_compile_cache,
)

enable_compile_cache()

import jax.numpy as jnp
import numpy as np


def main():
    import bench as bench_mod
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import (
        rektnet_batch, yolo_batch,
    )
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline_int8,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate, calibrate_rektnet, quantize_packed_stem, quantize_params,
        quantize_rektnet_params,
    )
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        build_packed_stem, slice_preyolo,
    )
    from mit_driverless_cv_traininginfra.ops.entry import (
        entry_block_applicable, quantize_entry,
    )

    spec = flagship_spec(416)
    params, state, rp, rs = bench_mod._train_synthetic(spec)
    folded = fold_bn(params, state, spec)
    spec, folded = slice_preyolo(spec, folded)
    packed = build_packed_stem(folded)
    rng = np.random.default_rng(42)
    frames_np, _ = yolo_batch(rng, 8, size=416)
    cal = jnp.asarray(frames_np, jnp.float32)
    amax = calibrate(spec, folded, cal)
    yolo_q = quantize_params(spec, folded, amax)
    stem_q = quantize_packed_stem(packed, amax)
    entry_q = (quantize_entry(folded, amax)
               if entry_block_applicable(spec) else None)
    rpf = rektnet.fold_bn(rp, rs)
    crops_cal, _ = rektnet_batch(np.random.default_rng(3), 32)
    rekt_q = quantize_rektnet_params(
        rpf, calibrate_rektnet(rpf, jnp.asarray(crops_cal)))

    max_det = 8
    dev = jax.devices()[0]
    print(f"platform={dev.platform} max_det={max_det}")

    for B in (1, 2, 4, 8):
        frames = jax.device_put(jnp.asarray(frames_np[:B], jnp.bfloat16),
                                dev)
        cap = 8 * B

        def run(f=frames, cap=cap):
            return two_stage_pipeline_int8(
                spec, yolo_q, stem_q, rekt_q, f,
                conf_thresh=0.8, nms_thresh=0.25, max_det=max_det,
                crop_capacity=cap, entry_q=entry_q)

        o = run()
        float(jnp.sum(o.keypoints))
        lats = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(64):
                o = run()
            float(jnp.sum(o.keypoints) + jnp.sum(o.scores))
            lats.append((time.perf_counter() - t0) * 1000 / 64)
        p50 = sorted(lats)[len(lats) // 2]
        print(f"B={B}: batch {p50:6.2f} ms  per-frame {p50 / B:6.2f} ms  "
              f"(crop cap {cap})")


if __name__ == "__main__":
    main()
