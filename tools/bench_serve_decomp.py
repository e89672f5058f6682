"""Decompose TwoStageServer overhead vs the raw fused-pipeline loop.

Separates what the serving wrapper costs from the pipeline itself,
steady-state and on the GPU:

  raw         — the bare jitted pipeline loop
  serve-defer — TwoStageServer defaults (deferred observation, every 8)
  serve-fence — immediate observation every 8 calls (waits for the batch)
  serve-rare  — observe_every=64
  serve-off   — observation effectively off after the first call

Each mode warms 5 untimed calls first, then times N calls up to
jax.block_until_ready of the last, and prints per-8-call window wall
times so outliers are visible.

Usage: python tools/bench_serve_decomp.py [--iters 64] [--batch 128]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (enables the persistent compile cache)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402



def build_setup(batch):
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import (
        rektnet_batch,
        yolo_batch,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate,
        calibrate_rektnet,
        quantize_packed_stem,
        quantize_params,
        quantize_rektnet_params,
    )
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        build_packed_stem,
        slice_preyolo,
        stem_is_packable,
    )
    from mit_driverless_cv_traininginfra.ops.entry import (
        entry_block_applicable,
        quantize_entry,
    )

    spec = flagship_spec(416)
    params, state, rp, rs = bench._train_synthetic(spec)
    folded = fold_bn(params, state, spec)
    spec, folded = slice_preyolo(spec, folded)
    packed = build_packed_stem(folded) if stem_is_packable(spec) else None
    rp = rektnet.fold_bn(rp, rs)

    rng = np.random.default_rng(42)
    frames_np, _ = yolo_batch(rng, batch, size=416)
    frames = jnp.asarray(frames_np, jnp.bfloat16)

    cal = jnp.asarray(frames_np[:8], jnp.float32)
    amax = calibrate(spec, folded, cal)
    yolo_q = quantize_params(spec, folded, amax)
    stem_q = quantize_packed_stem(packed, amax) if packed is not None else None
    crops_cal, _ = rektnet_batch(np.random.default_rng(3), 32)
    rekt_q = quantize_rektnet_params(
        rp, calibrate_rektnet(rp, jnp.asarray(crops_cal)))
    entry_q = (quantize_entry(folded, amax)
               if entry_block_applicable(spec) else None)
    return spec, yolo_q, stem_q, rekt_q, entry_q, frames


def timed_loop(fn, frames, iters, warm=5):
    out = None
    for _ in range(warm):
        out = fn(frames)
    jax.block_until_ready(out)
    windows = []
    t0 = time.perf_counter()
    tw = t0
    for i in range(iters):
        out = fn(frames)
        if (i + 1) % 8 == 0:
            now = time.perf_counter()
            windows.append((now - tw) * 1000)
            tw = now
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return dt, windows


def main():
    batch = int(sys.argv[sys.argv.index("--batch") + 1]) \
        if "--batch" in sys.argv else 128
    iters = int(sys.argv[sys.argv.index("--iters") + 1]) \
        if "--iters" in sys.argv else 64

    from mit_driverless_cv_traininginfra.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline_int8,
    )
    from mit_driverless_cv_traininginfra.infer.serving import (
        TwoStageServer,
    )

    spec, yolo_q, stem_q, rekt_q, entry_q, frames = build_setup(batch)
    cap = 416
    conf = 0.8

    def raw(f):
        return two_stage_pipeline_int8(
            spec, yolo_q, stem_q, rekt_q, f, conf_thresh=conf,
            nms_thresh=0.25, max_det=16, crop_capacity=cap,
            entry_q=entry_q)

    def make_server(observe_every, defer=False):
        s = TwoStageServer(
            spec, yolo_q=yolo_q, stem_q=stem_q, rekt_q=rekt_q,
            entry_q=entry_q, conf_thresh=conf, nms_thresh=0.25, max_det=16,
            policy=AdaptiveCapacity(floor=min(256, cap), margin=1.1,
                                    quantum=32, warmup_capacity=cap),
            observe_every=observe_every, defer_observation=defer)
        t = time.perf_counter()
        s.warmup([batch], capacities=[cap])
        print(f"  warmup {time.perf_counter() - t:.1f}s", file=sys.stderr)
        return s

    results = {}
    dt, win = timed_loop(raw, frames, iters)
    results["raw"] = (batch * iters / dt, win)

    for name, kw in [
        ("serve-defer", dict(observe_every=8, defer=True)),
        ("serve-fence", dict(observe_every=8)),
        ("serve-rare", dict(observe_every=64)),
        ("serve-off", dict(observe_every=10 ** 9)),
    ]:
        srv = make_server(**kw)
        dt, win = timed_loop(srv, frames, iters)
        results[name] = (batch * iters / dt, win)
        st = srv.stats()
        print(f"  {name}: compiles={st['compiles']} "
              f"clamps={st['bucket_clamps']} "
              f"lat={st['latency_batch_ms']}", file=sys.stderr)

    for name, (fps, win) in results.items():
        w = " ".join(f"{x:.0f}" for x in win)
        print(f"{name:11s} {fps:8.1f} fps   windows(ms): {w}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
