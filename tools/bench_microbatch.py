"""MicroBatcher under a camera-stream arrival process, on chip.

Simulates the racing deployment's request pattern — two near-synchronous
camera streams — against the int8 flagship TwoStageServer wrapped in
MicroBatcher, and reports sustained throughput, the realised batch-size
histogram, and request latency (the device-time floor per batch size is
tools/bench_latency.py's).

Usage: python tools/bench_microbatch.py [--fps 100] [--seconds 4]
"""

import argparse
import json
import os
import sys
import threading
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--fps", type=float, default=100.0, help="per camera")
    ap.add_argument("--cameras", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    args = ap.parse_args()

    import bench as bench_mod
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra.infer.microbatch import (
        MicroBatcher,
    )
    from mit_driverless_cv_traininginfra.infer.serving import (
        TwoStageServer,
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
    )
    from mit_driverless_cv_traininginfra.ops.entry import (
        entry_block_applicable,
        quantize_entry,
    )

    spec = flagship_spec(416)
    params, state, rp, rs = bench_mod._train_synthetic(spec)
    folded = fold_bn(params, state, spec)
    spec, folded = slice_preyolo(spec, folded)
    packed = build_packed_stem(folded)
    rng = np.random.default_rng(42)
    frames_np, _ = yolo_batch(rng, 8, size=416)
    amax = calibrate(spec, folded, jnp.asarray(frames_np, jnp.float32))
    yolo_q = quantize_params(spec, folded, amax)
    stem_q = quantize_packed_stem(packed, amax)
    entry_q = (quantize_entry(folded, amax)
               if entry_block_applicable(spec) else None)
    rpf = rektnet.fold_bn(rp, rs)
    from mit_driverless_cv_traininginfra.data.synthetic import (
        rektnet_batch,
    )

    rekt_q = quantize_rektnet_params(
        rpf, calibrate_rektnet(
            rpf, jnp.asarray(rektnet_batch(np.random.default_rng(3), 32)[0])))

    buckets = (1, 2, 4, 8)
    server = TwoStageServer.from_params(
        spec, yolo_q, stem_q, rekt_q, entry_q=entry_q, conf_thresh=0.8,
        max_det=8, policy=AdaptiveCapacity(floor=64, quantum=64,
                                           warmup_capacity=64))
    print("warming buckets...", file=sys.stderr)
    server.warmup(buckets, capacities=[64])

    frames = [np.asarray(f, np.float32) for f in frames_np[:args.cameras]]

    # --- baseline: strictly sequential single-frame serving --------------
    f0 = jnp.asarray(frames[0][None], jnp.bfloat16)
    out = server(f0)
    float(jnp.sum(out.scores))
    t0 = time.perf_counter()
    n_seq = 64
    for _ in range(n_seq):
        out = server(f0)
        jax.block_until_ready(out)  # per-request wait = request latency
    seq_ms = (time.perf_counter() - t0) * 1000 / n_seq

    # --- arrival process through the MicroBatcher -------------------------
    lat_lock = threading.Lock()
    lats = []

    def camera(cam_id, mb, stop_t):
        period = 1.0 / args.fps
        nxt = time.perf_counter()
        while time.perf_counter() < stop_t:
            t_sub = time.perf_counter()
            fut = mb.submit(frames[cam_id])
            fut.result(timeout=60)
            with lat_lock:
                lats.append((time.perf_counter() - t_sub) * 1000)
            nxt += period
            sleep = nxt - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
            else:
                nxt = time.perf_counter()  # fell behind: don't burst

    def run_batch(batch):
        return server(jnp.asarray(batch, jnp.bfloat16))

    mb = MicroBatcher(run_batch, bucket_sizes=buckets,
                      max_wait_ms=args.max_wait_ms)
    with mb:
        stop_t = time.perf_counter() + args.seconds
        t0 = time.perf_counter()
        threads = [threading.Thread(target=camera, args=(i, mb, stop_t))
                   for i in range(args.cameras)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        st = mb.stats()

    lats_np = np.asarray(lats)
    print(json.dumps({
        "metric": "microbatch_camera_streams",
        "cameras": args.cameras, "per_camera_fps_target": args.fps,
        "sequential_b1_request_ms": round(seq_ms, 2),
        "achieved_fps": round(len(lats) / wall, 1),
        "request_ms_p50": round(float(np.percentile(lats_np, 50)), 2),
        "request_ms_p99": round(float(np.percentile(lats_np, 99)), 2),
        "mean_batch": st["mean_batch"],
        "bucket_histogram": st["bucket_histogram"],
        "padded_frames": st["padded_frames"],
        "server_stats": {k: v for k, v in server.stats().items()
                         if k != "warmed_buckets"},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
