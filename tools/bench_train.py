"""Training-throughput benchmark (VERDICT r2 #1): steady-state train-step
ms, imgs/sec/GPU, and achieved TFLOP/s for both model families.

The reference's counterpart hot loop is CVC-YOLOv3/train.py:49-93 (torch
forward/backward + per-step .item() syncs) and RektNet/train_eval.py:52-85;
it publishes no training-throughput numbers. Here each configuration runs
the real jitted DP train step (train/steps.py) on one GPU:

- YOLO-416 (flagship spec): B in {32, 64, 128}, f32 and bf16 compute,
  plus the device-aug step (photometric on-device augmentation fused in
  front of the model) at each batch size in bf16.
- RektNet 80x80: B in {64, 256}, f32 and bf16.

Every timing chains >=32 steps (the donated TrainState serialises them)
and waits for the last with jax.block_until_ready.

FLOP accounting: analytic conv MACs (utils/profiling.conv_graph_flops /
rektnet_flops, pinned to darknet's published 65.86 GF in the test suite),
with backward = 2x forward (grad-input + grad-weight convs), i.e.
train-step FLOPs = 3x forward. BN/loss/optimizer FLOPs are ignored
(sub-1% at these shapes).

Usage: python tools/bench_train.py [--quick] [--iters N] [--json PATH]
"""

import argparse
import json
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


def _bench_chain(step_once, ts0, iters, warmup=3):
    """Run `warmup` steps (compile + settle), then `iters` chained steps.
    Returns per-step ms. step_once(ts) -> (ts, an output to wait on)."""
    ts = ts0
    for _ in range(warmup):
        ts, out = step_once(ts)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, out = step_once(ts)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1000.0 / iters


def bench_yolo(spec, batches, iters, dtypes=("float32", "bfloat16"),
               device_aug=True, packed_stem=False):
    from mit_driverless_cv_traininginfra.models.darknet import init_params
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
        yolo_train_step_device_aug,
    )
    from mit_driverless_cv_traininginfra.utils.profiling import (
        conv_graph_flops,
    )

    fwd_gf = conv_graph_flops(spec) / 1e9
    step_gf = 3.0 * fwd_gf  # fwd + grad-input + grad-weight
    tx = make_optimizer("Adam", lr=1e-4)
    rng = np.random.default_rng(0)
    results = []
    size = spec.net.height
    for B in batches:
        images = jnp.asarray(rng.uniform(0, 1, (B, size, size, 3)),
                             jnp.float32)
        targets = np.zeros((B, 8, 5), np.float32)
        targets[:, :3, 1:] = rng.uniform(0.2, 0.8, (B, 3, 4)) * [1, 1, .2, .2]
        targets = jnp.asarray(targets)
        labels_px = np.zeros((B, 8, 5), np.float32)
        labels_px[:, :3] = [0, 40, 40, 120, 140]
        labels_px = jnp.asarray(labels_px)
        key = jax.random.PRNGKey(0)

        for dt in dtypes:
            name = f"yolo{size} B={B} {dt}" + (
                "+packed_stem" if packed_stem else "")
            try:
                params, state = init_params(spec, jax.random.PRNGKey(0))
                ts = init_train_state(params, state, tx)

                def once(ts):
                    ts, loss, _ = yolo_train_step(
                        spec, tx, ts, images, targets, compute_dtype=dt,
                        packed_stem=packed_stem)
                    return ts, loss

                ms = _bench_chain(once, ts, iters)
                r = {"config": name, "step_ms": round(ms, 2),
                     "imgs_per_sec": round(B * 1000 / ms, 1),
                     "tflops": round(step_gf * B / ms, 1)}
                results.append(r)
                print(json.dumps(r), file=sys.stderr)
            except Exception as e:
                results.append({"config": name, "error": str(e)[:200]})
                print(f"{name}: FAILED {e}", file=sys.stderr)

        if device_aug:
            name = f"yolo{size} B={B} bfloat16+device_aug"
            try:
                params, state = init_params(spec, jax.random.PRNGKey(0))
                ts = init_train_state(params, state, tx)

                def once_aug(ts):
                    ts, loss, _ = yolo_train_step_device_aug(
                        spec, tx, ts, images, labels_px, key,
                        compute_dtype="bfloat16")
                    return ts, loss

                ms = _bench_chain(once_aug, ts, iters)
                r = {"config": name, "step_ms": round(ms, 2),
                     "imgs_per_sec": round(B * 1000 / ms, 1),
                     "tflops": round(step_gf * B / ms, 1)}
                results.append(r)
                print(json.dumps(r), file=sys.stderr)
            except Exception as e:
                results.append({"config": name, "error": str(e)[:200]})
                print(f"{name}: FAILED {e}", file=sys.stderr)
    return results


def bench_rektnet(batches, iters, dtypes=("float32", "bfloat16")):
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        rektnet_train_step,
    )
    from mit_driverless_cv_traininginfra.utils.profiling import (
        rektnet_flops,
    )

    fwd_gf = rektnet_flops() / 1e9
    step_gf = 3.0 * fwd_gf
    tx = make_optimizer("Adam", lr=1e-3)
    rng = np.random.default_rng(1)
    results = []
    dummy_hm = jnp.zeros((1,), jnp.float32)
    for B in batches:
        crops = jnp.asarray(rng.uniform(0, 1, (B, 80, 80, 3)), jnp.float32)
        points = jnp.asarray(rng.uniform(0.1, 0.9, (B, 7, 2)), jnp.float32)
        for dt in dtypes:
            name = f"rektnet80 B={B} {dt}"
            try:
                rp, rs = rektnet.init(jax.random.PRNGKey(1))
                ts = init_train_state(rp, rs, tx)

                def once(ts):
                    ts, total, _, _ = rektnet_train_step(
                        tx, ts, crops, dummy_hm, points,
                        loss_type="l1_softargmax", include_geo=True,
                        geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05,
                        compute_dtype=dt, synth_target_sigma=1.0)
                    return ts, total

                ms = _bench_chain(once, ts, iters)
                r = {"config": name, "step_ms": round(ms, 2),
                     "imgs_per_sec": round(B * 1000 / ms, 1),
                     "tflops": round(step_gf * B / ms, 1)}
                results.append(r)
                print(json.dumps(r), file=sys.stderr)
            except Exception as e:
                results.append({"config": name, "error": str(e)[:200]})
                print(f"{name}: FAILED {e}", file=sys.stderr)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny spec + few iters (CPU smoke)")
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--yolo-batches", default=None,
                    help="comma list, default 32,64,128")
    ap.add_argument("--rekt-batches", default=None,
                    help="comma list, default 64,256")
    ap.add_argument("--packed-stem", action="store_true",
                    help="train blocks 0-1 through the exact space-to-"
                         "depth rewrite (darknet._packed_stem_train)")
    ap.add_argument("--no-rekt", action="store_true",
                    help="skip the RektNet half (A/B the YOLO flag fast)")
    args = ap.parse_args()

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )

    dev = jax.devices()[0]
    print(f"bench_train on {dev.platform}", file=sys.stderr)
    if args.quick:
        spec = load_network_spec(
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "tests", "fixtures",
                "tiny_test.cfg"), vanilla_anchor=True)
        yolo_b = [2]
        rekt_b = [4]
        iters = 4
    else:
        spec = flagship_spec(416)
        yolo_b = [32, 64, 128]
        rekt_b = [64, 256]
        iters = args.iters
    if args.yolo_batches:
        yolo_b = [int(x) for x in args.yolo_batches.split(",")]
    if args.rekt_batches:
        rekt_b = [int(x) for x in args.rekt_batches.split(",")]

    out = {"platform": dev.platform, "iters": iters,
           "yolo": bench_yolo(spec, yolo_b, iters,
                              packed_stem=args.packed_stem),
           "rektnet": ([] if args.no_rekt
                       else bench_rektnet(rekt_b, iters))}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
