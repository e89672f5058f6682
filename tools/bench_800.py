"""800x800 capability run (VERDICT r4 #7): the reference's flagship cfg
trains at 800 squared (model_cfg/yolo_baseline.cfg:2-4) while every on-chip
number so far is 416 squared. This measures, on the real chip, at 800²:

- the two-stage serving pipeline (detect -> NMS -> crop -> keypoints) in
  bf16 over a small batch sweep (tiling optima shift with resolution —
  Bx800x800 activations are 3.7x the 416 ones per image, so the best B is
  NOT 128 here);
- the detect-only forward (where the extra pixels actually go);
- one bf16 train step (fwd+bwd+adam) at the largest batch that fits HBM.

Every timing runs >=16 calls and waits for the last with
jax.block_until_ready. Weights are random-init (resolution changes the
GRAPH, not the weights; throughput is weight-independent).

Usage: python tools/bench_800.py [--iters 16] [--json PATH]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mit_driverless_cv_traininginfra.utils.jaxcache import (
    enable_compile_cache,
)

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def _sync(*xs):
    jax.block_until_ready(xs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--pipe-batches", type=str, default="8,16,32")
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--json", type=str, default="")
    args = ap.parse_args(argv)
    S = args.size

    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import (
        detections,
        fold_bn,
        init_params,
    )
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
    )
    from mit_driverless_cv_traininginfra.utils.profiling import (
        conv_graph_flops,
    )

    spec = flagship_spec(S)
    out = {"size": S, "backend": jax.default_backend()}

    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    bf = lambda t: jax.tree_util.tree_map(
        lambda v: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v, t)
    folded = bf(fold_bn(params, mstate, spec))
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    rfolded = bf(rektnet.fold_bn(rp, rs))
    fwd_gf = conv_graph_flops(spec) / 1e9  # per image at spec size

    # --- serving pipeline sweep (bf16, dense-crop capacity off => use a
    # fixed capacity like the production server: B*4 quantized to 32)
    rng = np.random.default_rng(0)
    pipe = {}
    for B in [int(b) for b in args.pipe_batches.split(",") if b]:
        imgs, _ = yolo_batch(rng, B, size=S)
        frames = jax.device_put(jnp.asarray(imgs, jnp.bfloat16))
        cap = max(32, ((B * 4 + 31) // 32) * 32)
        run = jax.jit(lambda f: two_stage_pipeline(
            spec, folded, {}, rfolded, {}, f,
            0.8, 0.25, 16, 80, None, cap, False, 0))
        try:
            o = run(frames)
            _sync(o.keypoints, o.scores)
            for _ in range(3):
                o = run(frames)
            _sync(o.scores)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                o = run(frames)
            _sync(o.scores)
            dt = time.perf_counter() - t0
            pipe[B] = {"ms_per_batch": round(dt / args.iters * 1e3, 2),
                       "fps": round(B * args.iters / dt, 1),
                       "crop_capacity": cap}
            print(f"pipeline B={B}: {pipe[B]}", file=sys.stderr)
        except Exception as e:  # OOM at this batch: record and move on
            pipe[B] = {"error": str(e).splitlines()[0][:120]}
            print(f"pipeline B={B}: FAILED {pipe[B]}", file=sys.stderr)
    out["pipeline_bf16"] = pipe
    ok = {b: v for b, v in pipe.items() if "fps" in v}
    if ok:
        best = max(ok, key=lambda b: ok[b]["fps"])
        out["pipeline_best"] = {"batch": best, **ok[best]}

    # --- detect-only forward at the best pipeline batch
    if ok:
        B = best
        imgs, _ = yolo_batch(rng, B, size=S)
        frames = jax.device_put(jnp.asarray(imgs, jnp.bfloat16))
        det = jax.jit(lambda f: detections(spec, folded, {}, f))
        d = det(frames)
        _sync(d)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            d = det(frames)
        _sync(d)
        dt = time.perf_counter() - t0
        tf = fwd_gf * B * args.iters / dt / 1e3
        out["detect_bf16"] = {
            "batch": B, "ms_per_batch": round(dt / args.iters * 1e3, 2),
            "fps": round(B * args.iters / dt, 1),
            "fwd_gflop_per_img": round(fwd_gf, 1),
            "achieved_tflops": round(tf, 1)}
        print(f"detect: {out['detect_bf16']}", file=sys.stderr)

    # --- one bf16 train step at the largest fitting batch
    tx = make_optimizer("Adam", lr=5e-4, grad_clip=10.0)
    for B in (args.train_batch, args.train_batch // 2, 4):
        imgs, tgts = yolo_batch(rng, B, size=S)
        di = jax.device_put(jnp.asarray(imgs, jnp.float32))
        dt_ = jax.device_put(jnp.asarray(tgts, jnp.float32))
        try:
            ts = init_train_state(params, mstate, tx)
            ts, loss, _ = yolo_train_step(spec, tx, ts, di, dt_,
                                          compute_dtype="bfloat16")
            _sync(loss)
            t0 = time.perf_counter()
            n = max(4, args.iters // 2)
            for _ in range(n):
                ts, loss, _ = yolo_train_step(spec, tx, ts, di, dt_,
                                              compute_dtype="bfloat16")
            _sync(loss)
            dt = time.perf_counter() - t0
            out["train_bf16"] = {
                "batch": B, "ms_per_step": round(dt / n * 1e3, 1),
                "imgs_per_sec": round(B * n / dt, 1),
                "achieved_tflops": round(3 * fwd_gf * B * n / dt / 1e3, 1)}
            print(f"train: {out['train_bf16']}", file=sys.stderr)
            break
        except Exception as e:
            print(f"train B={B} failed: {str(e).splitlines()[0][:120]}",
                  file=sys.stderr)
            out["train_bf16"] = {"error": str(e).splitlines()[0][:120]}

    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
