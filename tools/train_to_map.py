"""Flagship-scale convergence demonstration: train the FULL YOLOv3-416
graph on synthetic cone scenes on one chip and report mAP at the
reference operating point, with wall-clock.

The CPU suite certifies convergence + int8 deltas on the tiny fixture
graph (tests/test_quantize_accuracy.py); this tool is the full-size
counterpart on real hardware: Darknet-53 + FPN at 416², bf16 mixed
precision (the r3 training default), device-resident sample pool (the
1-core host cannot feed the chip — PERF.md "Host input pipeline"),
hold-then-cosine schedule. Reports mAP/R/P at conf 0.8 / NMS 0.25 /
IoU 0.5 (validate.py:61-182 semantics) for f32-serving and int8-PTQ
weights, plus imgs/sec and total wall-clock.

Usage: python tools/train_to_map.py [--steps 3000] [--batch 32]
       python tools/train_to_map.py --family rektnet [--steps 1500]
Prints one JSON line (per family).
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
import optax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--hold", type=float, default=0.67)
    ap.add_argument("--pool", type=int, default=128)
    ap.add_argument("--eval-n", type=int, default=64)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--family", default="yolo", choices=["yolo", "rektnet"])
    ap.add_argument("--min-h", type=int, default=18,
                    help="scene cone height range (default = the bench "
                         "distribution; raise max-h toward the input size "
                         "to train a detector that emits crop-window-"
                         "violating boxes for the auto-degrade demo)")
    ap.add_argument("--max-h", type=int, default=120)
    ap.add_argument("--save-weights", type=str, default="",
                    help="also export the trained params as a Darknet "
                         ".weights file (serving/deployment input)")
    args = ap.parse_args()
    if args.family == "rektnet":
        return rektnet_main(args)

    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.models.darknet import (
        detections,
        fold_bn,
        init_params,
    )
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate,
        detections_int8,
        quantize_params,
    )
    from mit_driverless_cv_traininginfra.ops.metrics import (
        evaluate_image_batch,
        summarize,
    )
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
    )

    scenes = dict(max_cones=8, min_h=args.min_h, max_h=args.max_h,
                  max_overlap=0.1)
    spec = flagship_spec(args.size)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    pool_i, pool_t = yolo_batch(rng, args.pool, size=args.size, **scenes)
    pool_i = jnp.asarray(pool_i, jnp.float32)   # device-resident pool
    pool_t = jnp.asarray(pool_t)
    t_render = time.perf_counter() - t0

    params, state = init_params(spec, jax.random.PRNGKey(0))
    hold = int(args.steps * args.hold)
    warm = min(200, hold // 2)
    # warmup -> hold -> cosine + global-norm clip: the 62M-param graph from
    # scratch NaNs without both at B=32 (measured; the noobj-25 BCE spikes
    # early). bench.py's B=8 recipe needs neither.
    lr_fn = optax.join_schedules(
        [optax.linear_schedule(0.0, args.lr, warm),
         optax.constant_schedule(args.lr),
         optax.cosine_decay_schedule(args.lr, args.steps - hold)],
        [warm, hold])
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr_fn))
    ts = init_train_state(params, state, tx)

    # warmup step OUTSIDE the clock: the cold jit compile would otherwise
    # count against the reported imgs/sec
    ts, w_loss, _ = yolo_train_step(spec, tx, ts, pool_i[:args.batch],
                                    pool_t[:args.batch],
                                    compute_dtype="bfloat16")
    jax.block_until_ready(w_loss)

    t0 = time.perf_counter()
    loss = None
    for step in range(args.steps):
        idx = rng.integers(0, args.pool, args.batch)
        ts, loss, _ = yolo_train_step(spec, tx, ts, pool_i[idx], pool_t[idx],
                                      compute_dtype="bfloat16")
        if step % 250 == 0:
            lv = float(loss)
            print(f"step {step}: loss {lv:.3f} "
                  f"({time.perf_counter()-t0:.0f}s)", file=sys.stderr)
            if not np.isfinite(lv):
                print("training diverged (NaN) — aborting", file=sys.stderr)
                return 1
    final_loss = float(loss)  # waits for the chain
    t_train = time.perf_counter() - t0

    # held-out eval at the reference operating point (chunked: a B=64
    # f32 eval forward at 416² on top of the training state OOMs the chip)
    folded = fold_bn(ts.params, ts.model_state, spec)
    cal = jnp.asarray(np.asarray(pool_i[:8]))
    amax = calibrate(spec, folded, cal)
    q = quantize_params(spec, folded, amax)
    if args.save_weights:
        from mit_driverless_cv_traininginfra.models.darknet import (
            save_darknet_weights,
        )

        save_darknet_weights(spec, ts.params, ts.model_state,
                             args.save_weights)
        print(f"weights -> {args.save_weights}", file=sys.stderr)
    del pool_i, pool_t, ts  # free HBM before the eval forwards

    ev_i, ev_t = yolo_batch(np.random.default_rng(999), args.eval_n,
                            size=args.size, **scenes)
    CH = 16
    evs32, evs8 = [], []
    for c0 in range(0, args.eval_n, CH):
        ci = jnp.asarray(ev_i[c0:c0 + CH])
        ct = jnp.asarray(ev_t[c0:c0 + CH])
        dets = detections(spec, folded, {}, ci, with_classes=False)
        evs32.append(evaluate_image_batch(
            dets, ct, args.size, args.size, conf_thresh=0.8,
            nms_thresh=0.25, iou_thresh=0.5, top_k=32))
        dets8 = detections_int8(spec, q, ci, with_classes=False)
        evs8.append(evaluate_image_batch(
            dets8, ct, args.size, args.size, conf_thresh=0.8,
            nms_thresh=0.25, iou_thresh=0.5, top_k=32))

    def _cat(evs):
        import numpy as _np
        from mit_driverless_cv_traininginfra.ops.metrics import ImageEval
        return ImageEval(*[_np.concatenate([_np.asarray(getattr(e, f))
                                            for e in evs])
                           for f in ImageEval._fields])

    ev32, ev8 = _cat(evs32), _cat(evs8)
    map32, r32, p32 = summarize(ev32)
    map8, r8, p8 = summarize(ev8)

    print(json.dumps({
        "metric": "flagship_train_to_map_416",
        "steps": args.steps, "batch": args.batch,
        "imgs_seen": args.steps * args.batch,
        "final_loss": round(final_loss, 3),
        "train_s": round(t_train, 1),
        "render_s": round(t_render, 1),
        "imgs_per_sec": round(args.steps * args.batch / t_train, 1),
        "eval_n": args.eval_n,
        "map_f32_conf08": round(map32, 4),
        "recall_f32": round(r32, 4), "precision_f32": round(p32, 4),
        "map_int8_conf08": round(map8, 4),
        "int8_map_delta": round(map32 - map8, 4),
        "valid_images": int(np.asarray(ev32.valid).sum()),
    }))
    return 0


def rektnet_main(args):
    """RektNet counterpart: train on synthetic cone crops on chip, report
    held-out keypoint-L2 (f32 and int8) with wall-clock."""
    from mit_driverless_cv_traininginfra.data.synthetic import (
        rektnet_batch,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.quantize import (
        apply_rektnet_int8,
        calibrate_rektnet,
        quantize_rektnet_params,
    )
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        rektnet_train_step,
    )

    steps = args.steps if args.steps != 3000 else 1500
    batch = args.batch if args.batch != 32 else 256
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    pool_i, pool_p = rektnet_batch(rng, 2048)
    pool_i, pool_p = jnp.asarray(pool_i), jnp.asarray(pool_p)
    t_render = time.perf_counter() - t0

    params, state = rektnet.init(jax.random.PRNGKey(1))
    lr_fn = optax.join_schedules(
        [optax.constant_schedule(3e-3),
         optax.cosine_decay_schedule(3e-3, steps // 3)], [2 * steps // 3])
    tx = optax.adam(lr_fn)
    ts = init_train_state(params, state, tx)
    dummy = jnp.zeros((1,), jnp.float32)

    # warmup step outside the clock (same compile-leak rationale as yolo)
    ts, w_total, _, _ = rektnet_train_step(
        tx, ts, pool_i[:batch], dummy, pool_p[:batch],
        loss_type="l1_softargmax", include_geo=True,
        geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05,
        compute_dtype="bfloat16", synth_target_sigma=1.0)
    jax.block_until_ready(w_total)

    t0 = time.perf_counter()
    total = None
    for step in range(steps):
        idx = rng.integers(0, pool_i.shape[0], batch)
        ts, total, _, _ = rektnet_train_step(
            tx, ts, pool_i[idx], dummy, pool_p[idx],
            loss_type="l1_softargmax", include_geo=True,
            geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05,
            compute_dtype="bfloat16", synth_target_sigma=1.0)
        if step % 250 == 0:
            print(f"step {step}: loss {float(total):.4f} "
                  f"({time.perf_counter()-t0:.0f}s)", file=sys.stderr)
    final_loss = float(total)
    t_train = time.perf_counter() - t0

    ev_i, ev_p = rektnet_batch(np.random.default_rng(999), 256)
    ev_i, ev_p = jnp.asarray(ev_i), np.asarray(ev_p)
    folded = rektnet.fold_bn(ts.params, ts.model_state)
    _, pts32 = rektnet.apply_folded(folded, ev_i)
    l2_32 = float(np.linalg.norm(np.asarray(pts32, np.float32) - ev_p,
                                 axis=-1).mean())
    q = quantize_rektnet_params(
        folded, calibrate_rektnet(folded, pool_i[:64]))
    _, pts8 = apply_rektnet_int8(q, ev_i)
    l2_8 = float(np.linalg.norm(np.asarray(pts8, np.float32) - ev_p,
                                axis=-1).mean())

    print(json.dumps({
        "metric": "rektnet_train_to_l2_80",
        "steps": steps, "batch": batch,
        "imgs_seen": steps * batch,
        "final_loss": round(final_loss, 4),
        "train_s": round(t_train, 1),
        "render_s": round(t_render, 1),
        "imgs_per_sec": round(steps * batch / t_train, 1),
        "eval_n": 256,
        "kpt_l2_f32": round(l2_32, 5),
        "kpt_l2_f32_px80": round(l2_32 * 80, 2),
        "kpt_l2_int8": round(l2_8, 5),
        "int8_l2_delta": round(l2_8 - l2_32, 5),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
