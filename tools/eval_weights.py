"""Evaluate a trained Darknet `.weights` file on freshly rendered full
416² cone scenes (f32 and int8) at the bench operating point (conf 0.8 /
NMS 0.25 / IoU 0.5) — the same harness `tools/train_to_map.py` certifies
convergence with.

Companion to the production-training run (PERF.md "Production training
path on chip"): the production trainer VALIDATES through the reference's
tile-and-scale patch evaluator (`train/yolo_driver.py:validate_map`),
where patch-boundary-clipped cones cap the score — the detector fires on
a half-cone at the patch edge whose GT was filtered out (the reference's
own published 89.35 mAP, README.md:43-47, is measured through the same
patch evaluator). This tool answers the complementary question: on whole
scenes with no boundary clipping, what did the weights actually learn?

Usage: python tools/eval_weights.py --weights out/160.weights [--n 256]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--max-overlap", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--json", type=str, default="")
    args = ap.parse_args(argv)

    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.models.darknet import (
        detections,
        fold_bn,
        init_params,
        load_darknet_weights,
    )
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate,
        detections_int8,
        quantize_params,
    )
    from mit_driverless_cv_traininginfra.ops.metrics import (
        evaluate_image_batch,
    )

    spec = flagship_spec(args.size)
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    params, mstate, _ = load_darknet_weights(spec, params, mstate,
                                             args.weights)
    folded = fold_bn(params, mstate, spec)

    scenes = dict(max_overlap=(None if args.max_overlap < 0
                               else args.max_overlap))
    ev_i, ev_t = yolo_batch(np.random.default_rng(args.seed), args.n,
                            size=args.size, **scenes)
    amax = calibrate(spec, folded, jnp.asarray(ev_i[:8]))
    q = quantize_params(spec, folded, amax)

    CH = 16
    evs32, evs8 = [], []
    t0 = time.perf_counter()
    for c0 in range(0, args.n, CH):
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

    def agg(evs):
        ap_ = np.concatenate([np.asarray(e.ap) for e in evs])
        r = np.concatenate([np.asarray(e.recall) for e in evs])
        p = np.concatenate([np.asarray(e.precision) for e in evs])
        v = np.concatenate([np.asarray(e.valid) for e in evs]).astype(bool)
        return (round(float(ap_[v].mean()), 4), round(float(r[v].mean()), 4),
                round(float(p[v].mean()), 4))

    m32, r32, p32 = agg(evs32)
    m8, r8, p8 = agg(evs8)
    out = {"weights": args.weights, "n_scenes": args.n, "size": args.size,
           "conf": 0.8, "map_f32": m32, "recall_f32": r32,
           "precision_f32": p32, "map_int8": m8, "recall_int8": r8,
           "precision_int8": p8,
           "eval_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
