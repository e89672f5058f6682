"""Evaluate a PRODUCTION-trained RektNet checkpoint (cli.rektnet_train's
``.pt`` output) on held-out data, f32 and int8 PTQ.

Counterpart of tools/eval_weights.py for the keypoint family: the on-chip
convergence numbers so far (held-out L2 0.0355, train_to_map --family
rektnet) come from device-resident synthetic pools; this evaluates weights
the full production path produced (CSV ingest -> native decode -> resize ->
loader -> train loop, RektNet/train_eval.py:45-186 semantics).

Two views:
- fresh-crops: N unseen cone_crop()s at 80x80 — normalized keypoint L2,
  directly comparable to the pool-run metric (PERF.md "Training" section);
- disk-val: the dataset's chronological val split through ConeDataset
  (production decode/resize path), same normalized L2.

Usage:
    python tools/eval_rektnet_weights.py --pt outputs/.../<E>_loss_*.pt \
        [--csv /root/dataset_rektnet/rektnet_label.csv \
         --images /root/dataset_rektnet/images --ratio 0.1335] [--n 512]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from mit_driverless_cv_traininginfra.models import rektnet  # noqa: E402
from mit_driverless_cv_traininginfra.models.quantize import (  # noqa: E402
    apply_rektnet_int8,
    calibrate_rektnet,
    quantize_rektnet_params,
)


def _l2(folded, q, imgs_np, pts_np, batch: int = 256):
    """Mean normalized keypoint L2 (f32 and int8) over a numpy crop set."""
    d32, d8, n = 0.0, 0.0, 0
    for i in range(0, len(imgs_np), batch):
        x = jnp.asarray(imgs_np[i:i + batch])
        t = pts_np[i:i + batch]
        _, p32 = rektnet.apply_folded(folded, x)
        _, p8 = apply_rektnet_int8(q, x)
        d32 += float(np.linalg.norm(np.asarray(p32, np.float32) - t,
                                    axis=-1).sum())
        d8 += float(np.linalg.norm(np.asarray(p8, np.float32) - t,
                                   axis=-1).sum())
        n += t.shape[0] * t.shape[1]
    return d32 / n, d8 / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pt", required=True, help=".pt checkpoint from "
                    "cli.rektnet_train (or a reference-format one)")
    ap.add_argument("--csv", default=None, help="rektnet_label.csv for the "
                    "disk-val view (optional)")
    ap.add_argument("--images", default=None)
    ap.add_argument("--ratio", type=float, default=0.15)
    ap.add_argument("--n", type=int, default=512, help="fresh held-out crops")
    ap.add_argument("--seed", type=int, default=424242)
    args = ap.parse_args(argv)

    params, state = rektnet.load_torch_checkpoint(args.pt)
    folded = rektnet.fold_bn(params, state)

    from mit_driverless_cv_traininginfra.data.synthetic import rektnet_batch

    t0 = time.perf_counter()
    # calibration on train-distribution crops (same recipe as train_to_map)
    cal_i, _ = rektnet_batch(np.random.default_rng(7), 64)
    q = quantize_rektnet_params(folded, calibrate_rektnet(folded, jnp.asarray(cal_i)))

    ev_i, ev_p = rektnet_batch(np.random.default_rng(args.seed), args.n)
    l2_32, l2_8 = _l2(folded, q, ev_i, ev_p)

    out = {
        "metric": "rektnet_production_weights_l2_80",
        "pt": args.pt,
        "fresh_crops": args.n,
        "l2_f32": round(l2_32, 4),
        "l2_int8": round(l2_8, 4),
        "int8_delta": round(l2_8 - l2_32, 4),
    }

    if args.csv:
        from mit_driverless_cv_traininginfra.data.rektnet_data import (
            ConeDataset,
            RektNetLoader,
            load_train_csv_dataset,
        )

        _, _, vi, vl = load_train_csv_dataset(
            args.csv, validation_percent=args.ratio,
            dataset_path=args.images or "")
        loader = RektNetLoader(
            ConeDataset(vi, vl, args.images or "", (80, 80),
                        compute_heatmaps=False), 256)
        imgs, pts = [], []
        for im, _, p, _, _ in loader:
            imgs.append(im)
            pts.append(p)
        v32, v8 = _l2(folded, q, np.concatenate(imgs), np.concatenate(pts))
        out["disk_val_crops"] = int(sum(len(p) for p in pts))
        out["disk_val_l2_f32"] = round(v32, 4)
        out["disk_val_l2_int8"] = round(v8, 4)

    out["eval_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
