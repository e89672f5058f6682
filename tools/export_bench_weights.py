"""Materialize the bench's trained synthetic-cone weights as the legacy
deployment artifacts `cli.serve` consumes: a Darknet `.weights` file, a
RektNet `.pt` checkpoint, and the matching 416x416 cfg.

The bench trains/caches raw pytrees (bench.CKPT, outputs/bench/ in the
checkout);
the serving CLI — like the reference's deployment flow (train.py:214-217
saves .weights, train_eval.py:103-110 saves .pt) — loads the legacy
formats. This tool bridges them so the on-chip serving-runtime study runs
the production loader path end to end.

Usage: python tools/export_bench_weights.py [--out DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main() -> int:
    import bench

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.dirname(bench.CKPT))
    ap.add_argument("--ckpt",
                    default=bench.CKPT)
    opt = ap.parse_args()

    from mit_driverless_cv_traininginfra.config.cfg_factory import (
        yolov3_cfg,
    )
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import (
        init_params,
        save_darknet_weights,
    )
    from mit_driverless_cv_traininginfra.train.checkpoints import (
        save_rektnet_pt,
    )

    if not os.path.exists(opt.ckpt):
        print(f"ERROR: no bench checkpoint at {opt.ckpt} — run bench.py on "
              "the GPU first (it trains and caches the weights)",
              file=sys.stderr)
        return 1

    spec = flagship_spec(416)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    params, state, rp, rs = bench._load_trees(opt.ckpt,
                                              [params, state, rp, rs])

    os.makedirs(opt.out, exist_ok=True)
    wpath = os.path.join(opt.out, "yolo_bench.weights")
    save_darknet_weights(spec, params, state, wpath)
    ppath = os.path.join(opt.out, "rektnet_bench.pt")
    save_rektnet_pt(ppath, rp, rs)
    cpath = os.path.join(opt.out, "yolo_416.cfg")
    with open(cpath, "w") as f:
        f.write(yolov3_cfg(width=416, height=416, classes=80))
    sha = bench._tree_sha([params, state, rp, rs])
    print(f"weights_sha={sha}")
    print(f"yolo   -> {wpath} ({os.path.getsize(wpath) / 1e6:.1f} MB)")
    print(f"rekt   -> {ppath}")
    print(f"cfg    -> {cpath}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
