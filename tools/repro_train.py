"""Is the on-chip bench retrain deterministic? (VERDICT r3 weak #1 / #4)

Runs `bench._train_synthetic` twice back-to-back in ONE process with
identical seeds and a disabled weights cache, then compares:

- the content SHA of every weight tree (exact-equality check),
- the max-abs weight divergence if they differ,
- the downstream bench-relevant statistic: mean detections/frame at the
  conf-0.8 operating point on a fixed rendered frame set (this is what
  moved the r2->r3 headline: 2.65 -> 2.75 det/frame changed the crop
  capacity bucket).

Both runs share a process, so the persistent/jit compile caches are
identical for run 2 — any difference isolates hardware/runtime
nondeterminism, not compile-schedule drift. A third, cross-process data
point comes free from comparing against any existing bench ckpt
(different process, possibly different toolchain day).

Reference counterpart: none (the reference doesn't bench); this guards
our own BENCH_r{N} round-over-round comparability.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from mit_driverless_cv_traininginfra.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra.models.darknet import (
    detections,
    fold_bn,
)


def _mean_det(spec, params, state, frames) -> float:
    folded = fold_bn(params, state, spec)
    dets = detections(spec, folded, {}, frames, with_classes=False)
    conf = np.asarray(dets[..., 4], np.float32)
    return float((conf > 0.8).sum(axis=1).mean())


def main():
    # _train_synthetic saves its result to bench.CKPT at the end; point it
    # somewhere disposable and delete it BEFORE each run, or run 2 would
    # just load run 1's save and report a vacuous "deterministic".
    bench.CKPT = "/tmp/repro_train_ckpt.npz"
    spec = flagship_spec(416)

    rng = np.random.default_rng(7)
    frames_np, _ = __import__(
        "mit_driverless_cv_traininginfra.data.synthetic",
        fromlist=["yolo_batch"]).yolo_batch(rng, 32, size=spec.net.height)
    frames = jnp.asarray(frames_np)

    runs = []
    for i in range(2):
        if os.path.exists(bench.CKPT):
            os.unlink(bench.CKPT)
        t0 = time.perf_counter()
        params, state, rp, rs = bench._train_synthetic(spec)
        sha = bench._tree_sha([params, state, rp, rs])
        md = _mean_det(spec, params, state, frames)
        dt = time.perf_counter() - t0
        print(f"run {i}: sha {sha}  mean_det/frame@0.8 {md:.3f}  "
              f"({dt:.0f}s)", file=sys.stderr)
        runs.append((sha, md, (params, state, rp, rs)))

    # cross-process data point: the live bench cache, if present
    real = bench.CKPT
    if os.path.exists(real):
        cp, cs, crp, crs = bench._load_trees(real, list(runs[0][2]))
        print(f"cached bench ckpt: sha {bench._tree_sha([cp, cs, crp, crs])}"
              f"  mean_det/frame@0.8 {_mean_det(spec, cp, cs, frames):.3f}",
              file=sys.stderr)

    (sha0, md0, t0_), (sha1, md1, t1_) = runs
    if sha0 == sha1:
        print(f"DETERMINISTIC: both retrains identical (sha {sha0}), "
              f"mean_det {md0:.3f}")
        return 0
    # quantify the divergence
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(t0_[:2]),
                    jax.tree_util.tree_leaves(t1_[:2])):
        worst = max(worst, float(jnp.max(jnp.abs(
            a.astype(jnp.float32) - b.astype(jnp.float32)))))
    print(f"NONDETERMINISTIC: sha {sha0} vs {sha1}; "
          f"max|dW| {worst:.3e}; mean_det {md0:.3f} vs {md1:.3f} "
          f"(delta {abs(md0-md1):.3f})")
    return 1


if __name__ == "__main__":
    sys.exit(main())
