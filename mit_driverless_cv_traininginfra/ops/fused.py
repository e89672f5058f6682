"""Fused ops of the two-stage pipeline, written in plain JAX for XLA.

- :func:`fused_softargmax` — the RektNet decode: flat softmax over the
  80×80 heatmap plus the soft-argmax expectation (keypoint_net.py:46-56),
  the "distinctive fused op" of the keypoint path (SURVEY.md §3.3). XLA
  fuses it into a few row-reduction kernels; a custom VJP recomputes the
  cheap backward from the saved probabilities, so the same op serves
  inference and the ``l2_softargmax``-style training losses.
- :func:`nms_topk` — conf threshold + top-k + greedy NMS per image at a
  fixed shape.

A hand-written Triton kernel of the softargmax was timed against this
formulation inside the fused pipeline on an H100 and did not win end to
end (PERF.md "Kernel verdicts").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _coord_rows(h: int, w: int, dtype):
    ys = jnp.linspace(0.0, (h - 1.0) / h, h, dtype=jnp.float32)
    xs = jnp.linspace(0.0, (w - 1.0) / w, w, dtype=jnp.float32)
    yv = jnp.repeat(ys, w)              # y varies over rows of the map
    xv = jnp.tile(xs, h)
    return xv[None, :].astype(dtype), yv[None, :].astype(dtype)


def _xla_softargmax(logits):
    m, h, w = logits.shape
    z = logits.reshape(m, h * w).astype(jnp.float32)
    z = z - jax.lax.stop_gradient(jnp.max(z, axis=-1, keepdims=True))
    e = jnp.exp(z)
    p = e / jnp.sum(e, axis=-1, keepdims=True)
    xv, yv = _coord_rows(h, w, jnp.float32)
    pts = jnp.stack([jnp.sum(p * xv, axis=1), jnp.sum(p * yv, axis=1)], axis=1)
    return pts, p.reshape(m, h, w).astype(logits.dtype)


@jax.custom_vjp
def fused_softargmax(logits):
    """(M, H, W) heatmap logits → (points (M, 2) in [0,1) xy, probs)."""
    return _xla_softargmax(logits)


def _xla_nms_topk(boxes, scores, conf_thresh: float, k: int, overlap: float):
    """Slots are the top-k candidates in score order (suppressed ones keep
    their slot with keep=False; below-conf slots carry score -inf)."""
    from mit_driverless_cv_traininginfra.ops.boxes import (
        iou_no_plus_one_pairwise,
    )

    masked = jnp.where(scores > conf_thresh, scores.astype(jnp.float32),
                       -jnp.inf)
    top_val, top_idx = jax.lax.top_k(masked, k)            # (B, k)
    cand = jnp.take_along_axis(boxes.astype(jnp.float32),
                               top_idx[..., None], axis=1)  # (B, k, 4)
    iou = iou_no_plus_one_pairwise(cand, cand)              # (B, k, k)
    valid0 = jnp.isfinite(top_val)
    slot = jnp.arange(k)

    # Greedy suppression, unrolled (k is small and static): a fori_loop
    # would run k sequential steps inside the program; the unrolled chain
    # fuses into a handful of elementwise kernels.
    alive = valid0
    kept_cols = []
    for i in range(k):
        is_kept = alive[:, i]
        kept_cols.append(is_kept)
        later = slot[None, :] > i
        suppress = later & (iou[:, i, :] > overlap) & is_kept[:, None]
        alive = alive & ~suppress
    kept = jnp.stack(kept_cols, axis=1)
    return cand, top_val, top_idx, kept


def nms_topk(boxes, scores, conf_thresh: float, k: int = 16,
             overlap: float = 0.25):
    """Fused conf-filter + top-k + greedy NMS per image.

    Returns (boxes (B,k,4), scores (B,k), keep (B,k) bool), where slot i is
    the i-th highest-scoring candidate (suppressed candidates stay in
    place with keep=False; below-conf slots carry score -inf). Greedy
    suppression semantics match ops.nms (score-descending, suppress at
    IoU > overlap, no +1 convention) — only the layout differs from
    ops.nms's front-compaction."""
    b, s, _, keep = _xla_nms_topk(boxes, scores, conf_thresh, k, overlap)
    return b, s, keep


def _fwd(logits):
    pts, probs = fused_softargmax(logits)
    return (pts, probs), (probs,)


def _bwd(res, cts):
    (probs,) = res
    g_pts, g_probs = cts
    m, h, w = probs.shape
    p = probs.reshape(m, h * w).astype(jnp.float32)
    xv, yv = _coord_rows(h, w, jnp.float32)
    # dL/dz through points: softmax-weighted coordinate deviation
    up = (g_pts[:, 0:1] * xv + g_pts[:, 1:2] * yv)
    gp = g_probs.reshape(m, h * w).astype(jnp.float32) + up
    dz = p * (gp - jnp.sum(gp * p, axis=1, keepdims=True))
    return (dz.reshape(m, h, w).astype(probs.dtype),)


fused_softargmax.defvjp(_fwd, _bwd)
