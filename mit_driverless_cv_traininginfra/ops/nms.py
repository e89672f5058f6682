"""Fixed-shape greedy NMS, compiled by XLA — replaces the reference's serial
Python-loop NMS (utils/nms.py:4-62), which is O(n²) *sequential* on the host.

Design: XLA wants static shapes and no data-dependent control flow. We

1. take the top ``top_k`` candidates by score (one ``lax.top_k``, no host
   sync),
2. compute the full (top_k × top_k) IoU matrix in one fused op,
3. run the greedy suppression as a ``lax.fori_loop`` over top_k steps of
   pure vector ops (each step masks the survivors of one kept box).

Semantics parity with the reference: score-descending greedy, a candidate is
suppressed iff IoU with an earlier *kept* box exceeds ``overlap`` (strictly:
the reference keeps ``IoU <= overlap``, utils/nms.py:60), and the IoU here
uses the raw ``x2-x1`` convention (NO +1 — unlike utils/utils.py:bbox_iou;
the reference NMS really does differ from its own evaluator IoU).

Invalid/padded candidates carry score ``-inf`` and are never kept.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.ops.boxes import iou_no_plus_one_pairwise


@functools.partial(jax.jit, static_argnames=("overlap", "top_k"))
def nms(boxes, scores, overlap: float = 0.5, top_k: int = 200):
    """Single-image NMS.

    Args:
        boxes:  (N, 4) xyxy, float.
        scores: (N,) float; use ``-inf`` (or very negative) for padded rows.
        overlap: IoU suppression threshold (keep IoU <= overlap).
        top_k:  static candidate cap (reference default 200).

    Returns:
        keep_idx:  (top_k,) int32 indices into the input arrays, in kept
                   (score-descending) order; padded with 0 past ``count``.
        keep_mask: (top_k,) bool validity of each slot.
    """
    n = boxes.shape[0]
    k = min(top_k, n)
    top_scores, order = jax.lax.top_k(scores, k)
    cand = boxes[order]  # (k, 4)

    iou = iou_no_plus_one_pairwise(cand, cand)  # (k, k)
    valid0 = jnp.isfinite(top_scores)

    def body(i, state):
        alive, kept = state
        is_kept = alive[i]
        kept = kept.at[i].set(is_kept)
        # Suppress later candidates overlapping box i (only if i is kept).
        later = jnp.arange(k) > i
        suppress = later & (iou[i] > overlap) & is_kept
        alive = alive & ~suppress
        return alive, kept

    alive0 = valid0
    kept0 = jnp.zeros((k,), dtype=bool)
    _, kept = jax.lax.fori_loop(0, k, body, (alive0, kept0))

    # Compact kept slots to the front, preserving score order — mirrors the
    # reference's keep[:count] layout (utils/nms.py:35-62).
    kept_i32 = kept.astype(jnp.int32)
    dest = jnp.cumsum(kept_i32) - 1  # target slot for each kept candidate
    keep_idx = jnp.zeros((top_k,), dtype=jnp.int32)
    keep_mask = jnp.zeros((top_k,), dtype=bool)
    src_idx = jnp.where(kept, dest, top_k)  # park dropped ones out of range
    keep_idx = keep_idx.at[src_idx].set(order.astype(jnp.int32), mode="drop")
    keep_mask = keep_mask.at[src_idx].set(kept, mode="drop")
    return keep_idx, keep_mask


def batched_nms(boxes, scores, overlap: float = 0.5, top_k: int = 200):
    """vmapped :func:`nms` over a leading batch dim: (B, N, 4), (B, N)."""
    fn = functools.partial(nms, overlap=overlap, top_k=top_k)
    return jax.vmap(fn)(boxes, scores)
