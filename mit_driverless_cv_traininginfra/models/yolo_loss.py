"""YOLO target assignment + multi-part loss, fully vectorised for XLA.

Parity targets:
- ``build_targets``  — CVC-YOLOv3/utils/utils.py:195-275 (already masked and
  fixed-shape in the reference, so it maps 1:1 onto XLA scatters — no
  dynamic shapes anywhere).
- per-head loss      — CVC-YOLOv3/models.py:199-211 (masked MSE on xy/wh,
  masked BCE on obj/noobj, class loss hardwired to 0 for single-class).

Reference quirks reproduced deliberately:
- anchor-vs-gt IoU uses the evaluator's +1 pixel convention on (0,0,w,h)
  shape boxes (bbox_iou is called with default x1y1x2y2=True on
  ``[0,0,gw,gh]`` rows — utils/utils.py:234-240);
- the ignore-threshold zeroing ``conf_mask[:, :, gj, gi] = 0`` applies to the
  collected (gj, gi) cells across the ENTIRE batch and ALL anchors
  (utils/utils.py:244-255), not just the owning sample/anchor;
- padded target rows are remapped onto each image's first target row
  ("all images have at least one target", utils/utils.py:221-228), so their
  scatters are harmless duplicates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config.darknet_cfg import NetworkSpec, YoloBlock
from mit_driverless_cv_traininginfra.models.darknet import head_predictions


class YoloTargets(NamedTuple):
    mask: jnp.ndarray       # (B, A, H, W) bool — object cells
    conf_mask: jnp.ndarray  # (B, A, H, W) bool — cells contributing conf loss
    tx: jnp.ndarray
    ty: jnp.ndarray
    tw: jnp.ndarray
    th: jnp.ndarray
    tconf: jnp.ndarray
    tcls: jnp.ndarray       # (B, A, H, W, C)


@functools.partial(jax.jit, static_argnames=("num_classes", "grid_h", "grid_w"))
def build_targets(
    target,
    anchors,
    num_classes: int,
    grid_h: int,
    grid_w: int,
    ignore_thresh: float,
) -> YoloTargets:
    """Vectorised GT→(anchor, cell) assignment.

    Args:
        target: (B, T, 5) ``[class, cx, cy, w, h]`` normalised to [0,1];
            zero rows are padding.
        anchors: (A, 2) ``(w, h)`` in *grid* units (i.e. pixel anchors / stride).
    """
    target = jnp.asarray(target, jnp.float32)
    anchors = jnp.asarray(anchors, jnp.float32)
    B, T, _ = target.shape
    A = anchors.shape[0]

    master = jnp.sum(target, axis=2) > 0  # (B, T)

    gx = target[:, :, 1] * grid_w
    gy = target[:, :, 2] * grid_h
    gw = target[:, :, 3] * grid_w
    gh = target[:, :, 4] * grid_h

    def fill(v):
        # padded rows take row 0's value (utils/utils.py:221-228)
        return jnp.where(master, v, v[:, 0:1])

    gx, gy, gw, gh = fill(gx), fill(gy), fill(gw), fill(gh)
    gi = jnp.clip(gx.astype(jnp.int32), 0, grid_w - 1)
    gj = jnp.clip(gy.astype(jnp.int32), 0, grid_h - 1)

    # anchor IoU with the +1 convention on (0,0,w,h) boxes (utils.py:234-240)
    aw = anchors[:, 0]
    ah = anchors[:, 1]
    inter = (jnp.minimum(gw[..., None], aw) + 1) * (jnp.minimum(gh[..., None], ah) + 1)
    union = (gw[..., None] + 1) * (gh[..., None] + 1) + (aw + 1) * (ah + 1) - inter
    anch_ious = inter / (union + 1e-12)  # (B, T, A)

    # batch-global (gj, gi) ignore cells (reference quirk, utils.py:244-255)
    any_ignore = jnp.any(anch_ious > ignore_thresh, axis=2)  # (B, T)
    hw_ignore = jnp.zeros((grid_h, grid_w), bool)
    hw_ignore = hw_ignore.at[gj.ravel(), gi.ravel()].max(any_ignore.ravel())
    conf_mask = jnp.broadcast_to(~hw_ignore, (B, A, grid_h, grid_w))

    best_n = jnp.argmax(anch_ious, axis=2)  # (B, T)
    b_idx = jnp.broadcast_to(jnp.arange(B)[:, None], (B, T))

    zeros = jnp.zeros((B, A, grid_h, grid_w), jnp.float32)
    mask = jnp.zeros((B, A, grid_h, grid_w), bool).at[b_idx, best_n, gj, gi].set(True)
    conf_mask = conf_mask.at[b_idx, best_n, gj, gi].set(True)

    tx = zeros.at[b_idx, best_n, gj, gi].set(gx - gi.astype(jnp.float32))
    ty = zeros.at[b_idx, best_n, gj, gi].set(gy - gj.astype(jnp.float32))
    tw = zeros.at[b_idx, best_n, gj, gi].set(jnp.log(gw / anchors[best_n, 0] + 1e-16))
    th = zeros.at[b_idx, best_n, gj, gi].set(jnp.log(gh / anchors[best_n, 1] + 1e-16))
    tconf = zeros.at[b_idx, best_n, gj, gi].set(1.0)

    label = jnp.clip(target[:, :, 0].astype(jnp.int32), 0, num_classes - 1)
    tcls = jnp.zeros((B, A, grid_h, grid_w, num_classes), jnp.float32)
    tcls = tcls.at[b_idx, best_n, gj, gi, label].set(1.0)

    return YoloTargets(mask, conf_mask, tx, ty, tw, th, tconf, tcls)


def _masked_mean(x, m):
    denom = jnp.maximum(jnp.sum(m), 1.0)
    return jnp.sum(x * m) / denom


def _bce(p, t):
    """torch BCELoss elementwise: -(t·log p + (1−t)·log(1−p)), logs clamped
    at −100 like torch."""
    logp = jnp.maximum(jnp.log(p), -100.0)
    log1p = jnp.maximum(jnp.log(1.0 - p), -100.0)
    return -(t * logp + (1.0 - t) * log1p)


def _bce_logits(logit, t):
    """``BCELoss(sigmoid(logit))`` with the same −100 log clamp, computed
    FROM LOGITS: log σ(l) = −softplus(−l), log(1−σ(l)) = −softplus(l).

    In exact arithmetic the forward is identical (softplus(l) =
    −log(1−σ(l)); the clamp binds iff softplus > 100, i.e. |l| > 100).
    In f32 the two diverge where the post-sigmoid form's "wrong-side"
    log saturates: for t=0 with l ∈ (16.6, 100), σ(l) rounds to exactly
    1.0 so :func:`_bce` (and torch's BCELoss it mirrors) hits log(0)
    and returns the clamp value 100, while this form returns the TRUE
    loss ≈ l; symmetrically for t=1 only once σ(l) underflows to 0
    (l ≲ −88 — below that e^l is still representable and both forms
    agree). The logits form is the more accurate one and its gradients
    stay bounded (softplus' = sigmoid) where the post-sigmoid form
    emits 0·inf = NaN — measured as flagship-scale training divergence
    at step ~3 with B=32 (tools/train_to_map.py r3). Loss-VALUE parity
    vs torch therefore holds only outside those saturation regions; the
    oracle tests exercise unsaturated logits."""
    return (t * jnp.minimum(jax.nn.softplus(-logit), 100.0)
            + (1.0 - t) * jnp.minimum(jax.nn.softplus(logit), 100.0))


def yolo_head_loss(
    head_out,
    target,
    anchors: Sequence[Tuple[float, float]],
    img_height: int,
    num_classes: int,
    ignore_thresh: float,
    xy_loss: float,
    wh_loss: float,
    object_loss: float,
    no_object_loss: float,
):
    """Single-head training loss (models.py:172-211).

    Returns (loss, components) with components = (x, y, w, h, obj, noobj),
    matching the reference's logging order (models.py:211).
    """
    b, gh, gw, _ = head_out.shape
    na = len(anchors)
    stride = img_height / gh
    scaled = jnp.asarray(anchors, jnp.float32) / stride
    pred = head_predictions(head_out, na, num_classes)
    t = build_targets(target, scaled, num_classes, gh, gw, ignore_thresh)

    m = t.mask.astype(jnp.float32)
    noobj = (t.conf_mask & ~t.mask).astype(jnp.float32)
    obj = m

    loss_x = xy_loss * _masked_mean((pred["x"] - t.tx) ** 2, m)
    loss_y = xy_loss * _masked_mean((pred["y"] - t.ty) ** 2, m)
    loss_w = wh_loss * _masked_mean((pred["w"] - t.tw) ** 2, m)
    loss_h = wh_loss * _masked_mean((pred["h"] - t.th) ** 2, m)
    loss_noobj = no_object_loss * _masked_mean(
        _bce_logits(pred["conf_logit"], t.tconf), noobj)
    loss_obj = object_loss * _masked_mean(
        _bce_logits(pred["conf_logit"], t.tconf), obj)
    # class loss hardwired to 0 for single-class detection (models.py:203-205)
    loss = loss_x + loss_y + loss_w + loss_h + loss_noobj + loss_obj
    comps = jnp.stack([loss_x, loss_y, loss_w, loss_h, loss_obj, loss_noobj])
    return loss, comps


def yolo_loss(spec: NetworkSpec, head_outputs, target,
              xy_loss: float, wh_loss: float,
              object_loss: float, no_object_loss: float):
    """Sum of per-head losses (Darknet.forward training branch,
    models.py:328-338). Returns (total_loss, components(6))."""
    yolo_blocks = [blk for blk in spec.blocks if isinstance(blk, YoloBlock)]
    total = 0.0
    comps = jnp.zeros((6,))
    for head_out, blk in zip(head_outputs, yolo_blocks):
        l, c = yolo_head_loss(
            head_out, target, blk.anchors, spec.net.height,
            spec.net.num_classes, spec.net.build_targets_ignore_thresh,
            xy_loss, wh_loss, object_loss, no_object_loss,
        )
        total = total + l
        comps = comps + c
    return total, comps
