"""Detection metrics: AP / mAP evaluator, batched and fixed-shape for XLA.

Parity targets:
- ``average_precision`` / ``compute_ap`` — CVC-YOLOv3/utils/utils.py:58-119
  (py-faster-rcnn envelope AP).
- greedy detection↔GT matching — CVC-YOLOv3/validate.py:106-139: detections
  sorted by descending confidence, each matched to its best-IoU target
  (+1-convention IoU), TP iff IoU > iou_thresh and the target is unclaimed;
  AP computed *per image* and averaged across images.

The reference evaluates with a Python loop per image per detection; here the
whole image batch is one jitted program: conf-filter → NMS → match → AP all
run on device with masks, and only the final per-image scalars come home.

Reference quirks reproduced:
- the padded-label filter drops rows where ANY of x/y/w/h ≤ 0
  (validate.py:106), which also drops real boxes touching the left/top edge;
- images with zero post-NMS detections or zero labels are skipped from the
  mAP average entirely (validate.py:98-99,124-126).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.ops.boxes import bbox_iou_pairwise, xywh2xyxy
from mit_driverless_cv_traininginfra.ops.nms import nms


def compute_ap(recall, precision):
    """Envelope AP (utils/utils.py:90-119), vectorised: sentinel pad, reverse
    cummax envelope, Σ Δrecall · precision."""
    mrec = jnp.concatenate([jnp.zeros((1,)), recall, jnp.ones((1,))])
    mpre = jnp.concatenate([jnp.zeros((1,)), precision, jnp.zeros((1,))])
    mpre = jnp.flip(jax.lax.cummax(jnp.flip(mpre), axis=0))
    return jnp.sum((mrec[1:] - mrec[:-1]) * mpre[1:])


def average_precision(tp, conf, n_gt, valid=None):
    """AP, recall, precision for one image's detections
    (utils/utils.py:58-88), with a validity mask for fixed-shape batches.

    tp: (K,) 0/1; conf: (K,); valid: (K,) bool (default all).
    """
    tp = jnp.asarray(tp, jnp.float32)
    conf = jnp.asarray(conf, jnp.float32)
    if valid is None:
        valid = jnp.ones(tp.shape, bool)
    v = valid.astype(jnp.float32)
    order = jnp.argsort(-jnp.where(valid, conf, -jnp.inf))
    tp = tp[order] * v[order]
    fp = (1.0 - tp) * v[order]

    tpc = jnp.cumsum(tp)
    fpc = jnp.cumsum(fp)
    recall_curve = tpc / (n_gt + 1e-16)
    precision_curve = tpc / jnp.maximum(tpc + fpc, 1e-16)
    r = tpc[-1] / (n_gt + 1e-16)
    p = tpc[-1] / jnp.maximum(tpc[-1] + fpc[-1], 1e-16)
    ap = compute_ap(recall_curve, precision_curve)
    return ap, r, p


def greedy_match(det_boxes, det_valid, gt_boxes, gt_valid, iou_thresh: float):
    """One-detection-per-target greedy matching (validate.py:112-133).

    det_boxes must already be sorted by descending confidence. Returns
    correct: (K,) float 0/1 TP flags.
    """
    K = det_boxes.shape[0]
    ious = bbox_iou_pairwise(det_boxes, gt_boxes)  # (K, G) +1 convention
    ious = jnp.where(gt_valid[None, :], ious, -1.0)

    def body(i, carry):
        detected, correct = carry
        best = jnp.argmax(ious[i])
        ok = (
            det_valid[i]
            & (ious[i, best] > iou_thresh)
            & ~detected[best]
        )
        correct = correct.at[i].set(ok.astype(jnp.float32))
        detected = detected.at[best].set(detected[best] | ok)
        return detected, correct

    detected0 = jnp.zeros(gt_boxes.shape[0], bool)
    correct0 = jnp.zeros((K,), jnp.float32)
    _, correct = jax.lax.fori_loop(0, K, body, (detected0, correct0))
    return correct


class ImageEval(NamedTuple):
    ap: jnp.ndarray
    recall: jnp.ndarray
    precision: jnp.ndarray
    valid: jnp.ndarray  # bool — include this image in the averages


@functools.partial(
    jax.jit,
    static_argnames=("conf_thresh", "nms_thresh", "iou_thresh", "top_k",
                     "img_width", "img_height"),
)
def evaluate_image_batch(
    detections,
    labels,
    img_width: int,
    img_height: int,
    conf_thresh: float,
    nms_thresh: float,
    iou_thresh: float,
    top_k: int = 200,
) -> ImageEval:
    """Batched per-image evaluation.

    detections: (B, N, 5+C) raw model output [cx, cy, w, h, conf, cls...]
        in input pixels (the eval branch of the YOLO head).
    labels: (B, T, 5) normalised [class, cx, cy, w, h]; zero rows = padding.

    Returns per-image AP/R/P plus a validity flag replicating the
    reference's skip rules.
    """

    def one(dets, labs):
        conf = dets[:, 4]
        keep_conf = conf > conf_thresh
        boxes = xywh2xyxy(dets[:, 0:4])
        scores = jnp.where(keep_conf, conf, -jnp.inf)
        keep_idx, keep_mask = nms(boxes, scores, overlap=nms_thresh, top_k=top_k)
        det_boxes = boxes[keep_idx]
        det_conf = conf[keep_idx]
        # NMS emits kept slots already in descending-confidence order.
        lab_valid = jnp.sum((labs[:, 1:5] <= 0), axis=1) == 0  # validate.py:106
        gt = xywh2xyxy(labs[:, 1:5]) * jnp.asarray(
            [img_width, img_height, img_width, img_height], dtype=dets.dtype
        )
        correct = greedy_match(det_boxes, keep_mask, gt, lab_valid, iou_thresh)
        n_gt = jnp.sum(lab_valid)
        ap, r, p = average_precision(correct, det_conf, n_gt, valid=keep_mask)
        img_valid = (jnp.sum(keep_mask) > 0) & (n_gt > 0)
        return ImageEval(ap, r, p, img_valid)

    return jax.vmap(one)(detections, labels)


def summarize(ev: ImageEval):
    """Host-side aggregation: means over valid images (validate.py:171-182)."""
    import numpy as np

    valid = np.asarray(ev.valid)
    if valid.sum() == 0:
        return 0.0, 0.0, 0.0
    return (
        float(np.asarray(ev.ap)[valid].mean()),
        float(np.asarray(ev.recall)[valid].mean()),
        float(np.asarray(ev.precision)[valid].mean()),
    )
