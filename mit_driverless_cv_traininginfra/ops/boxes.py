"""Box-format and padding geometry ops, as pure jax-numpy functions.

Numeric parity targets (reference file:line):
- ``xywh2xyxy`` / ``xyxy2xywh``           — CVC-YOLOv3/utils/utils.py:121-152
- ``bbox_iou`` (+1 pixel convention!)     — utils/utils.py:163-193
- ``calculate_padding``                   — utils/utils.py:36-48
- ``add_class_dimension_to_labels``       — utils/utils.py:329-337
- ``xyhw2xyxy_corner`` (CSV boxes are
  ``[x, y, h, w]`` top-left, h before w)  — utils/utils.py:342-349
- ``scale_labels`` / ``add_padding_on_each_side`` — utils/utils.py:353-371

Everything is shape-polymorphic over leading batch dims and accepts numpy
inputs (converted to jax arrays on entry — results are jax arrays), so the
host-side data pipeline and the jitted device code share one implementation.
"""

from __future__ import annotations

import jax.numpy as jnp


def xywh2xyxy(x):
    """[cx, cy, w, h] → [x1, y1, x2, y2] (utils/utils.py:121-132)."""
    return jnp.stack(
        [
            x[..., 0] - x[..., 2] / 2,
            x[..., 1] - x[..., 3] / 2,
            x[..., 0] + x[..., 2] / 2,
            x[..., 1] + x[..., 3] / 2,
        ],
        axis=-1,
    )


def xyxy2xywh(x):
    """[x1, y1, x2, y2] → [cx, cy, w, h] (utils/utils.py:134-152)."""
    return jnp.stack(
        [
            (x[..., 0] + x[..., 2]) / 2,
            (x[..., 1] + x[..., 3]) / 2,
            jnp.abs(x[..., 2] - x[..., 0]),
            jnp.abs(x[..., 3] - x[..., 1]),
        ],
        axis=-1,
    )


def bbox_iou(box1, box2, x1y1x2y2: bool = True):
    """Elementwise IoU with the reference's ``+1`` pixel convention
    (utils/utils.py:163-193). Broadcasts over leading dims."""
    if not x1y1x2y2:
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = (box1[..., i] for i in range(4))
        b2_x1, b2_y1, b2_x2, b2_y2 = (box2[..., i] for i in range(4))

    inter_w = jnp.clip(jnp.minimum(b1_x2, b2_x2) - jnp.maximum(b1_x1, b2_x1) + 1, 0, None)
    inter_h = jnp.clip(jnp.minimum(b1_y2, b2_y2) - jnp.maximum(b1_y1, b2_y1) + 1, 0, None)
    inter = inter_w * inter_h
    area1 = (b1_x2 - b1_x1 + 1) * (b1_y2 - b1_y1 + 1)
    area2 = (b2_x2 - b2_x1 + 1) * (b2_y2 - b2_y1 + 1)
    return inter / (area1 + area2 - inter + 1e-12)


def bbox_iou_pairwise(boxes1, boxes2, x1y1x2y2: bool = True):
    """All-pairs IoU: (..., N, 4) × (..., M, 4) → (..., N, M).

    Same +1 convention as :func:`bbox_iou`; this is the batched form the
    evaluator and NMS use so matching is one fused XLA op instead of the
    reference's per-detection Python loop (validate.py:124-133).
    """
    return bbox_iou(boxes1[..., :, None, :], boxes2[..., None, :, :], x1y1x2y2)


def iou_no_plus_one_pairwise(boxes1, boxes2):
    """All-pairs IoU *without* the +1 convention — matches the arithmetic in
    the reference NMS (utils/nms.py:24-60), which uses raw ``x2-x1`` widths."""
    x1 = jnp.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    y1 = jnp.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    x2 = jnp.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
    y2 = jnp.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
    inter = jnp.clip(x2 - x1, 0, None) * jnp.clip(y2 - y1, 0, None)
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / jnp.where(union == 0, 1.0, union)


def calculate_padding(orig_height, orig_width, new_height, new_width):
    """Letterbox padding + scale factor (utils/utils.py:36-48).

    Python-scalar function (host-side; shapes must be static for XLA anyway).
    Returns (pad_h, pad_w, scale_factor).
    """
    if max(orig_height, orig_width) == orig_height:
        new_img_width = orig_height * new_width / new_height
        scale_factor = new_height / orig_height
        pad_h = 0
        pad_w = int((new_img_width - orig_width) / 2)
    else:
        scale_factor = new_width / orig_width
        new_img_height = orig_width * new_height / new_width
        pad_w = 0
        pad_h = int((new_img_height - orig_height) / 2)
    return pad_h, pad_w, scale_factor


def add_class_dimension_to_labels(labels):
    """(N, 4) boxes → (N, 5) with class column 0 = 0 (utils/utils.py:329-337)."""
    cls = jnp.zeros(labels.shape[:-1] + (1,), dtype=labels.dtype)
    return jnp.concatenate([cls, labels[..., :4]], axis=-1)


def xyhw2xyxy_corner(labels, skip_class_dimension: bool = True):
    """CSV ``[x, y, h, w]`` (top-left, h before w!) → ``[x1, y1, x2, y2]``
    (utils/utils.py:342-349)."""
    i = 1 if skip_class_dimension else 0
    out = labels = jnp.asarray(labels)  # .at[] needs a jax array
    out = out.at[..., 2 + i].set(labels[..., 0 + i] + labels[..., 3 + i])
    out = out.at[..., 3 + i].set(labels[..., 1 + i] + labels[..., 2 + i])
    return out


def scale_labels(labels, scale, skip_class_dimension: bool = True):
    """Multiply the 4 box coords by ``scale`` (utils/utils.py:353-360)."""
    i = 1 if skip_class_dimension else 0
    labels = jnp.asarray(labels)  # .at[] needs a jax array
    return labels.at[..., i : i + 4].set(labels[..., i : i + 4] * scale)


def add_padding_on_each_side(labels, pad_w, pad_h, skip_class_dimension: bool = True):
    """Offset xyxy boxes by (pad_w, pad_h) (utils/utils.py:364-371)."""
    i = 1 if skip_class_dimension else 0
    labels = jnp.asarray(labels)  # .at[] needs a jax array
    off = jnp.asarray([pad_w, pad_h, pad_w, pad_h], dtype=labels.dtype)
    return labels.at[..., i : i + 4].set(labels[..., i : i + 4] + off)
