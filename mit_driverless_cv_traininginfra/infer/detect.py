"""Single-image / batched YOLO detection path.

Parity with ``CVC-YOLOv3/detect.py:60-111`` (pad → resize → forward →
conf-filter → NMS → unpad/unscale), re-designed so everything from raw
letterboxed pixels to final original-resolution boxes is ONE jitted XLA
program with fixed shapes — no host NMS loop, no per-image recompiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra.config.darknet_cfg import NetworkSpec
from mit_driverless_cv_traininginfra.models.darknet import detections as yolo_detections
from mit_driverless_cv_traininginfra.ops.boxes import calculate_padding
from mit_driverless_cv_traininginfra.ops.image import letterbox
from mit_driverless_cv_traininginfra.ops.nms import nms


class Detections(NamedTuple):
    boxes: jnp.ndarray   # (B, top_k, 4) xyxy
    scores: jnp.ndarray  # (B, top_k)
    mask: jnp.ndarray    # (B, top_k) bool


@functools.partial(
    jax.jit,
    static_argnames=("spec", "conf_thresh", "nms_thresh", "top_k"),
)
def detect_batch(
    spec: NetworkSpec,
    params,
    state,
    images,
    conf_thresh: float,
    nms_thresh: float,
    top_k: int = 200,
) -> Detections:
    """Forward + postprocess on model-sized images (B, H, W, C) in [0,1].

    Boxes come back in *model input* pixel coordinates; use
    :func:`unletterbox_boxes` to map to original resolution
    (detect.py:99-103).
    """
    dets = yolo_detections(spec, params, state, images)  # (B, N, 5+C)

    def one(d):
        conf = d[:, 4]
        xy = d[:, 0:2]
        wh = d[:, 2:4] / 2
        corner = jnp.concatenate([xy - wh, xy + wh], axis=1)
        scores = jnp.where(conf > conf_thresh, conf, -jnp.inf)
        keep_idx, keep_mask = nms(corner, scores, overlap=nms_thresh, top_k=top_k)
        return corner[keep_idx], conf[keep_idx], keep_mask

    boxes, scores, mask = jax.vmap(one)(dets)
    return Detections(boxes, scores, mask)


def unletterbox_boxes(boxes, pad_h: float, pad_w: float, ratio: float):
    """Map model-space xyxy boxes back to original image pixels
    (detect.py:99-103: divide by ratio then subtract pads)."""
    off = jnp.asarray([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype)
    return boxes / ratio - off


def detect_image(
    spec: NetworkSpec,
    params,
    state,
    image: np.ndarray,
    conf_thresh: float = None,
    nms_thresh: float = None,
    top_k: int = 200,
):
    """Host entry: one RGB uint8/float image (H, W, 3) at any resolution →
    (boxes_xyxy_orig, scores) numpy arrays of the kept detections."""
    if conf_thresh is None:
        conf_thresh = spec.net.conf_thresh
    if nms_thresh is None:
        nms_thresh = spec.net.nms_thresh
    arr = np.asarray(image)
    img = jnp.asarray(arr, jnp.float32)
    if np.issubdtype(arr.dtype, np.integer):
        # integer input is always 0-255 — scale unconditionally (a value
        # heuristic would leave a near-black uint8 frame unscaled,
        # turning pixel value 1 into full white)
        img = img / 255.0
    elif float(img.max()) > 1.5:
        # float input: assume [0,1] unless values say otherwise
        img = img / 255.0
    h, w = int(img.shape[0]), int(img.shape[1])
    pad_h, pad_w, ratio = calculate_padding(h, w, spec.net.height, spec.net.width)
    boxed, _ = letterbox(img[None], spec.net.height, spec.net.width)
    det = detect_batch(spec, params, state, boxed, conf_thresh, nms_thresh, top_k)
    boxes = unletterbox_boxes(det.boxes[0], pad_h, pad_w, ratio)
    m = np.asarray(det.mask[0])
    return np.asarray(boxes)[m], np.asarray(det.scores[0])[m]
