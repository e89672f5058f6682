"""Two-stage perception pipeline: YOLO detect → crop → RektNet keypoints.

The reference runs this split across two ONNX models with host-side crop
plumbing between them (README.md:59: "RektNet takes in bounding boxes
outputed from CVC-YOLOv3"). Here the whole frame path is ONE compiled XLA
program per batch:

    frames ─ Darknet graph ─ decode ─ batched NMS ─ top-K boxes
           └──────────────────────────────► ROI bilinear gather (80×80)
                                               └─ RektNet ─ soft-argmax
                                                       └─ keypoints in frame px

Fixed capacity everywhere: every frame yields exactly ``max_det`` crop slots
(masked), so there is no recompile and no host sync between the stages —
the detect boxes feed the keypoint batch in device memory.

Each stage runs under a ``jax.named_scope`` (detect, nms, crop, keypoints)
so a profiler trace attributes device time to it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config.darknet_cfg import NetworkSpec
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import detections as yolo_detections
from mit_driverless_cv_traininginfra.ops.image import roi_crop_bilinear


def _postprocess(dets, conf_thresh: float, nms_thresh: float, max_det: int):
    """decode output (B, N, 5+C) → conf-filtered, NMS'd top-max_det boxes
    (fixed-shape threshold + top-k + greedy NMS, ops.fused.nms_topk)."""
    from mit_driverless_cv_traininginfra.ops.fused import nms_topk

    with jax.named_scope("nms"):
        conf = dets[..., 4]
        xy, wh = dets[..., 0:2], dets[..., 2:4] / 2
        corner = jnp.concatenate([xy - wh, xy + wh], axis=-1)
        return nms_topk(corner, conf, conf_thresh=conf_thresh, k=max_det,
                        overlap=nms_thresh)


class PipelineOut(NamedTuple):
    boxes: jnp.ndarray      # (B, K, 4) xyxy in frame pixels
    scores: jnp.ndarray     # (B, K)
    mask: jnp.ndarray       # (B, K) bool — valid detections
    keypoints: jnp.ndarray  # (B, K, 7, 2) xy in frame pixels


def _crops_and_keypoints(kpt_apply, frames, boxes, scores, mask,
                         crop_size: int, crop_capacity,
                         kpt_pad_multiple: int = 0):
    """ROI-crop + keypoint net, compacted to the valid detections.

    With trained conf sparsity most of the B·K fixed crop slots are masked
    padding; RektNet at 80×80 costs ~4 GFLOP *per crop*, so feeding it
    invalid slots is the single largest waste in the fused pipeline. With
    ``crop_capacity=C`` this selects the top-C crops GLOBALLY across the
    batch (valid first, score-descending — frames keep their full
    ``max_det`` capacity; only the batch-total is capped), crops ONLY those
    via the indexed matmul crop, runs the net on that fixed-size buffer,
    and scatters the points back. Bit-identical to the dense pass whenever
    #valid ≤ crop_capacity; overflow drops the lowest-score detections'
    keypoints, never their boxes.

    Returns ``(pts (B, K, 7, 2) in [0,1] crop coords, kept (B, K) bool)``:
    ``kept`` marks valid detections whose crops actually ran — callers
    zero the frame-space keypoints of ``~kept`` slots so dropped
    detections surface as all-zero keypoints (a detectable sentinel), not
    as plausible-looking points at the box's top-left corner.

    ``crop_capacity=None`` (or ≥ B·K) keeps the dense path.

    ``kpt_pad_multiple``: run the keypoint net on the crop buffer zero-
    padded up to the next multiple; the crop gather stays at the
    fine-grained capacity and the pad rows' outputs are sliced off, so
    results are unchanged. 0 disables.
    """
    from mit_driverless_cv_traininginfra.ops.image import (
        roi_crop_bilinear_indexed,
    )

    B, K = mask.shape
    if crop_capacity is None or crop_capacity >= B * K:
        crops = roi_crop_bilinear(frames, boxes, crop_size, crop_size)
        flat = crops.reshape(B * K, *crops.shape[2:])
        return kpt_apply(flat).reshape(B, K, 7, 2), mask
    key = jnp.where(mask.reshape(-1), -scores.reshape(-1).astype(jnp.float32),
                    jnp.inf)
    sel = jax.lax.top_k(-key, crop_capacity)[1]
    with jax.named_scope("crop"):
        crops_c = roi_crop_bilinear_indexed(
            frames, boxes.reshape(B * K, 4)[sel], sel // K, crop_size,
            crop_size)
    if kpt_pad_multiple and crop_capacity % kpt_pad_multiple:
        n_pad = (kpt_pad_multiple * -(-crop_capacity // kpt_pad_multiple)
                 - crop_capacity)
        crops_p = jnp.concatenate(
            [crops_c, jnp.zeros((n_pad, *crops_c.shape[1:]), crops_c.dtype)],
            axis=0)
        with jax.named_scope("keypoints"):
            pts_c = kpt_apply(crops_p)[:crop_capacity]  # (C, 7, 2)
    else:
        with jax.named_scope("keypoints"):
            pts_c = kpt_apply(crops_c)  # (C, 7, 2)
    pts = jnp.zeros((B * K, 7, 2), pts_c.dtype).at[sel].set(pts_c)
    kept = jnp.zeros((B * K,), bool).at[sel].set(True) & mask.reshape(-1)
    return pts.reshape(B, K, 7, 2), kept.reshape(B, K)


@functools.partial(
    jax.jit,
    static_argnames=("spec", "conf_thresh", "nms_thresh", "max_det",
                     "crop_size", "crop_capacity", "kpt_pad_multiple"),
)
def two_stage_pipeline(
    spec: NetworkSpec,
    yolo_params,
    yolo_state,
    rekt_params,
    rekt_state,
    frames,
    conf_thresh: float = 0.8,
    nms_thresh: float = 0.25,
    max_det: int = 16,
    crop_size: int = 80,
    packed_stem=None,
    crop_capacity=None,
    kpt_pad_multiple: int = 0,
) -> PipelineOut:
    """frames: (B, H, W, 3) in [0,1], H/W = spec.net input size.

    ``packed_stem``: optional space-to-depth stem weights (stem_opt) for the
    serving path — an exact rewrite of blocks 0-1.
    ``crop_capacity``: cap the batch-total keypoint crops (see
    :func:`_keypoints_compacted`).

    uint8 frames are accepted as a wire-efficient feed (4x fewer
    host→device bytes than f32 over PCIe): normalized on device in f32
    then cast to
    the params' float dtype. Matches the host f32/255 feed to 1 ulp of
    the normalize (XLA folds /255 into a reciprocal multiply — measured
    6e-8; tests/test_pipeline.py pins identical detection masks)."""
    if frames.dtype == jnp.uint8:
        fdt = next(l.dtype for l in jax.tree_util.tree_leaves(yolo_params)
                   if jnp.issubdtype(l.dtype, jnp.floating))
        frames = (frames.astype(jnp.float32) / 255.0).astype(fdt)
    with jax.named_scope("detect"):
        dets = yolo_detections(spec, yolo_params, yolo_state, frames,
                               packed_stem=packed_stem, with_classes=False)
    boxes, scores, mask = _postprocess(dets, conf_thresh, nms_thresh, max_det)

    if "bn" in rekt_params["stem"]:
        kpt_apply = lambda c: rektnet.apply(rekt_params, rekt_state, c)[1]
    else:  # BN-folded serving params (rektnet.fold_bn)
        kpt_apply = lambda c: rektnet.apply_folded(rekt_params, c)[1]
    pts, kept = _crops_and_keypoints(kpt_apply, frames, boxes, scores, mask,
                                     crop_size, crop_capacity,
                                     kpt_pad_multiple)  # [0,1] crop coords

    x0y0 = boxes[..., None, 0:2]
    wh_box = (boxes[..., 2:4] - boxes[..., 0:2])[..., None, :]
    # dropped/invalid slots get all-zero keypoints (detectable), not the
    # box corner the raw mapping would produce
    kpts = jnp.where(kept[..., None, None], x0y0 + pts * wh_box, 0.0)
    return PipelineOut(boxes, scores, mask, kpts)


@functools.partial(
    jax.jit,
    static_argnames=("spec", "conf_thresh", "nms_thresh", "max_det",
                     "crop_size", "crop_capacity", "kpt_pad_multiple"),
)
def two_stage_pipeline_int8(
    spec: NetworkSpec,
    yolo_q,
    stem_q,
    rekt_q,
    frames,
    conf_thresh: float = 0.8,
    nms_thresh: float = 0.25,
    max_det: int = 16,
    crop_size: int = 80,
    crop_capacity=None,
    entry_q=None,
    kpt_pad_multiple: int = 0,
) -> PipelineOut:
    """int8 serving configuration of the pipeline: quantized YOLO backbone
    (incl. packed stem) and quantized RektNet, bf16 elsewhere. Params from
    :mod:`models.quantize` (calibrate → quantize_params /
    quantize_packed_stem / quantize_rektnet_params). ``entry_q``
    (ops.entry.quantize_entry) switches blocks 0-4 to the 4×4-conv1 entry
    path."""
    from mit_driverless_cv_traininginfra.models.quantize import (
        apply_rektnet_int8,
        detections_int8,
    )

    if frames.dtype == jnp.uint8:
        # wire-efficient uint8 feed: normalize on device in f32 then cast
        # to bf16 — matches the host f32/255 → bf16 path this config is
        # otherwise fed with to 1 ulp (see two_stage_pipeline docstring)
        frames = (frames.astype(jnp.float32) / 255.0).astype(jnp.bfloat16)
    with jax.named_scope("detect"):
        dets = detections_int8(spec, yolo_q, frames, packed_stem_q=stem_q,
                               with_classes=False, entry_q=entry_q)
    boxes, scores, mask = _postprocess(dets, conf_thresh, nms_thresh, max_det)
    pts, kept = _crops_and_keypoints(
        lambda c: apply_rektnet_int8(rekt_q, c)[1],
        frames, boxes, scores, mask, crop_size, crop_capacity,
        kpt_pad_multiple)
    x0y0 = boxes[..., None, 0:2]
    wh_box = (boxes[..., 2:4] - boxes[..., 0:2])[..., None, :]
    kpts = jnp.where(kept[..., None, None], x0y0 + pts * wh_box, 0.0)
    return PipelineOut(boxes, scores, mask, kpts)
