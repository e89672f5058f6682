"""Pipeline-parallel serving: the two-stage program split across devices.

The fused ``two_stage_pipeline`` (infer/pipeline.py) is the single-device
form — one XLA program, detect boxes feeding the keypoint batch in device
memory. This module is the multi-device form of the same computation:
the natural graph boundary the reference itself deploys across two engines
("RektNet takes in bounding boxes outputed from CVC-YOLOv3",
/root/reference/README.md:59) becomes a device boundary:

    stage A (device/mesh A): detect → NMS → top-C crop compaction → crops
    stage B (device/mesh B): RektNet → soft-argmax → frame-px scatter

The inter-stage tensor is the COMPACTED crop buffer — (C, 80, 80, 3) plus
a few (B, K) vectors, ~10× smaller than the frame batch at the production
operating point — so the cut crosses between devices cheaply. Each stage is its own
jitted program committed to its device group; JAX's async dispatch then
overlaps stage A of batch *i+1* with stage B of batch *i* with no host
thread tricks: both dispatches return immediately and the devices run
concurrently.

When to use which:

- one device → ``two_stage_pipeline`` (fused; this module would only add a
  device round-trip);
- many devices, throughput → DP-sharded fused pipeline
  (``TwoStageServer(mesh=...)`` — batch over the mesh);
- devices with spare capacity at *different* stages, or per-stage batch
  sizes that want to differ (RektNet's optimum is crop-count-, not
  frame-count-shaped) → this module: each stage scales its own group.

Limitation: this path runs the bf16/f32 unpacked serving config only —
``detect_stage`` has no packed-stem / int8 / kpt-pad plumbing. The int8
serving configuration (int8 + packed stem) lives in
``two_stage_pipeline_int8``; use the fused
pipeline (optionally mesh-DP-sharded) for that operating point.

Value preservation vs the fused program is pinned in
``tests/test_parallel_tp.py`` (bit-level for the mask/boxes, fp-tolerance
for keypoints).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config.darknet_cfg import NetworkSpec
from mit_driverless_cv_traininginfra.infer.pipeline import (
    PipelineOut,
    _postprocess,
)
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import (
    detections as yolo_detections,
)


class StageAOut(NamedTuple):
    boxes: jnp.ndarray    # (B, K, 4) xyxy frame px
    scores: jnp.ndarray   # (B, K)
    mask: jnp.ndarray     # (B, K) bool
    sel: jnp.ndarray      # (C,) flat crop-slot indices (batch-global top-C)
    crops: jnp.ndarray    # (C, S, S, 3) compacted ROI crops


@functools.partial(
    jax.jit,
    static_argnames=("spec", "conf_thresh", "nms_thresh", "max_det",
                     "crop_size", "crop_capacity"),
)
def detect_stage(
    spec: NetworkSpec,
    yolo_params,
    yolo_state,
    frames,
    conf_thresh: float = 0.8,
    nms_thresh: float = 0.25,
    max_det: int = 16,
    crop_size: int = 80,
    crop_capacity: int = 64,
) -> StageAOut:
    """Detect + NMS + batch-global top-C crop compaction (stage A).

    Same selection semantics as the fused pipeline's compacted path
    (``_crops_and_keypoints``): valid-first, score-descending, capacity C
    across the whole batch; overflow drops the lowest-score detections'
    crops, never their boxes."""
    from mit_driverless_cv_traininginfra.ops.image import (
        roi_crop_bilinear_indexed,
    )

    if frames.dtype == jnp.uint8:
        fdt = next(l.dtype for l in jax.tree_util.tree_leaves(yolo_params)
                   if jnp.issubdtype(l.dtype, jnp.floating))
        frames = (frames.astype(jnp.float32) / 255.0).astype(fdt)
    dets = yolo_detections(spec, yolo_params, yolo_state, frames,
                           with_classes=False)
    boxes, scores, mask = _postprocess(dets, conf_thresh, nms_thresh, max_det)
    B, K = mask.shape
    key = jnp.where(mask.reshape(-1), -scores.reshape(-1).astype(jnp.float32),
                    jnp.inf)
    # Selection width cannot exceed the number of detection slots: top_k
    # raises on k > size, and capacity == B*K already keeps every crop.
    cap = min(crop_capacity, B * K)
    sel = jax.lax.top_k(-key, cap)[1]
    crops = roi_crop_bilinear_indexed(frames, boxes.reshape(B * K, 4)[sel],
                                      sel // K, crop_size, crop_size)
    return StageAOut(boxes, scores, mask, sel, crops)


@jax.jit
def keypoint_stage(rekt_params, rekt_state, a: StageAOut) -> PipelineOut:
    """RektNet on the compacted crops + frame-px scatter (stage B)."""
    if "bn" in rekt_params["stem"]:
        pts_c = rektnet.apply(rekt_params, rekt_state, a.crops)[1]
    else:  # BN-folded serving params
        pts_c = rektnet.apply_folded(rekt_params, a.crops)[1]
    B, K = a.mask.shape
    pts = jnp.zeros((B * K, 7, 2), pts_c.dtype).at[a.sel].set(pts_c)
    kept = jnp.zeros((B * K,), bool).at[a.sel].set(True) & a.mask.reshape(-1)
    pts, kept = pts.reshape(B, K, 7, 2), kept.reshape(B, K)
    x0y0 = a.boxes[..., None, 0:2]
    wh_box = (a.boxes[..., 2:4] - a.boxes[..., 0:2])[..., None, :]
    kpts = jnp.where(kept[..., None, None], x0y0 + pts * wh_box, 0.0)
    return PipelineOut(a.boxes, a.scores, a.mask, kpts)


class TwoStagePP:
    """Host-side driver: stage A committed to ``device_a``, stage B to
    ``device_b``; the crop buffer crosses between them (NVLink between
    the GPUs of one host).

    ``__call__`` takes a sequence of frame batches (microbatches) and
    returns one ``PipelineOut`` per batch. Dispatch order interleaves the
    stages — A(i+1) is enqueued before B(i) is fenced — so the two device
    groups run concurrently; no result is materialized until the caller
    reads it.
    """

    def __init__(self, spec: NetworkSpec, yolo_params, yolo_state,
                 rekt_params, rekt_state, device_a, device_b,
                 conf_thresh: float = 0.8, nms_thresh: float = 0.25,
                 max_det: int = 16, crop_size: int = 80,
                 crop_capacity: int = 64):
        self._spec = spec
        self._dev_a, self._dev_b = device_a, device_b
        self._yolo = (jax.device_put(yolo_params, device_a),
                      jax.device_put(yolo_state, device_a))
        self._rekt = (jax.device_put(rekt_params, device_b),
                      jax.device_put(rekt_state, device_b))
        self._cfg = dict(conf_thresh=conf_thresh, nms_thresh=nms_thresh,
                         max_det=max_det, crop_size=crop_size,
                         crop_capacity=crop_capacity)

    def _a(self, frames) -> StageAOut:
        return detect_stage(self._spec, *self._yolo,
                            jax.device_put(frames, self._dev_a), **self._cfg)

    def _b(self, a: StageAOut) -> PipelineOut:
        return keypoint_stage(*self._rekt,
                              jax.device_put(a, self._dev_b))

    def __call__(self, frame_batches: Sequence) -> list:
        outs, pending = [], None
        for fr in frame_batches:
            a = self._a(fr)          # dispatch A(i) — returns immediately
            if pending is not None:
                outs.append(self._b(pending))  # B(i-1) overlaps A(i)
            pending = a
        if pending is not None:
            outs.append(self._b(pending))
        return outs
