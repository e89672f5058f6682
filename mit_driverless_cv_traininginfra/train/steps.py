"""Jitted train/eval steps for both model families, DP-sharded over the mesh.

The reference's hot loop (CVC-YOLOv3/train.py:49-93 run_epoch;
RektNet/train_eval.py:52-85) does forward → backward → step with per-step
``.item()`` logging syncs. Here each step is ONE jitted SPMD program:

- inputs arrive sharded on the ``data`` mesh axis, params replicated;
- XLA inserts the gradient all-reduce (psum) during backward;
- loss components come back as a single small array — one host sync per
  logging interval, not six per step.

BatchNorm under DP: batch statistics are computed over the *global* batch
(jnp.mean over a sharded axis lowers to a mesh all-reduce), which is
strictly better than the reference's per-replica stats under DataParallel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from mit_driverless_cv_traininginfra.config.darknet_cfg import NetworkSpec
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.cross_ratio_loss import cross_ratio_loss
from mit_driverless_cv_traininginfra.models.darknet import forward_features
from mit_driverless_cv_traininginfra.models.yolo_loss import yolo_loss


class TrainState(NamedTuple):
    params: dict
    model_state: dict  # BN running stats
    opt_state: tuple
    step: jnp.ndarray


def init_train_state(params, model_state, tx) -> TrainState:
    return TrainState(params, model_state, tx.init(params), jnp.zeros((), jnp.int32))


# ---------------------------------------------------------------------------
# YOLO
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("spec", "tx", "xy_loss", "wh_loss", "object_loss",
                     "no_object_loss", "compute_dtype", "packed_stem"),
    donate_argnames=("ts",),
)
def yolo_train_step(
    spec: NetworkSpec,
    tx,
    ts: TrainState,
    images,
    targets,
    xy_loss: float = 2.0,
    wh_loss: float = 1.6,
    object_loss: float = 0.1,
    no_object_loss: float = 25.0,
    compute_dtype: str = "float32",
    packed_stem: bool = False,
):
    """One DP train step. images (B, H, W, C) in [0,1]; targets (B, T, 5).

    ``compute_dtype="bfloat16"`` runs the conv forward/backward in bf16
    (mixed precision: f32 master weights and optimizer state, f32 BN
    statistics, f32 loss — the standard mixed-precision recipe).
    ``packed_stem=True`` trains blocks 0–1 through the exact space-to-
    depth rewrite (live BN; darknet._packed_stem_train) — the 3-channel
    conv1 is the step's one layout-bound stage (PERF.md roofline); only
    valid when ``stem_is_packable(spec)``."""
    cdt = jnp.dtype(compute_dtype)

    def loss_fn(params):
        p = jax.tree_util.tree_map(lambda v: v.astype(cdt), params) \
            if cdt != jnp.float32 else params
        heads, new_state = forward_features(spec, p, ts.model_state,
                                            images.astype(cdt), train=True,
                                            train_packed_stem=packed_stem)
        heads = [h.astype(jnp.float32) for h in heads]
        loss, comps = yolo_loss(spec, heads, targets, xy_loss, wh_loss,
                                object_loss, no_object_loss)
        return loss, (comps, new_state)

    (loss, (comps, new_state)), grads = jax.value_and_grad(loss_fn, has_aux=True)(ts.params)
    updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
    params = optax.apply_updates(ts.params, updates)
    return TrainState(params, new_state, opt_state, ts.step + 1), loss, comps


@functools.partial(
    jax.jit,
    static_argnames=("spec", "xy_loss", "wh_loss", "object_loss", "no_object_loss"),
)
def yolo_eval_step(
    spec: NetworkSpec,
    params,
    model_state,
    images,
    targets,
    xy_loss: float = 2.0,
    wh_loss: float = 1.6,
    object_loss: float = 0.1,
    no_object_loss: float = 25.0,
):
    heads, _ = forward_features(spec, params, model_state, images, train=False)
    return yolo_loss(spec, heads, targets, xy_loss, wh_loss, object_loss, no_object_loss)


@functools.partial(
    jax.jit,
    static_argnames=("spec", "tx", "xy_loss", "wh_loss", "object_loss",
                     "no_object_loss", "compute_dtype", "augment_affine",
                     "lr_flip", "jitter", "noise", "packed_stem"),
    donate_argnames=("ts",),
)
def yolo_train_step_device_aug(
    spec: NetworkSpec,
    tx,
    ts: TrainState,
    images,
    labels_px,
    key,
    xy_loss: float = 2.0,
    wh_loss: float = 1.6,
    object_loss: float = 0.1,
    no_object_loss: float = 25.0,
    compute_dtype: str = "float32",
    augment_affine: bool = False,
    lr_flip: bool = True,
    jitter: bool = True,
    noise: bool = False,
    packed_stem: bool = False,
):
    """Train step with ON-DEVICE augmentation fused in front of the model:
    the host ships raw letterboxed/patched images and pixel-corner labels
    (ImageLabelDataset(device_aug=True)); augment_batch + the xywh
    normalisation run inside this jit, so augmentation parallelises over
    the DP mesh and overlaps the previous step's epilogue.

    ``augment_affine`` defaults OFF here: the on-device warp is a full-image
    gather while PIL's host warp is C-speed, so the
    hybrid split (host affine, device photometric) is the fast default."""
    from mit_driverless_cv_traininginfra.ops.device_aug import augment_batch

    cdt = jnp.dtype(compute_dtype)
    B, H, W, _ = images.shape
    images, labels_px = augment_batch(key, images, labels_px,
                                      augment_affine=augment_affine,
                                      lr_flip=lr_flip, jitter=jitter,
                                      noise=noise)
    valid = jnp.sum(labels_px, axis=-1, keepdims=True) > 0
    x1, y1 = labels_px[..., 1], labels_px[..., 2]
    x2, y2 = labels_px[..., 3], labels_px[..., 4]
    targets = jnp.stack([
        labels_px[..., 0],
        (x1 + x2) / 2 / W,
        (y1 + y2) / 2 / H,
        jnp.abs(x2 - x1) / W,
        jnp.abs(y2 - y1) / H,
    ], axis=-1)
    targets = jnp.where(valid, targets, 0.0)

    def loss_fn(params):
        p = jax.tree_util.tree_map(lambda v: v.astype(cdt), params) \
            if cdt != jnp.float32 else params
        heads, new_state = forward_features(spec, p, ts.model_state,
                                            images.astype(cdt), train=True,
                                            train_packed_stem=packed_stem)
        heads = [h.astype(jnp.float32) for h in heads]
        loss, comps = yolo_loss(spec, heads, targets, xy_loss, wh_loss,
                                object_loss, no_object_loss)
        return loss, (comps, new_state)

    (loss, (comps, new_state)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(ts.params)
    updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
    params = optax.apply_updates(ts.params, updates)
    return TrainState(params, new_state, opt_state, ts.step + 1), loss, comps


# ---------------------------------------------------------------------------
# RektNet
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("tx", "loss_type", "include_geo", "cross_batch",
                     "compute_dtype", "synth_target_sigma"),
    donate_argnames=("ts",),
)
def rektnet_train_step(
    tx,
    ts: TrainState,
    images,
    target_hm,
    target_points,
    loss_type: str = "l1_softargmax",
    include_geo: bool = True,
    geo_loss_gamma_horz: float = 0.0,
    geo_loss_gamma_vert: float = 0.0,
    cross_batch: bool = True,
    compute_dtype: str = "float32",
    synth_target_sigma: float = 0.0,
):
    """One DP train step (train_eval.py:52-85 semantics).

    ``synth_target_sigma > 0`` ignores ``target_hm`` and synthesises the
    heatmap targets ON DEVICE as unit-sum gaussians around
    ``target_points`` (ops.heatmap.gaussian_heatmaps) — the host then only
    ships 7 points per crop instead of 7 full heatmaps."""
    cdt = jnp.dtype(compute_dtype)
    if synth_target_sigma > 0:
        from mit_driverless_cv_traininginfra.ops.heatmap import (
            gaussian_heatmaps,
        )

        h, w = images.shape[1], images.shape[2]
        target_hm = gaussian_heatmaps(target_points, h, w,
                                      sigma=synth_target_sigma)

    def loss_fn(params):
        p = jax.tree_util.tree_map(lambda v: v.astype(cdt), params) \
            if cdt != jnp.float32 else params
        hm, pts, new_state = rektnet.apply(p, ts.model_state,
                                           images.astype(cdt), train=True)
        hm = hm.astype(jnp.float32)
        pts = pts.astype(jnp.float32)
        loc, geo, total = cross_ratio_loss(
            hm, pts, target_hm, target_points, loss_type=loss_type,
            include_geo=include_geo, geo_loss_gamma_horz=geo_loss_gamma_horz,
            geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch,
        )
        return total, (loc, geo, new_state)

    (total, (loc, geo, new_state)), grads = jax.value_and_grad(loss_fn, has_aux=True)(ts.params)
    updates, opt_state = tx.update(grads, ts.opt_state, ts.params)
    params = optax.apply_updates(ts.params, updates)
    return TrainState(params, new_state, opt_state, ts.step + 1), total, loc, geo


@functools.partial(jax.jit, static_argnames=("loss_type", "include_geo", "cross_batch"))
def rektnet_eval_step(
    params,
    model_state,
    images,
    target_hm,
    target_points,
    loss_type: str = "l1_softargmax",
    include_geo: bool = True,
    geo_loss_gamma_horz: float = 0.0,
    geo_loss_gamma_vert: float = 0.0,
    cross_batch: bool = True,
):
    hm, pts, _ = rektnet.apply(params, model_state, images, train=False)
    loc, geo, total = cross_ratio_loss(
        hm, pts, target_hm, target_points, loss_type=loss_type,
        include_geo=include_geo, geo_loss_gamma_horz=geo_loss_gamma_horz,
        geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch,
    )
    return total, loc, geo, pts
