"""Convergence smoke tests: the full training stack must actually *learn*
on easy synthetic data (catches sign/assignment/decode errors that shape
tests cannot)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import detections, init_params
from mit_driverless_cv_traininginfra.ops.heatmap import gaussian_heatmaps
from mit_driverless_cv_traininginfra.ops.metrics import (
    evaluate_image_batch,
    summarize,
)
from mit_driverless_cv_traininginfra.train.optim import make_optimizer
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    rektnet_train_step,
    yolo_train_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _bright_square_batch(rng, B, size=64):
    """Dark frames with one bright square; labels in normalised xywh."""
    imgs = rng.uniform(0.0, 0.1, (B, size, size, 3)).astype(np.float32)
    targets = np.zeros((B, 1, 5), np.float32)
    for b in range(B):
        w = h = int(rng.integers(12, 20))
        x0 = int(rng.integers(4, size - w - 4))
        y0 = int(rng.integers(4, size - h - 4))
        imgs[b, y0:y0 + h, x0:x0 + w] = rng.uniform(0.8, 1.0)
        targets[b, 0] = [0, (x0 + w / 2) / size, (y0 + h / 2) / size,
                         w / size, h / size]
    return jnp.asarray(imgs), jnp.asarray(targets)


@pytest.mark.slow
def test_yolo_learns_bright_squares():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    tx = make_optimizer("Adam", lr=5e-4)
    ts = init_train_state(params, mstate, tx)
    rng = np.random.default_rng(0)

    losses = []
    for step in range(150):
        imgs, targets = _bright_square_batch(rng, 8)
        ts, loss, _ = yolo_train_step(spec, tx, ts, imgs, targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])

    # detection quality on fresh data: mAP must clear zero decisively
    imgs, targets = _bright_square_batch(rng, 8)
    dets = detections(spec, ts.params, ts.model_state, imgs)
    ev = evaluate_image_batch(dets, targets, 64, 64, conf_thresh=0.5,
                              nms_thresh=0.25, iou_thresh=0.5, top_k=16)
    mAP, mR, mP = summarize(ev)
    # 150 steps from scratch: localisation is learned (recall well above
    # chance); precision keeps rising with more steps
    assert mR > 0.4 and mAP > 0.1, (mAP, mR, mP)


@pytest.mark.slow
def test_rektnet_learns_fixed_keypoints():
    """Crops rendered with bright dots at the 7 keypoint locations; the
    net must drive the point error well below the initial ~uniform guess."""
    params, mstate = rektnet.init(jax.random.PRNGKey(1))
    tx = make_optimizer("Adam", lr=1e-2)
    ts = init_train_state(params, mstate, tx)
    rng = np.random.default_rng(1)

    def batch(B=8):
        imgs = rng.uniform(0, 0.1, (B, 80, 80, 3)).astype(np.float32)
        pts = rng.uniform(0.15, 0.85, (B, 7, 2)).astype(np.float32)
        for b in range(B):
            for k in range(7):
                x, y = int(pts[b, k, 0] * 80), int(pts[b, k, 1] * 80)
                # intensity-coded dots so each keypoint is unambiguous
                level = 0.4 + 0.6 * (k + 1) / 7
                imgs[b, max(0, y - 1):y + 2, max(0, x - 1):x + 2, :] = level
        hm = np.asarray(gaussian_heatmaps(jnp.asarray(pts), 80, 80, sigma=1.5),
                        np.float32)
        return jnp.asarray(imgs), jnp.asarray(hm), jnp.asarray(pts)

    imgs0, hm0, pts0 = batch()
    _, _, err0 = _eval_err(ts, imgs0, pts0)
    for step in range(100):
        imgs, hm, pts = batch()
        ts, total, loc, geo = rektnet_train_step(
            tx, ts, imgs, hm, pts, loss_type="l1_softargmax", include_geo=False)
    imgs1, hm1, pts1 = batch()
    _, _, err1 = _eval_err(ts, imgs1, pts1)
    assert err1 < err0 * 0.75, (err0, err1)


def _eval_err(ts, imgs, pts):
    _, pred, _ = rektnet.apply(ts.params, ts.model_state, imgs)
    err = float(jnp.mean(jnp.linalg.norm(pred - pts, axis=-1)))
    return pred, pts, err
