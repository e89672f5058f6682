"""Keypoint heatmap target synthesis + keypoint metrics.

Host-side parity with ``RektNet/utils.py:73-111`` (prep_image/prep_label/
get_scale/scale_labels) using cv2 — the reference builds targets with
cv2.resize + 5×5 GaussianBlur of a one-hot image, and bit-parity requires the
same resamplers. A pure-JAX on-device variant (:func:`gaussian_heatmaps`)
is provided for the high-throughput training path where the target can be
synthesised on-chip from the keypoint coordinates directly.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is baked into this image
    cv2 = None

import jax.numpy as jnp


def prep_image(image: np.ndarray, target_image_size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize to target size (RektNet/utils.py:73-76)."""
    return cv2.resize(image, target_image_size)


def prep_label(
    label: np.ndarray,
    target_image_size: Tuple[int, int],
    orig_image_size: Tuple[int, ...],
    image_path: str = "",
) -> np.ndarray:
    """One-hot at the GT pixel in original resolution → cv2.resize →
    5×5 GaussianBlur → normalise to sum 1 (RektNet/utils.py:83-96)."""
    hm = np.zeros((label.shape[0], target_image_size[0], target_image_size[1]))
    for i in range(label.shape[0]):
        row = label[i]
        hm_tmp = np.zeros((orig_image_size[0], orig_image_size[1]))
        hm_tmp[int(row[1]), int(row[0])] = 1.0
        hm[i] = cv2.resize(hm_tmp, target_image_size)
        hm[i] = cv2.GaussianBlur(hm[i], (5, 5), 0)
        s = hm[i].sum()
        if s == 0:
            print(
                "Incorrect Data Label Detected! Please revise the image label "
                f"below and becoming the one with data!\n{image_path}"
            )
            continue
        hm[i] /= s
    return hm


def get_scale(actual_image_size, target_image_size):
    """(h_scale, w_scale) (RektNet/utils.py:98-103)."""
    target_h, target_w = target_image_size
    return target_h / actual_image_size[0], target_w / actual_image_size[1]


def scale_keypoints(labels, h_scale: float, w_scale: float) -> np.ndarray:
    """Ceil-scaled integer keypoints (RektNet/utils.py:105-111 scale_labels)."""
    out = []
    for pt in np.asarray(labels):
        out.append([math.ceil(int(pt[0]) * w_scale), math.ceil(int(pt[1]) * h_scale)])
    return np.asarray(out)


def gaussian_heatmaps(points, height: int, width: int, sigma: float = 1.0):
    """On-device target synthesis: unit-sum Gaussians centred on ``points``.

    points: (..., K, 2) xy in [0,1] (same convention as soft_argmax output).
    Returns (..., K, H, W). This is the on-device target path: no host
    round-trip, fully fused by XLA, and differentiable if ever needed.
    """
    points = jnp.asarray(points)
    ys = jnp.arange(height, dtype=points.dtype)
    xs = jnp.arange(width, dtype=points.dtype)
    py = points[..., 1:2] * height  # (..., K, 1)
    px = points[..., 0:1] * width
    dy2 = (ys[None, :] - py) ** 2  # (..., K, H)
    dx2 = (xs[None, :] - px) ** 2  # (..., K, W)
    g = jnp.exp(-(dy2[..., :, None] + dx2[..., None, :]) / (2.0 * sigma**2))
    norm = jnp.sum(g, axis=(-1, -2), keepdims=True)
    return g / jnp.maximum(norm, 1e-12)


# ---------------------------------------------------------------------------
# keypoint distance metrics (RektNet/utils.py:239-287)
# ---------------------------------------------------------------------------

KPT_NAMES: Sequence[str] = (
    "top", "mid_L_top", "mid_R_top", "mid_L_bot", "mid_R_bot", "bot_L", "bot_R",
)


def keypoint_l2_distances(target_points, pred_points):
    """Per-keypoint euclidean distance, batched: (..., K, 2) → (..., K).
    Vectorised form of the reference's per-sample ``calculate_distance``."""
    t = jnp.asarray(target_points)
    p = jnp.asarray(pred_points)
    return jnp.sqrt(jnp.sum((t - p) ** 2, axis=-1))


def keypoint_distance_summary(distances):
    """(mean per kpt, total of means, std per kpt) over the batch axis —
    mirrors ``calculate_mean_distance`` (RektNet/utils.py:244-287)."""
    d = np.asarray(distances)
    means = d.mean(axis=0)
    stds = d.std(axis=0)
    return means, float(means.sum()), stds
