"""Augmentation suite — self-contained numpy/PIL/cv2 implementations.

Capability parity with the reference's augmentation stack
(utils/datasets.py:225-295 + affine_labels :317-382), which leaned on
torchvision ColorJitter and imgaug (GaussianBlur / AdditiveGaussianNoise /
SigmoidContrast / Sharpen). Neither library is a dependency here; each op is
implemented directly with the same sampling distributions and flag gates, so
datasets augment identically in distribution.

The affine label rewarp reproduces the reference's homography math exactly
(rotation-scale about centre, translation, shear-about-centre, composed
S·T·R), including the angle-based box shrink and the degenerate-box
rejection rules (w,h > 4px, area ratio > 0.1, aspect < 10).
"""

from __future__ import annotations

import math
import random
from typing import TYPE_CHECKING, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

if TYPE_CHECKING:  # PIL is imported where it is used
    from PIL import Image


# ---------------------------------------------------------------------------
# colour jitter (torchvision ColorJitter(brightness=.25, contrast=.25,
# saturation=.25, hue=.04) semantics on PIL images)
# ---------------------------------------------------------------------------

def color_jitter(
    img: Image.Image,
    rng: random.Random,
    brightness: float = 0.25,
    contrast: float = 0.25,
    saturation: float = 0.25,
    hue: float = 0.04,
) -> Image.Image:
    """Random-order brightness/contrast/saturation/hue jitter with uniform
    factors, PIL backend (matches torchvision's PIL path)."""
    from PIL import Image, ImageEnhance

    ops = []
    if brightness:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue:
        h = rng.uniform(-hue, hue)

        def hue_shift(im: Image.Image) -> Image.Image:
            hsv = np.array(im.convert("HSV"), dtype=np.uint8)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")

        ops.append(hue_shift)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


# ---------------------------------------------------------------------------
# affine warp (image + label rewarp)
# ---------------------------------------------------------------------------

def _affine_matrix(w: float, h: float, angle: float, translate, scale: float,
                   shear: Tuple[float, float]) -> np.ndarray:
    """Forward 3×3 homography: shear(about centre) @ translate @
    rotate-scale(about centre) — the reference's ``M = S @ T @ R``
    (utils/datasets.py:330-352)."""
    alpha = scale * math.cos(math.radians(angle))
    beta = scale * math.sin(math.radians(angle))
    R = np.array(
        [
            [alpha, beta, (1 - alpha) * (w / 2.0) - beta * (h / 2.0)],
            [-beta, alpha, (beta * w / 2.0) + (1 - alpha) * (h / 2.0)],
            [0, 0, 1],
        ],
        dtype=np.float64,
    )
    T = np.eye(3)
    T[0, 2], T[1, 2] = translate[0], translate[1]
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(shear[0]))
    S[0, 2] = -math.tan(math.radians(shear[0])) * h / 2.0
    S[1, 0] = math.tan(math.radians(shear[1]))
    S[1, 2] = -math.tan(math.radians(shear[1])) * w / 2.0
    return S @ T @ R


def affine_image(img: Image.Image, angle: float, translate, scale: float,
                 shear: float, fill=(127, 127, 127)) -> Image.Image:
    """Warp the image with the forward matrix of the *label* transform's
    inverse parameterisation — the reference warps the image with
    torchvision ``F.affine(angle, translate, scale, shear)`` and the labels
    with ``affine_labels(..., -angle, translate, scale, (-shear, 0))``
    (utils/datasets.py:236-239). Warping the image by the inverse of the
    label matrix keeps the pair consistent without depending on
    torchvision's matrix conventions."""
    from PIL import Image

    w, h = img.size
    M = _affine_matrix(w, h, -angle, translate, scale, (-shear, 0))
    Minv = np.linalg.inv(M)
    # PIL's transform takes the inverse (output→input) map's first 2 rows.
    coeffs = Minv[:2].ravel()
    return img.transform((w, h), Image.AFFINE, tuple(coeffs),
                         resample=Image.BILINEAR, fillcolor=fill)


def affine_labels(h: int, w: int, targets: np.ndarray, angle: float = 0,
                  translate=(0, 0), scale: float = 1.0,
                  shear: Tuple[float, float] = (0, 0)) -> np.ndarray:
    """Rewarp (N,5) [c,x1,y1,x2,y2] labels through the homography
    (utils/datasets.py:317-382): warp all 4 corners, take the enclosing box,
    apply the angle-based reduction, clamp to [0, max(w,h)], and update only
    non-degenerate boxes (w,h > 4, area ratio > 0.1, aspect < 10).

    Reference quirk: boxes that FAIL the degeneracy filter are NOT dropped —
    they are retained with their original pre-warp coordinates
    (``targets[i, 1:5] = xy[i]`` only for survivors, utils/datasets.py:382),
    so a rejected box keeps pointing at where the object was before the
    warp. Do not "fix" this to drop rejected rows on parity paths."""
    targets = np.asarray(targets, np.float32).copy()
    height = max(w, h)
    M = _affine_matrix(w, h, angle, translate, scale, shear)

    n = targets.shape[0]
    if n == 0:
        return targets
    points = targets[:, 1:5]
    area0 = (points[:, 2] - points[:, 0]) * (points[:, 3] - points[:, 1])

    xy = np.ones((n * 4, 3), np.float64)
    xy[:, :2] = points[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3]).reshape(n, 8)

    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)

    radians = angle * math.pi / 180
    reduction = max(abs(math.sin(radians)), abs(math.cos(radians))) ** 0.5
    cx = (boxes[:, 2] + boxes[:, 0]) / 2
    cy = (boxes[:, 3] + boxes[:, 1]) / 2
    bw = (boxes[:, 2] - boxes[:, 0]) * reduction
    bh = (boxes[:, 3] - boxes[:, 1]) * reduction
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=1)

    boxes = np.clip(boxes, 0, height)
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    area = bw * bh
    ar = np.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = (bw > 4) & (bh > 4) & (area / (area0 + 1e-16) > 0.1) & (ar < 10)

    targets[keep, 1:5] = boxes[keep]
    return targets


# ---------------------------------------------------------------------------
# pixel-level augs (imgaug-equivalent formulas)
# ---------------------------------------------------------------------------

def gaussian_blur(arr: np.ndarray, sigma: float) -> np.ndarray:
    """imgaug GaussianBlur(sigma): no-op for sigma≈0."""
    if sigma <= 1e-3:
        return arr
    return cv2.GaussianBlur(arr, (0, 0), sigmaX=sigma)


def additive_gaussian_noise(arr: np.ndarray, scale: float, rng: np.random.Generator,
                            per_channel_p: float = 0.5) -> np.ndarray:
    """imgaug AdditiveGaussianNoise(loc=0, scale, per_channel=0.5): with
    probability ``per_channel_p`` sample noise per channel, else one plane
    broadcast across channels."""
    h, w, c = arr.shape
    if rng.uniform() < per_channel_p:
        noise = rng.normal(0.0, scale, size=(h, w, c))
    else:
        noise = rng.normal(0.0, scale, size=(h, w, 1))
    return np.clip(arr.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def sigmoid_contrast(arr: np.ndarray, gain: float, cutoff: float) -> np.ndarray:
    """imgaug SigmoidContrast: I' = 255 / (1 + exp(gain·(cutoff − I/255)))."""
    x = arr.astype(np.float32) / 255.0
    out = 1.0 / (1.0 + np.exp(gain * (cutoff - x)))
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def sharpen(arr: np.ndarray, alpha: float, lightness: float = 1.0) -> np.ndarray:
    """imgaug Sharpen(alpha): blend identity with the sharpening kernel
    [[-1,-1,-1],[-1,8+lightness,-1],[-1,-1,-1]].

    lightness defaults to 1.0 deliberately: the reference pins
    ``imgaug==0.3.0`` (CVC-YOLOv3/requirements.txt:8), whose
    ``Sharpen(alpha, lightness=1)`` is a fixed scalar — the stochastic
    range default (0.75, 2.0) only appeared in imgaug 0.4.0, which the
    reference never ran. Keep 1.0 for parity."""
    kernel = np.array(
        [[-1, -1, -1], [-1, 8 + lightness, -1], [-1, -1, -1]], np.float32
    )
    sharp = cv2.filter2D(arr.astype(np.float32), -1, kernel)
    out = (1 - alpha) * arr.astype(np.float32) + alpha * sharp
    return np.clip(out, 0, 255).astype(np.uint8)
