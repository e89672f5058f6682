"""On-device (XLA) batched augmentation — the replacement for the
reference's per-sample PIL/imgaug work in DataLoader processes
(utils/datasets.py:225-295).

The BASELINE north star calls for the custom dataloader to run "as on-device
XLA preprocessing feeding HBM with async prefetch": the host (1 CPU core in
this environment!) only decodes and letterboxes; geometric + photometric
augmentation runs inside the jitted train step, batched and
``jax.random``-keyed, so it parallelises over the DP mesh for free and is
deterministic per seed.

Ops (distributions match the reference's sampling ranges):
- random affine: angle ±10°, translate ±40 px, scale 0.9–1.1, shear ±3°
  (utils/datasets.py:232-236) — inverse-map bilinear warp with grey fill via
  the same hat-matrix/matmul resampler family as the ROI crop, plus the
  exact label-rewarp homography (affine_labels, :317-382);
- random LR flip (p=0.5);
- brightness/contrast/saturation jitter ±0.25 (ColorJitter approximation in
  RGB; the reference's PIL hue jitter ±0.04 is omitted on-device);
- additive gaussian noise, scale U(0, 0.03).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

GREY = 127.0 / 255.0


def _affine_matrices(key, B: int, angle_deg: float = 10.0,
                     translate_px: float = 40.0, scale_lo: float = 0.9,
                     scale_hi: float = 1.1, shear_deg: float = 3.0,
                     h: int = 416, w: int = 416):
    """Sample per-image forward label homographies M = S·T·R
    (utils/datasets.py:330-352 math) and their inverses for the image warp.
    Returns (M (B,3,3), M_inv (B,3,3), angles (B,))."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    ang = jax.random.uniform(k1, (B,), minval=-angle_deg, maxval=angle_deg)
    tx = jax.random.uniform(k2, (B,), minval=-translate_px, maxval=translate_px)
    ty = jax.random.uniform(k3, (B,), minval=-translate_px, maxval=translate_px)
    sc = jax.random.uniform(k4, (B,), minval=scale_lo, maxval=scale_hi)
    sh = jax.random.uniform(k5, (B,), minval=-shear_deg, maxval=shear_deg)

    rad = jnp.deg2rad(ang)
    alpha = sc * jnp.cos(rad)
    beta = sc * jnp.sin(rad)
    zeros = jnp.zeros_like(alpha)
    ones = jnp.ones_like(alpha)
    R = jnp.stack([
        jnp.stack([alpha, beta, (1 - alpha) * (w / 2.0) - beta * (h / 2.0)], -1),
        jnp.stack([-beta, alpha, (beta * w / 2.0) + (1 - alpha) * (h / 2.0)], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], axis=1)
    T = jnp.tile(jnp.eye(3)[None], (B, 1, 1))
    T = T.at[:, 0, 2].set(tx).at[:, 1, 2].set(ty)
    tan = jnp.tan(jnp.deg2rad(sh))
    S = jnp.tile(jnp.eye(3)[None], (B, 1, 1))
    S = S.at[:, 0, 1].set(tan).at[:, 0, 2].set(-tan * h / 2.0)
    M = S @ T @ R
    return M, jnp.linalg.inv(M), ang


def _warp_bilinear(images, M_inv, fill: float = GREY):
    """Inverse-map bilinear warp (B, H, W, C) with constant fill.

    Coordinate math runs in f32 regardless of the image dtype: bf16
    training pools (the mixed-precision default) would otherwise build a coordinate
    grid that cannot represent odd pixel indices ≥ 257 (bf16 ulp 2.0 above
    256 — the ops/image.py crop-coords bug class). Only the [0,1]
    interpolation weights are cast to the image dtype for the blend."""
    B, H, W, C = images.shape
    ys = jnp.arange(H, dtype=jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")  # (H, W)
    ones = jnp.ones_like(gx)
    pts = jnp.stack([gx, gy, ones], axis=-1).reshape(1, H * W, 3)
    src = jnp.einsum("bij,bpj->bpi", M_inv.astype(jnp.float32), pts)
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0

    def sample(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = jnp.clip(yi, 0, H - 1).astype(jnp.int32)
        xc = jnp.clip(xi, 0, W - 1).astype(jnp.int32)
        flat = images.reshape(B, H * W, C)
        vals = jnp.take_along_axis(flat, (yc * W + xc)[..., None], axis=1)
        return jnp.where(inb[..., None], vals, jnp.asarray(fill, images.dtype))

    def wgt(v):
        return v.astype(images.dtype)[..., None]

    out = (sample(y0, x0) * wgt((1 - fy) * (1 - fx))
           + sample(y0, x0 + 1) * wgt((1 - fy) * fx)
           + sample(y0 + 1, x0) * wgt(fy * (1 - fx))
           + sample(y0 + 1, x0 + 1) * wgt(fy * fx))
    return out.reshape(B, H, W, C)


def _affine_labels_batch(labels, M, angles, h: int, w: int):
    """jax port of the reference label rewarp (utils/datasets.py:317-382):
    warp all 4 corners through M, take the enclosing box, apply the
    angle-based shrink, clamp, update only non-degenerate boxes.

    Reference quirk (same as data/augment.affine_labels): boxes that FAIL
    the degeneracy filter are retained at their PRE-warp coordinates
    (``jnp.where(keep, boxes, pts)`` mirrors the reference's
    ``targets[i, 1:5] = xy[i]`` for survivors only) — a warped-out box
    keeps pointing at where the object was. Don't "fix" to zero rows.

    labels: (B, T, 5) [c, x1, y1, x2, y2] in pixels; zero rows preserved."""
    B, T, _ = labels.shape
    height = max(w, h)
    pts = labels[..., 1:5]
    area0 = (pts[..., 2] - pts[..., 0]) * (pts[..., 3] - pts[..., 1])

    corners = jnp.stack([
        pts[..., 0], pts[..., 1],
        pts[..., 2], pts[..., 3],
        pts[..., 0], pts[..., 3],
        pts[..., 2], pts[..., 1],
    ], axis=-1).reshape(B, T * 4, 2)
    ones = jnp.ones((B, T * 4, 1), labels.dtype)
    xy = jnp.concatenate([corners, ones], axis=-1)
    warped = jnp.einsum("bij,bpj->bpi", M.astype(labels.dtype), xy)
    warped = (warped[..., :2] / warped[..., 2:3]).reshape(B, T, 4, 2)

    x = warped[..., 0]
    y = warped[..., 1]
    boxes = jnp.stack([x.min(-1), y.min(-1), x.max(-1), y.max(-1)], axis=-1)

    rad = jnp.deg2rad(angles)[:, None]
    reduction = jnp.maximum(jnp.abs(jnp.sin(rad)), jnp.abs(jnp.cos(rad))) ** 0.5
    cx = (boxes[..., 2] + boxes[..., 0]) / 2
    cy = (boxes[..., 3] + boxes[..., 1]) / 2
    bw = (boxes[..., 2] - boxes[..., 0]) * reduction
    bh = (boxes[..., 3] - boxes[..., 1]) * reduction
    boxes = jnp.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    boxes = jnp.clip(boxes, 0, height)

    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    area = bw * bh
    ar = jnp.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = (bw > 4) & (bh > 4) & (area / (area0 + 1e-16) > 0.1) & (ar < 10)

    new_pts = jnp.where(keep[..., None], boxes, pts)
    return jnp.concatenate([labels[..., 0:1], new_pts], axis=-1)


@functools.partial(jax.jit, static_argnames=("augment_affine", "lr_flip",
                                             "jitter", "noise"))
def augment_batch(key, images, labels,
                  augment_affine: bool = True, lr_flip: bool = True,
                  jitter: bool = True, noise: bool = False):
    """Batched on-device augmentation.

    images: (B, H, W, C) in [0,1]; labels (B, T, 5) [c, x1, y1, x2, y2] in
    PIXELS of the image (corner format, pre-normalisation — the host
    dataset defers its xywh normalisation when device_aug is on).
    Returns (images, labels) with the same shapes/units.
    """
    B, H, W, C = images.shape
    k_aff, k_flip, k_j1, k_j2, k_j3, k_ns, k_nv = jax.random.split(key, 7)

    if augment_affine:
        M, M_inv, ang = _affine_matrices(k_aff, B, h=H, w=W)
        images = _warp_bilinear(images, M_inv)
        labels = _affine_labels_batch(labels, M, ang, H, W)

    if lr_flip:
        do = jax.random.bernoulli(k_flip, 0.5, (B,))
        flipped = images[:, :, ::-1, :]
        images = jnp.where(do[:, None, None, None], flipped, images)
        valid = jnp.sum(labels, axis=-1, keepdims=True) > 0
        fl = jnp.stack([
            labels[..., 0],
            W - labels[..., 3],
            labels[..., 2],
            W - labels[..., 1],
            labels[..., 4],
        ], axis=-1)
        labels = jnp.where(do[:, None, None] & valid, fl, labels)

    if jitter:
        b = jax.random.uniform(k_j1, (B, 1, 1, 1), minval=0.75, maxval=1.25)
        c = jax.random.uniform(k_j2, (B, 1, 1, 1), minval=0.75, maxval=1.25)
        s = jax.random.uniform(k_j3, (B, 1, 1, 1), minval=0.75, maxval=1.25)
        images = images * b
        mean = jnp.mean(images, axis=(1, 2, 3), keepdims=True)
        images = (images - mean) * c + mean
        grey = jnp.mean(images, axis=-1, keepdims=True)
        images = (images - grey) * s + grey
        images = jnp.clip(images, 0.0, 1.0)

    if noise:
        scale = jax.random.uniform(k_ns, (B, 1, 1, 1), maxval=0.03)
        images = jnp.clip(
            images + jax.random.normal(k_nv, images.shape) * scale, 0.0, 1.0)

    return images, labels
