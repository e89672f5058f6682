"""On-device image preprocessing: letterbox, resize, ROI crops.

The reference does all of this on the host with PIL/cv2 inside DataLoader
workers (detect.py:62-75, utils/datasets.py:143-164). Here the hot path is
XLA: pad/resize/crop run on-chip so inference feeds straight from raw frames
in HBM with no host round-trip — that, plus the fixed-capacity ROI gather,
is what lets the two-stage detect→crop→keypoints pipeline stay compiled
end-to-end.

cv2/PIL parity notes: ``resize_bilinear`` uses half-pixel-centre sampling,
matching ``cv2.resize(INTER_LINEAR)``; PIL's antialiased downscale differs —
the host loaders keep PIL semantics for training parity, the device path is
for serving/bench throughput.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

GREY = 127.0 / 255.0  # the reference's pad fill (127,127,127) in [0,1] scale


def pad_to(x, pad_h: int, pad_w: int, fill: float = GREY):
    """Symmetric constant pad NHWC/HWC on both sides (torchvision F.pad with
    padding=(w,h,w,h) semantics)."""
    cfg = [(pad_h, pad_h), (pad_w, pad_w), (0, 0)]
    if x.ndim == 4:
        cfg = [(0, 0)] + cfg
    return jnp.pad(x, cfg, constant_values=fill)


def resize_bilinear(x, out_h: int, out_w: int):
    """Half-pixel-centre bilinear resize (cv2.INTER_LINEAR semantics), NHWC
    or HWC."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    b, h, w, c = x.shape
    out = jax.image.resize(x, (b, out_h, out_w, c), method="linear")
    return out if batched else out[0]


def letterbox(x, out_h: int, out_w: int, fill: float = GREY):
    """Pad-to-aspect then resize (detect.py:64-67 + calculate_padding).

    Static-shape variant: input shape must be known at trace time. Returns
    (image, (pad_h, pad_w, ratio)) where ratio maps original→output pixels.
    """
    h, w = (x.shape[1], x.shape[2]) if x.ndim == 4 else (x.shape[0], x.shape[1])
    if max(h, w) == h:
        new_w = h * out_w / out_h
        ratio = out_h / h
        pad_h, pad_w = 0, int((new_w - w) / 2)
    else:
        ratio = out_w / w
        new_h = w * out_h / out_w
        pad_w, pad_h = 0, int((new_h - h) / 2)
    padded = pad_to(x, pad_h, pad_w, fill)
    return resize_bilinear(padded, out_h, out_w), (pad_h, pad_w, ratio)


def _crop_coords(boxes, out_h: int, out_w: int, H: int, W: int):
    """Source sampling centres with half-pixel convention, border-replicated
    at the CROP edge (cv2 crop-then-resize: samples never leak outside the
    box), then clipped to the frame.

    Coordinates are ALWAYS computed in f32: bf16 integer resolution above
    256 is 2.0, so bf16 coordinate math collides sample centres with the
    pixel grid for boxes in the right/bottom part of a 416 frame (crop
    pixel error up to 6.5 measured — advisor finding r2). The bf16 einsum
    speedup is recovered downstream: callers cast the HAT WEIGHTS (which
    live in [0,1], where bf16 relative precision is fine) to the frame
    dtype just before the contraction — see ``roi_crop_bilinear``."""
    dtype = jnp.float32
    boxes = boxes.astype(dtype)
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    bw = jnp.maximum(x1 - x0, 1e-3)
    bh = jnp.maximum(y1 - y0, 1e-3)
    js = (jnp.arange(out_w, dtype=dtype) + 0.5) / out_w
    is_ = (jnp.arange(out_h, dtype=dtype) + 0.5) / out_h
    sx = x0[..., None] + bw[..., None] * js - 0.5
    sy = y0[..., None] + bh[..., None] * is_ - 0.5
    sx = jnp.clip(sx, x0[..., None], x1[..., None] - 1.0)
    sy = jnp.clip(sy, y0[..., None], y1[..., None] - 1.0)
    sx = jnp.clip(sx, 0.0, W - 1.0)
    sy = jnp.clip(sy, 0.0, H - 1.0)
    return sx, sy


def _hat_matrix(s, size: int):
    """Bilinear interpolation as a dense matrix: row i holds the two-tap hat
    weights max(0, 1-|s_i - j|) over source positions j. Contracting with
    the image IS the bilinear resample — and it runs as a matmul."""
    grid = jnp.arange(size, dtype=s.dtype)
    return jnp.clip(1.0 - jnp.abs(s[..., None] - grid), 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def roi_crop_bilinear(frames, boxes, out_h: int = 80, out_w: int = 80):
    """Fixed-capacity batched ROI crop+resize — the detect→keypoints bridge.

    Args:
        frames: (B, H, W, C) float frames.
        boxes:  (B, K, 4) xyxy crop rectangles in frame pixels (may be
            degenerate for padded slots — output is garbage there; callers
            carry a mask).

    Returns (B, K, out_h, out_w, C) crops, bilinear with half-pixel centres
    (cv2.resize semantics on the crop).

    Separable bilinear resampling is expressed as two batched matmuls
    against sparse two-tap interpolation matrices (rows then columns)
    instead of gathers. Replaces the reference's host-side cv2
    crop/resize between the two ONNX models (README.md:59 pipeline).
    """
    B, H, W, C = frames.shape
    sx, sy = _crop_coords(boxes, out_h, out_w, H, W)
    # hat weights are in [0,1] — safe to carry in the frame dtype; the
    # coordinate math above must stay f32 (see _crop_coords)
    Ry = _hat_matrix(sy, H).astype(frames.dtype)  # (B, K, oh, H)
    Rx = _hat_matrix(sx, W).astype(frames.dtype)  # (B, K, ow, W)
    fr = frames.reshape(B, H, W * C)
    rows = jnp.einsum("bkih,bhm->bkim", Ry, fr)  # (B, K, oh, W*C)
    rows = rows.reshape(B, boxes.shape[1], out_h, W, C)
    return jnp.einsum("bkjw,bkiwc->bkijc", Rx, rows)


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def roi_crop_bilinear_indexed(frames, boxes, frame_idx, out_h: int = 80,
                              out_w: int = 80):
    """Compacted ROI crop: (C,) crops addressed into the batch.

    Args:
        frames: (B, H, W, C) float frames.
        boxes:  (C, 4) xyxy rectangles in frame pixels.
        frame_idx: (C,) int32 — which frame each crop reads.

    Bit-identical to :func:`roi_crop_bilinear` on the addressed slots (same
    hat-matrix matmuls after a frame gather). Wins over the dense crop when
    C ≪ B·K; the (C, H, W·ch) frame gather caps the gain."""
    B, H, W, Cc = frames.shape
    n = boxes.shape[0]
    sx, sy = _crop_coords(boxes, out_h, out_w, H, W)
    Ry = _hat_matrix(sy, H).astype(frames.dtype)  # (C, oh, H)
    Rx = _hat_matrix(sx, W).astype(frames.dtype)  # (C, ow, W)
    fr = frames.reshape(B, H, W * Cc)[frame_idx]  # (C, H, W*Cc)
    rows = jnp.einsum("cih,chm->cim", Ry, fr).reshape(n, out_h, W, Cc)
    return jnp.einsum("cjw,ciwk->cijk", Rx, rows)


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def roi_crop_bilinear_gather(frames, boxes, out_h: int = 80, out_w: int = 80):
    """Gather-based reference implementation of :func:`roi_crop_bilinear`
    (identical semantics; kept for cross-checking and CPU-bound callers)."""
    B, H, W, C = frames.shape
    sx, sy = _crop_coords(boxes, out_h, out_w, H, W)

    x0i = jnp.floor(sx).astype(jnp.int32)
    y0i = jnp.floor(sy).astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, W - 1)
    y1i = jnp.minimum(y0i + 1, H - 1)
    # like the matmul variants: coords stay f32, but the [0,1) lerp
    # weights are carried in the frame dtype so bf16 frames yield bf16
    # crops (not a silent f32 promotion). Integer frames keep f32
    # weights — casting [0,1) to an int dtype would truncate bilinear
    # into nearest-floor sampling.
    wdt = (frames.dtype if jnp.issubdtype(frames.dtype, jnp.floating)
           else jnp.float32)
    fx = (sx - x0i)[..., None].astype(wdt)  # (B, K, ow, 1)
    fy = (sy - y0i)[..., None].astype(wdt)  # (B, K, oh, 1)

    rows0 = jax.vmap(lambda fr, yi: fr[yi])(frames, y0i)  # (B, K, oh, W, C)
    rows1 = jax.vmap(lambda fr, yi: fr[yi])(frames, y1i)
    rows = rows0 * (1 - fy[..., None]) + rows1 * fy[..., None]

    def gather_cols(rw, xi):
        return jax.vmap(lambda r, x: r[:, x])(rw, xi)

    cols0 = jax.vmap(gather_cols)(rows, x0i)  # (B, K, oh, ow, C)
    cols1 = jax.vmap(gather_cols)(rows, x1i)
    return cols0 * (1 - fx[:, :, None]) + cols1 * fx[:, :, None]
