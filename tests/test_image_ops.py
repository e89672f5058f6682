import numpy as np
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.ops.image import (
    GREY,
    letterbox,
    pad_to,
    resize_bilinear,
    roi_crop_bilinear,
    roi_crop_bilinear_gather,
    roi_crop_bilinear_indexed,
)


def test_pad_to_values():
    x = jnp.ones((2, 2, 3))
    p = pad_to(x, 1, 2, fill=0.5)
    assert p.shape == (4, 6, 3)
    assert float(p[0, 0, 0]) == 0.5 and float(p[1, 2, 0]) == 1.0


def test_letterbox_shapes_and_ratio():
    x = jnp.zeros((1, 100, 50, 3))
    out, (pad_h, pad_w, ratio) = letterbox(x, 80, 80)
    assert out.shape == (1, 80, 80, 3)
    assert pad_h == 0 and pad_w == 25 and ratio == pytest.approx(0.8)
    # grey padding visible on the sides
    assert float(out[0, 40, 0, 0]) == pytest.approx(GREY, abs=1e-3)


def test_roi_crop_identity():
    rng = np.random.default_rng(0)
    frame = jnp.asarray(rng.uniform(0, 1, (1, 32, 32, 3)), jnp.float32)
    boxes = jnp.asarray([[[0.0, 0.0, 32.0, 32.0]]])
    crop = roi_crop_bilinear(frame, boxes, 32, 32)
    np.testing.assert_allclose(np.asarray(crop[0, 0]), np.asarray(frame[0]), atol=1e-6)


def test_roi_crop_integer_subregion():
    rng = np.random.default_rng(1)
    frame = jnp.asarray(rng.uniform(0, 1, (1, 64, 64, 3)), jnp.float32)
    boxes = jnp.asarray([[[8.0, 16.0, 24.0, 32.0]]])  # 16x16 region
    crop = roi_crop_bilinear(frame, boxes, 16, 16)
    np.testing.assert_allclose(
        np.asarray(crop[0, 0]), np.asarray(frame[0, 16:32, 8:24]), atol=1e-6
    )


def test_roi_crop_matches_cv2_resize():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    frame = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
    x0, y0, x1, y1 = 4, 6, 36, 42
    crop = roi_crop_bilinear(jnp.asarray(frame[None]),
                             jnp.asarray([[[x0, y0, x1, y1]]]), 80, 80)
    ref = cv2.resize(frame[y0:y1, x0:x1], (80, 80), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(np.asarray(crop[0, 0]), ref, atol=1e-5)


def test_roi_crop_batched_shapes():
    frames = jnp.zeros((2, 64, 64, 3))
    boxes = jnp.zeros((2, 5, 4))
    out = roi_crop_bilinear(frames, boxes, 80, 80)
    assert out.shape == (2, 5, 80, 80, 3)


def test_roi_crop_bf16_frames_high_coords():
    """Advisor r2 (high): bf16 integer resolution above 256 is 2.0, so
    coordinate math done in the frame dtype corrupts crops for boxes in the
    right/bottom ~40% of a 416 frame. Coordinates must stay f32; only the
    hat weights may be bf16. Pin the bf16-vs-f32 crop error for a far box."""
    rng = np.random.default_rng(7)
    frame32 = jnp.asarray(rng.uniform(0, 1, (1, 416, 416, 3)), jnp.float32)
    boxes = jnp.asarray([[[320.0, 320.0, 400.0, 400.0]]])
    ref = np.asarray(roi_crop_bilinear(frame32, boxes, 80, 80)[0, 0])

    crop_bf = roi_crop_bilinear(frame32.astype(jnp.bfloat16), boxes, 80, 80)
    assert crop_bf.dtype == jnp.bfloat16  # the einsums must stay bf16
    err = np.abs(np.asarray(crop_bf[0, 0], np.float32) - ref).max()
    # bf16 hat weights + bf16 frames bound the error near bf16 eps on [0,1];
    # the broken coordinate path measured err up to 6.5 here
    assert err < 0.05, err

    crop_ix = roi_crop_bilinear_indexed(
        frame32.astype(jnp.bfloat16), boxes[0], jnp.zeros((1,), jnp.int32),
        80, 80)
    assert crop_ix.dtype == jnp.bfloat16
    err_ix = np.abs(np.asarray(crop_ix[0], np.float32) - ref).max()
    assert err_ix < 0.05, err_ix

    # the gather variant shares the contract: f32 coords, frame-dtype out
    crop_g = roi_crop_bilinear_gather(frame32.astype(jnp.bfloat16), boxes,
                                      80, 80)
    assert crop_g.dtype == jnp.bfloat16
    err_g = np.abs(np.asarray(crop_g[0, 0], np.float32) - ref).max()
    assert err_g < 0.05, err_g


def test_resize_bilinear_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    ours = np.asarray(resize_bilinear(jnp.asarray(img), 80, 80))
    ref = cv2.resize(img, (80, 80), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
