"""Native C++ input-pipeline core: build, decode, geometry parity vs
cv2/PIL, and the threaded batch path."""

import io
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, "/root/repo") if "/root/repo" not in sys.path else None

import native  # repo-root package, built on demand


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def _png_bytes(arr):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="PNG")
    return b.getvalue()


def _jpg_bytes(arr, q=95):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG", quality=q)
    return b.getvalue()


def test_png_decode_exact():
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (37, 53, 3), np.uint8)
    out = native.decode_image(_png_bytes(arr))
    np.testing.assert_array_equal(out, arr)


def test_jpeg_decode_close():
    rng = np.random.default_rng(1)
    # smooth image so JPEG loss is small
    arr = np.tile(np.linspace(0, 255, 64, dtype=np.uint8)[None, :, None],
                  (48, 1, 3))
    out = native.decode_image(_jpg_bytes(arr, q=98))
    assert out.shape == arr.shape
    assert np.abs(out.astype(int) - arr.astype(int)).mean() < 3


def test_resize_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (48, 40, 3), np.uint8)
    ours = native.resize(img, 80, 96)
    ref = cv2.resize(img, (96, 80), interpolation=cv2.INTER_LINEAR)
    # identical bilinear arithmetic; allow ±1 for rounding mode
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_letterbox_geometry():
    img = np.full((100, 50, 3), 200, np.uint8)
    out = native.letterbox(img, 80, 80, fill=127)
    assert out.shape == (80, 80, 3)
    # grey bars left/right, content centred
    assert abs(int(out[40, 0, 0]) - 127) <= 1
    assert abs(int(out[40, 40, 0]) - 200) <= 1


def test_extract_patch_with_padding():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (30, 30, 3), np.uint8)
    patch = native.extract_patch(img, -5, 10, 20, 25, fill=7)
    assert patch.shape == (20, 25, 3)
    assert (patch[:5] == 7).all()  # above the image
    np.testing.assert_array_equal(patch[5:, :20], img[0:15, 10:30])
    assert (patch[5:, 20:] == 7).all()  # right of the image


def test_affine_identity():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (32, 32, 3), np.uint8)
    ident = np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)
    out = native.affine_warp(img, ident)
    np.testing.assert_array_equal(out, img)


def test_affine_translation():
    img = np.zeros((20, 20, 3), np.uint8)
    img[5, 5] = 255
    # output→input map shifting content +3 in x: src_x = dst_x - 3
    m = np.asarray([[1, 0, -3], [0, 1, 0]], np.float32)
    out = native.affine_warp(img, m, fill=0)
    assert out[5, 8, 0] == 255 and out[5, 5, 0] == 0


def test_batch_decode_letterbox_threaded():
    rng = np.random.default_rng(5)
    blobs = []
    for i in range(12):
        arr = rng.integers(0, 255, (60 + i, 40 + i, 3), np.uint8)
        blobs.append(_png_bytes(arr) if i % 2 else _jpg_bytes(arr))
    out, failures = native.decode_letterbox_batch(blobs, 64, 64, n_threads=4)
    assert failures == 0
    assert out.shape == (12, 64, 64, 3)
    assert out.std() > 0  # actually wrote pixels


def test_batch_decode_reports_failures():
    blobs = [b"not an image", _png_bytes(np.zeros((8, 8, 3), np.uint8))]
    out, failures = native.decode_letterbox_batch(blobs, 32, 32)
    assert failures == 1


def test_decode_seam_is_native_and_pil_identical(tmp_path):
    """The training datasets decode through data.decode — native by default
    (VERDICT r1 #5) and bit-identical to PIL for baseline JPEG/PNG."""
    from mit_driverless_cv_traininginfra.data import decode

    assert decode.native_active(), "native core should build in this image"
    rng = np.random.default_rng(7)
    for ext in ("jpg", "png"):
        p = str(tmp_path / f"x.{ext}")
        Image.fromarray(rng.integers(0, 255, (50, 34, 3), np.uint8)).save(p)
        pil = np.asarray(Image.open(p).convert("RGB"))
        nat = np.asarray(decode.open_rgb(p))
        np.testing.assert_array_equal(nat, pil)
        bgr = decode.imread_bgr(p)
        np.testing.assert_array_equal(bgr, pil[..., ::-1])


def test_letterbox_negative_padding_matches_python_paste():
    """Aspect-mismatched non-square targets give NEGATIIVE pads
    (calculate_padding semantics): the C++ paste must crop like PIL, not
    memcpy at a negative offset (regression: heap corruption)."""
    native = pytest.importorskip("native")
    if not native.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, (100, 100, 3), np.uint8)
    dh, dw = 416, 208
    got = native.letterbox(src, dh, dw)
    # python twin: grey canvas + intersection paste + native resize
    from mit_driverless_cv_traininginfra.ops.boxes import (
        calculate_padding,
    )

    pad_h, pad_w, _ = calculate_padding(100, 100, dh, dw)
    ph, pw = 100 + 2 * pad_h, 100 + 2 * pad_w
    canvas = np.full((ph, pw, 3), 127, np.uint8)
    y0, x0 = max(0, pad_h), max(0, pad_w)
    y1, x1 = min(ph, 100 + pad_h), min(pw, 100 + pad_w)
    canvas[y0:y1, x0:x1] = src[y0 - pad_h:y1 - pad_h, x0 - pad_w:x1 - pad_w]
    want = native.resize(canvas, dh, dw)
    np.testing.assert_array_equal(got, want)


def test_letterbox_and_resize_empty_source_safe():
    """Zero-dimension sources must not read out of bounds."""
    native = pytest.importorskip("native")
    if not native.available():
        pytest.skip("native toolchain unavailable")
    empty = np.zeros((0, 64, 3), np.uint8)
    lb = native.letterbox(empty, 80, 80)
    assert lb.shape == (80, 80, 3) and (lb == 127).all()
    rs = native.resize(empty, 32, 32)
    assert rs.shape == (32, 32, 3) and (rs == 0).all()


def test_pool_size_mismatch_warns():
    native = pytest.importorskip("native")
    if not native.available():
        pytest.skip("native toolchain unavailable")
    blob = None
    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (1, 2, 3)).save(buf, "JPEG")
    blob = buf.getvalue()
    native.decode_letterbox_batch([blob], 32, 32, n_threads=2)  # sizes pool
    built = int(native.load().cv_pool_threads())
    assert built > 0
    with pytest.warns(UserWarning, match="sized at first use"):
        native.decode_letterbox_batch([blob], 32, 32, n_threads=built + 1)
