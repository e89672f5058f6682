import numpy as np
import pytest

from mit_driverless_cv_traininginfra.ops.patches import (
    filter_and_offset_labels,
    get_patch_bounds,
    get_patch_spacings,
    pre_tile_padding,
)


def test_pre_tile_padding():
    assert pre_tile_padding(100, 100, 80, 80) == (0, 0)
    # image smaller than patch on both axes → ceil half-gap padding
    assert pre_tile_padding(60, 50, 80, 80) == (15, 10)


def test_patch_spacings_distributes_overhang():
    nw, nh, total, hoff, voff = get_patch_spacings(1000, 800, 416, 416)
    assert (nw, nh, total) == (3, 2, 6)
    # 3*416 - 1000 = 248 overhang over 2 gaps
    assert hoff == pytest.approx(248 / 2)
    assert voff == pytest.approx(416 * 2 - 800)


def test_patch_bounds_cover_image():
    w, h, pw, ph = 1000, 800, 416, 416
    nw, nh, total, _, _ = get_patch_spacings(w, h, pw, ph)
    # first patch at origin, last patch flush with bottom-right
    assert get_patch_bounds(w, h, pw, ph, 0)[:2] == (0, 0)
    l, t, r, b = get_patch_bounds(w, h, pw, ph, total - 1)
    assert r == pytest.approx(w) and b == pytest.approx(h)
    # every patch is exactly patch-sized
    for i in range(total):
        l, t, r, b = get_patch_bounds(w, h, pw, ph, i)
        assert r - l == pytest.approx(pw) and b - t == pytest.approx(ph)


def test_filter_and_offset_labels():
    boundary = (100, 100, 200, 200)
    labels = np.array(
        [
            [0, 110, 110, 150, 150],   # fully inside → kept as-is (offset)
            [0, 0, 0, 50, 50],         # fully outside → dropped
            [0, 90, 120, 130, 160],    # 75% inside → kept, clipped at x=100
            [0, 190, 190, 400, 400],   # small frac but overlap 10*10=100 <1000, 100/44100 <0.5 → dropped
        ],
        dtype=np.float32,
    )
    out = filter_and_offset_labels(labels, boundary)
    np.testing.assert_allclose(out[0], [0, 10, 10, 50, 50])
    np.testing.assert_allclose(out[1], [0, 0, 20, 30, 60])
    assert out.shape[0] == 2


def test_filter_and_offset_labels_none_survive_returns_zeros():
    boundary = (100, 100, 200, 200)
    labels = np.array([[0, 0, 0, 10, 10]], dtype=np.float32)
    out = filter_and_offset_labels(labels, boundary)
    # reference quirk: zeros with the input row count (utils/utils.py:469-472)
    assert out.shape == labels.shape and not out.any()
