import jax.numpy as jnp
import numpy as np
import pytest

from mit_driverless_cv_traininginfra.ops import (
    add_class_dimension_to_labels,
    add_padding_on_each_side,
    bbox_iou,
    bbox_iou_pairwise,
    calculate_padding,
    scale_labels,
    xyhw2xyxy_corner,
    xywh2xyxy,
    xyxy2xywh,
)


def test_xywh_roundtrip():
    xywh = jnp.array([[10.0, 20.0, 4.0, 6.0], [0.0, 0.0, 2.0, 2.0]])
    xyxy = xywh2xyxy(xywh)
    np.testing.assert_allclose(xyxy, [[8, 17, 12, 23], [-1, -1, 1, 1]])
    np.testing.assert_allclose(xyxy2xywh(xyxy), xywh, atol=1e-6)


def test_bbox_iou_plus_one_convention():
    # identical 1x1 "boxes" (x1==x2) have area (0+1)*(0+1)=1 under the
    # reference's +1 convention (utils/utils.py:184-189) → IoU 1, not nan.
    a = jnp.array([0.0, 0.0, 0.0, 0.0])
    b = jnp.array([0.0, 0.0, 0.0, 0.0])
    assert float(bbox_iou(a, b)) == pytest.approx(1.0, rel=1e-6)

    # half-overlapping: boxes [0,0,9,9] and [5,0,14,9]: inter = 5*10, each
    # area = 100, union = 150 → IoU = 1/3 under +1 convention.
    a = jnp.array([0.0, 0.0, 9.0, 9.0])
    b = jnp.array([5.0, 0.0, 14.0, 9.0])
    assert float(bbox_iou(a, b)) == pytest.approx(50.0 / 150.0, rel=1e-6)


def test_bbox_iou_xywh_mode():
    a = jnp.array([5.0, 5.0, 10.0, 10.0])  # cx,cy,w,h → [0,0,10,10]
    b = jnp.array([5.0, 5.0, 10.0, 10.0])
    assert float(bbox_iou(a, b, x1y1x2y2=False)) == pytest.approx(1.0, rel=1e-6)


def test_bbox_iou_pairwise_shape():
    b1 = jnp.zeros((3, 4))
    b2 = jnp.zeros((5, 4))
    assert bbox_iou_pairwise(b1, b2).shape == (3, 5)


def test_calculate_padding_matches_reference_semantics():
    # tall image: pad width (utils/utils.py:38-42)
    pad_h, pad_w, scale = calculate_padding(100, 50, 80, 80)
    assert pad_h == 0 and pad_w == int((100 * 80 / 80 - 50) / 2)
    assert scale == pytest.approx(80 / 100)
    # wide image: pad height
    pad_h, pad_w, scale = calculate_padding(50, 100, 80, 80)
    assert pad_w == 0 and pad_h == int((100 * 80 / 80 - 50) / 2)
    assert scale == pytest.approx(80 / 100)


def test_label_pipeline_ops():
    raw = jnp.array([[10.0, 20.0, 30.0, 40.0]])  # CSV [x, y, h, w]
    lab = add_class_dimension_to_labels(raw)
    assert lab.shape == (1, 5) and float(lab[0, 0]) == 0.0
    xyxy = xyhw2xyxy_corner(lab)
    # x2 = x + w = 10+40, y2 = y + h = 20+30 (utils/utils.py:342-349)
    np.testing.assert_allclose(xyxy[0], [0, 10, 20, 50, 50])
    scaled = scale_labels(xyxy, 2.0)
    np.testing.assert_allclose(scaled[0], [0, 20, 40, 100, 100])
    padded = add_padding_on_each_side(scaled, 3, 7)
    np.testing.assert_allclose(padded[0], [0, 23, 47, 103, 107])
