import numpy as np
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.ops.heatmap import (
    gaussian_heatmaps,
    get_scale,
    keypoint_distance_summary,
    keypoint_l2_distances,
    prep_label,
    scale_keypoints,
)


def test_prep_label_unit_mass_and_peak_location():
    # keypoint at (x=30, y=40) in a 100x120 image → 80x80 heatmap
    label = np.array([[30, 40]])
    hm = prep_label(label, (80, 80), (100, 120, 3))
    assert hm.shape == (1, 80, 80)
    np.testing.assert_allclose(hm[0].sum(), 1.0, rtol=1e-6)
    py, px = np.unravel_index(hm[0].argmax(), hm[0].shape)
    # peak should land near (40*80/100, 30*80/120) = (32, 20)
    assert abs(py - 32) <= 2 and abs(px - 20) <= 2


def test_get_scale_and_scale_keypoints():
    h_s, w_s = get_scale((100, 120, 3), (80, 80))
    assert (h_s, w_s) == (0.8, 80 / 120)
    pts = scale_keypoints(np.array([[30, 40]]), h_s, w_s)
    # ceil semantics (RektNet/utils.py:105-111)
    assert pts.tolist() == [[int(np.ceil(30 * w_s)), int(np.ceil(40 * h_s))]]


def test_gaussian_heatmaps_device_path():
    pts = jnp.array([[[0.25, 0.5], [0.9, 0.1]]])  # (1, 2, 2)
    hm = gaussian_heatmaps(pts, 80, 80, sigma=1.5)
    assert hm.shape == (1, 2, 80, 80)
    np.testing.assert_allclose(np.asarray(hm.sum(axis=(2, 3))), 1.0, atol=1e-5)
    p0 = np.unravel_index(np.asarray(hm[0, 0]).argmax(), (80, 80))
    assert p0 == (40, 20)  # (y=0.5*80, x=0.25*80)


def test_keypoint_metrics():
    t = jnp.zeros((4, 7, 2))
    p = jnp.ones((4, 7, 2)) * jnp.array([3.0, 4.0])
    d = keypoint_l2_distances(t, p)
    np.testing.assert_allclose(np.asarray(d), 5.0, rtol=1e-6)
    means, total, stds = keypoint_distance_summary(d)
    np.testing.assert_allclose(means, 5.0, rtol=1e-6)
    np.testing.assert_allclose(total, 35.0, rtol=1e-6)
    np.testing.assert_allclose(stds, 0.0, atol=1e-6)
