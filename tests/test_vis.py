"""Visualization utils (utils/vis.py) vs the reference's rendering rules."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mit_driverless_cv_traininginfra.utils.vis import (  # noqa: E402
    heatmap_strip,
    vis_hm_and_save,
    vis_hm_strip_and_save,
    vis_tensor_and_save,
    visualize_and_save_to_local,
    visualize_dataset,
)


def test_heatmap_strip_per_channel_normalised():
    """Each channel min-max normalised INDEPENDENTLY and stacked
    vertically (RektNet/detect.py:40-48) — a strong channel must not
    wash out a weak one the way the summed map does."""
    rng = np.random.default_rng(0)
    hm = rng.uniform(0, 1, (7, 8, 5))
    hm[3] *= 1e-4  # weak channel
    strip = heatmap_strip(hm)
    assert strip.shape == (7 * 8, 5)
    for k in range(7):
        chan = strip[k * 8:(k + 1) * 8]
        assert chan.min() == pytest.approx(0.0, abs=1e-9)
        assert chan.max() == pytest.approx(1.0, abs=1e-9)


def test_vis_writers_tmp_then_rename(tmp_path):
    """All writers must land complete files only (tmp-then-rename, like
    the reference) — no partial JPEGs for a directory poller."""
    out = str(tmp_path / "vis")
    img = np.zeros((16, 16, 3), np.uint8)
    d1 = vis_hm_and_save(np.random.default_rng(1).uniform(0, 1, (7, 8, 8)),
                         "a", output_uri=out)
    d2 = vis_hm_strip_and_save(
        np.random.default_rng(2).uniform(0, 1, (7, 8, 8)), "a",
        output_uri=out)
    vis_tensor_and_save(img.copy(), 16, 16,
                        np.full((7, 2), 0.5), "a", out)
    from PIL import Image

    visualize_and_save_to_local(Image.fromarray(img),
                                np.array([[0, 1, 1, 5, 5.0]]),
                                str(tmp_path / "vis" / "b.jpg"))
    names = sorted(os.listdir(out))
    assert not any(n.endswith(".tmp.jpg") for n in names)
    assert {"a_heat_map.jpg", "a_hm.jpg", "a_inference.jpg", "b.jpg"} <= set(names)
    assert os.path.basename(d1) == "a_heat_map.jpg"
    assert os.path.basename(d2) == "a_hm.jpg"


def test_visualize_dataset_normalises_by_padded_dims(tmp_path):
    """Keypoints normalise by the PADDED square dims (the reference
    re-reads h,w after copyMakeBorder, RektNet/utils.py:124): a point at
    the content's bottom edge of a landscape image must render at the
    canvas MIDDLE, not the canvas bottom."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    arr = np.full((500, 1000, 3), 200, np.uint8)
    cv2.imwrite(str(img_dir / "wide.jpg"), arr)
    label = np.array([[500, 499]] * 7, np.float32)  # content bottom centre
    out = str(tmp_path / "out") + "/"
    n = visualize_dataset(["wide.jpg"], [label], str(img_dir) + "/", out)
    assert n == 1
    rendered = cv2.imread(os.path.join(out, "wide.jpg"))
    ys, xs = np.where((rendered[..., 1] > 180) & (rendered[..., 0] < 120))
    assert len(ys) > 0
    # normalised y = 499/1000 → ~canvas middle (y≈499), NOT y≈998
    assert 460 <= ys.mean() <= 540, ys.mean()
