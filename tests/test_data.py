import csv
import json

import numpy as np
import pytest
from PIL import Image

from mit_driverless_cv_traininginfra.data.kmeans_anchors import (
    compute_scale_factors,
    generate_dataset_csvs,
    kmeans_boxes,
)
from mit_driverless_cv_traininginfra.data.loader import DataLoader
from mit_driverless_cv_traininginfra.data.rektnet_data import (
    ConeDataset,
    RektNetLoader,
    load_train_csv_dataset,
)
from mit_driverless_cv_traininginfra.data.yolo_csv import (
    YoloCsvRow,
    read_yolo_csv,
    write_yolo_csv,
)
from mit_driverless_cv_traininginfra.data.yolo_dataset import ImageLabelDataset


@pytest.fixture
def yolo_dataset_dir(tmp_path):
    """Synthetic image folder + CSV in the reference layout."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        w, h = (400, 300) if i % 2 == 0 else (200, 150)
        arr = rng.integers(0, 255, (h, w, 3), np.uint8)
        name = f"img_{i}.png"
        Image.fromarray(arr).save(img_dir / name)
        # boxes as [x, y, h, w]
        boxes = np.array([[50.0, 40.0, 60.0, 30.0], [120.0, 80.0, 40.0, 20.0]],
                         np.float32)
        rows.append(YoloCsvRow(image=name, width=w, height=h, scale=0.9,
                               boxes=boxes))
    csv_path = tmp_path / "train.csv"
    write_yolo_csv(str(csv_path), rows, anchors=[(10, 13)] * 9)
    return str(csv_path), str(img_dir)


def test_yolo_csv_roundtrip(yolo_dataset_dir):
    csv_path, _ = yolo_dataset_dir
    table = read_yolo_csv(csv_path)
    assert len(table.rows) == 6
    assert table.anchors is not None and len(table.anchors) == 9
    r = table.rows[0]
    assert r.width == 400 and r.height == 300 and r.scale == pytest.approx(0.9)
    np.testing.assert_allclose(r.boxes[0], [50, 40, 60, 30])


def test_yolo_csv_skips_negative_rows(tmp_path):
    p = tmp_path / "bad.csv"
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["note"])
        w.writerow(["Name", "URL", "Width", "Height", "Scale", "b"])
        w.writerow(["a.png", "", 100, 100, 1.0, json.dumps([-5, 0, 10, 10])])
        w.writerow(["b.png", "", 100, 100, 1.0, json.dumps([5, 0, 10, 10])])
    with pytest.warns(UserWarning):
        table = read_yolo_csv(str(p))
    assert len(table.rows) == 1 and table.rows[0].image == "b.png"


def test_image_label_dataset_ts_mode(yolo_dataset_dir):
    csv_path, img_dir = yolo_dataset_dir
    ds = ImageLabelDataset(csv_path, img_dir, width=256, height=256, ts=True)
    assert len(ds) >= 6  # expanded to n_patches per image
    uri, img, labels = ds[0]
    assert img.shape == (256, 256, 3) and img.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0
    assert labels.shape == (ds.num_targets_per_image, 5)
    assert (labels >= 0).all()
    # normalised xywh
    assert (labels[:, 1:] <= 1.0).all()


def test_image_label_dataset_letterbox_mode(yolo_dataset_dir):
    csv_path, img_dir = yolo_dataset_dir
    ds = ImageLabelDataset(csv_path, img_dir, width=128, height=128, ts=False)
    assert len(ds) == 6
    uri, img, labels = ds[0]
    assert img.shape == (128, 128, 3)
    real = labels[labels.sum(axis=1) > 0]
    assert len(real) == 2


def test_label_normalization_exact_and_mode_consistent(yolo_dataset_dir):
    """The host path's final normalise-to-cxcywh (utils/datasets.py:307-309)
    must be algebraically exact — REGRESSION for the r5 aliasing bug where
    the corner columns were numpy VIEWS into the output array, so writing
    cx first silently turned w = |x2-x1| into |x2-cx| ≈ x2. Training via
    the device-pool path was immune (pixel corners convert on device), so
    the corruption only surfaced as val-mAP pinned at 0 on the first
    production training run on hardware."""
    csv_path, img_dir = yolo_dataset_dir
    # letterbox mode: fully deterministic geometry (no random patch pick)
    kw = dict(dataset_path=img_dir, width=128, height=128, ts=False)
    norm = ImageLabelDataset(csv_path, **kw)
    corner = ImageLabelDataset(csv_path, device_aug=True, **kw)
    _, _, lab_n = norm[0]
    _, _, lab_c = corner[0]
    real_n = lab_n[lab_n.sum(axis=1) > 0]
    real_c = lab_c[lab_c.sum(axis=1) > 0]
    # device_aug labels are pixel corners; normal labels must be exactly
    # their normalized cxcywh — any view-aliasing breaks this identity
    x1, y1, x2, y2 = real_c[:, 1], real_c[:, 2], real_c[:, 3], real_c[:, 4]
    np.testing.assert_allclose(real_n[:, 1], (x1 + x2) / 2 / 128, rtol=1e-6)
    np.testing.assert_allclose(real_n[:, 2], (y1 + y2) / 2 / 128, rtol=1e-6)
    np.testing.assert_allclose(real_n[:, 3], (x2 - x1) / 128, rtol=1e-6)
    np.testing.assert_allclose(real_n[:, 4], (y2 - y1) / 128, rtol=1e-6)
    # absolute values for img_0 (400x300, scale col unused in letterbox):
    # box [x,y,h,w]=[50,40,60,30] -> corners (50,40)-(80,100), +50px vert
    # pad -> (50,90)-(80,150), x 128/400 -> (16,28.8)-(25.6,48)
    np.testing.assert_allclose(
        real_n[0], [0.0, 20.8 / 128, 38.4 / 128, 9.6 / 128, 19.2 / 128],
        rtol=1e-5)


def test_image_label_dataset_augment(yolo_dataset_dir):
    csv_path, img_dir = yolo_dataset_dir
    ds = ImageLabelDataset(csv_path, img_dir, width=256, height=256, ts=True,
                           data_aug=True, lr_flip=True, blur=True, noise=True,
                           contrast=True, sharpen=True)
    uri, img, labels = ds[1]
    assert img.shape == (256, 256, 3)
    assert (labels >= 0).all()


def test_dataloader_batching(yolo_dataset_dir):
    csv_path, img_dir = yolo_dataset_dir
    ds = ImageLabelDataset(csv_path, img_dir, width=128, height=128, ts=False)
    dl = DataLoader(ds, batch_size=4, shuffle=True, num_workers=2)
    batches = list(dl)
    assert len(batches) == len(dl)
    uris, imgs, labels = batches[0]
    assert imgs.shape == (4, 128, 128, 3)
    assert labels.shape[0] == 4 and labels.shape[2] == 5


def test_kmeans_boxes_converges():
    rng = np.random.default_rng(1)
    c1 = rng.normal((20, 10), 1.0, (50, 2))
    c2 = rng.normal((80, 40), 2.0, (50, 2))
    anchors = kmeans_boxes(np.concatenate([c1, c2]), 2, seed=0)
    got = sorted(anchors.tolist())
    assert abs(got[0][0] - 20) < 2 and abs(got[1][0] - 80) < 3


def test_compute_scale_factors():
    box_dict = {(300, 400): [(float(h), h / 2.0) for h in range(10, 110)]}
    scale_dict, scaled = compute_scale_factors(box_dict, max_cone=83, min_cone=10)
    # 5th pct h=15, 95th pct h=104 → ratio 73/89
    assert scale_dict[(300, 400)] == pytest.approx(73 / 89, rel=1e-6)
    assert scaled.shape == (100, 2)


def test_generate_dataset_csvs_end_to_end(yolo_dataset_dir, tmp_path):
    csv_path, img_dir = yolo_dataset_dir
    out = tmp_path / "out"
    anchors = generate_dataset_csvs(csv_path, img_dir, str(out), num_clst=3,
                                    split_up=(50, 34, 16))
    assert len(anchors) == 3
    for name in ["train.csv", "validate.csv", "test.csv", "train-validate.csv", "all.csv"]:
        assert (out / name).exists(), name
    train = read_yolo_csv(str(out / "train.csv"))
    assert train.anchors is not None and len(train.anchors) == 3
    # anchors sorted by area
    areas = [a[0] * a[1] for a in train.anchors]
    assert areas == sorted(areas)
    allc = read_yolo_csv(str(out / "all.csv"))
    assert len(allc.rows) == 6
    # scale column now holds the computed per-resolution factor
    assert allc.rows[0].scale != 0.9


@pytest.fixture
def rektnet_dataset_dir(tmp_path):
    img_dir = tmp_path / "rekt"
    img_dir.mkdir()
    rng = np.random.default_rng(2)
    names, cells = [], []
    for i in range(5):
        name = f"cone_{i}.jpg"
        arr = rng.integers(0, 255, (60, 40, 3), np.uint8)
        Image.fromarray(arr).save(img_dir / name)
        names.append(name)
        pts = [(int(rng.integers(1, 39)), int(rng.integers(1, 59))) for _ in range(7)]
        cells.append([f"({p[0]},{p[1]})" for p in pts])
    cols = ["img_name", "other", "top", "mid_L_top", "mid_R_top", "mid_L_bot",
            "mid_R_bot", "bot_L", "bot_R"]
    csv_path = tmp_path / "rektnet_label.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for n, c in zip(names, cells):
            w.writerow([n, "x"] + c)
    return str(csv_path), str(img_dir) + "/"


def test_rektnet_csv_loader_and_cache(rektnet_dataset_dir, tmp_path):
    csv_path, img_dir = rektnet_dataset_dir
    cache = str(tmp_path / "cache")
    ti, tl, vi, vl = load_train_csv_dataset(csv_path, 0.2, dataset_path=img_dir,
                                            cache_location=cache)
    assert len(vi) == 1 and len(ti) == 4
    assert tl.shape[1:] == (7, 2)
    # second call hits the cache (delete images to prove it)
    ti2, tl2, _, _ = load_train_csv_dataset(csv_path, 0.2, dataset_path=img_dir,
                                            cache_location=cache)
    np.testing.assert_array_equal(np.asarray(tl), np.asarray(tl2))


def test_cone_dataset_and_loader(rektnet_dataset_dir):
    csv_path, img_dir = rektnet_dataset_dir
    ti, tl, vi, vl = load_train_csv_dataset(csv_path, 0.0, dataset_path=img_dir)
    ds = ConeDataset(ti, tl, img_dir, (80, 80))
    img, hm, pts, name, orig = ds[0]
    assert img.shape == (80, 80, 3) and img.dtype == np.float32
    assert hm.shape == (7, 80, 80)
    np.testing.assert_allclose(hm.sum(axis=(1, 2)), 1.0, atol=1e-5)
    assert pts.shape == (7, 2) and (pts >= 0).all() and (pts <= 1.5).all()

    dl = RektNetLoader(ds, batch_size=2)
    imgs, hms, ptss, names, sizes = next(iter(dl))
    assert imgs.shape == (2, 80, 80, 3) and hms.shape == (2, 7, 80, 80)


def test_generate_csvs_no_empty_images_keeps_train_split(yolo_dataset_dir, tmp_path):
    """Regression: with zero empty-label images the compensation trade must
    be a no-op (the reference's loop would drain train into validate)."""
    csv_path, img_dir = yolo_dataset_dir
    out = tmp_path / "out2"
    generate_dataset_csvs(csv_path, img_dir, str(out), num_clst=2,
                          split_up=(50, 25, 25))
    train = read_yolo_csv(str(out / "train.csv"))
    validate = read_yolo_csv(str(out / "validate.csv"))
    assert len(train.rows) == 6 and len(validate.rows) == 0


def test_prefetch_to_device_propagates_errors():
    """A failing dataset must crash the epoch, not silently truncate it."""
    from mit_driverless_cv_traininginfra.data.loader import prefetch_to_device

    def bad_iter():
        yield ["u"], np.zeros((2, 4, 4, 3), np.float32), np.zeros((2, 1, 5), np.float32)
        raise RuntimeError("boom")

    it = prefetch_to_device(bad_iter())
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_dataloader_bounded_prefetch(yolo_dataset_dir):
    """Only prefetch_batches batches may be decoded ahead of the consumer."""
    import threading

    csv_path, img_dir = yolo_dataset_dir
    ds = ImageLabelDataset(csv_path, img_dir, width=128, height=128, ts=False)
    in_flight = []
    lock = threading.Lock()
    orig = ds.__getitem__

    consumed = [0]

    def counting(i):
        with lock:
            in_flight.append(consumed[0])
        return orig(i)

    ds.__getitem__ = counting
    dl = DataLoader(ds, batch_size=1, shuffle=False, num_workers=1,
                    prefetch_batches=2)
    for _ in dl:
        consumed[0] += 1
    # no item may have been scheduled more than prefetch_batches ahead
    # of the number of batches consumed at submit time
    for idx, consumed_at_submit in enumerate(in_flight):
        assert idx - consumed_at_submit <= 2, (idx, consumed_at_submit)


def test_dataset_per_item_rng_reproducible_and_epoch_varying(yolo_dataset_dir):
    """Augmentation draws are keyed on (seed, epoch, index): the same item
    is bit-identical across calls and call orders (so worker threads can't
    destroy the seed), and set_epoch() refreshes the draws."""
    csv_path, img_dir = yolo_dataset_dir
    mk = lambda: ImageLabelDataset(csv_path, img_dir, width=256, height=256,
                                   ts=True, data_aug=True, noise=True,
                                   seed=17)
    a, b = mk(), mk()
    # fetch in different orders — per-index outputs must still match
    got_a = {i: a[i] for i in range(4)}
    got_b = {i: b[i] for i in reversed(range(4))}
    for i in range(4):
        np.testing.assert_array_equal(got_a[i][1], got_b[i][1])
        np.testing.assert_array_equal(got_a[i][2], got_b[i][2])
    # same item twice on one instance: identical
    np.testing.assert_array_equal(a[2][1], a[2][1])
    # new epoch: augmentation changes
    a.set_epoch(1)
    assert not np.array_equal(got_a[2][1], a[2][1])


def test_dataset_bw_honoured_in_all_modes(yolo_dataset_dir):
    """channels=1 configs must get (H,W,1) arrays on every path — including
    device_aug (whose on-device photometric step can't change conv1's input
    channel count) and the empty-boxes early return."""
    csv_path, img_dir = yolo_dataset_dir
    for kw in (dict(device_aug=True, data_aug=True),
               dict(device_aug=True), dict()):
        ds = ImageLabelDataset(csv_path, img_dir, width=256, height=256,
                               ts=True, bw=True, **kw)
        _, img, _ = ds[0]
        assert img.shape == (256, 256, 1), kw


def test_rektnet_loader_threaded_matches_serial(rektnet_dataset_dir):
    """num_workers>0 path (bounded prefetch window) must yield the same
    batches in the same order as the serial path."""
    csv_path, img_dir = rektnet_dataset_dir
    ti, tl, _, _ = load_train_csv_dataset(csv_path, 0.0, dataset_path=img_dir)
    ds = ConeDataset(ti, tl, img_dir, (80, 80))
    serial = list(RektNetLoader(ds, batch_size=2, num_workers=0))
    threaded = list(RektNetLoader(ds, batch_size=2, num_workers=2))
    assert len(serial) == len(threaded)
    for s, t in zip(serial, threaded):
        np.testing.assert_array_equal(s[0], t[0])
        np.testing.assert_array_equal(s[2], t[2])
        assert s[3] == t[3]


def test_make_synth_dataset_rektnet_roundtrip(tmp_path):
    """tools/make_synth_dataset.py --family rektnet output must round-trip
    through the PRODUCTION loader (load_train_csv_dataset -> ConeDataset):
    chronological val split honoured, and the decoded keypoints must match
    the generator's ground truth within the reference's int/ceil label
    quantization (scale_keypoints, ops/heatmap.py:63-68)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "make_synth_dataset.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    out = str(tmp_path / "rk")
    tool.main(["--family", "rektnet", "--out", out,
               "--train", "9", "--val", "3", "--seed", "123"])
    csv_path = os.path.join(out, "rektnet_label.csv")
    ratio = 3.5 / 12  # floor(12 * ratio) == 3, the generator's va_ rows
    ti, tl, vi, vl = load_train_csv_dataset(
        csv_path, validation_percent=ratio,
        dataset_path=os.path.join(out, "images"))
    assert len(ti) == 9 and len(vi) == 3
    assert all(str(n).startswith("va_") for n in vi)
    assert all(str(n).startswith("tr_") for n in ti)

    ds = ConeDataset(vi, vl, os.path.join(out, "images"), (80, 80))
    img, hm, pts, _, orig = ds[0]
    assert img.shape == (80, 80, 3) and img.dtype == np.float32
    assert hm.shape == (7, 80, 80)
    # each heatmap channel is a normalised distribution (prep_label)
    np.testing.assert_allclose(hm.reshape(7, -1).sum(-1), 1.0, atol=1e-5)
    # keypoints: CSV px coords -> int/ceil-scaled to 80 -> /80; the
    # generator's truth is pts_norm in [0,1] of the ORIGINAL crop. The
    # int() truncation + ceil() after scaling costs < 2px at 80.
    row = vl[0]
    h, w = orig[0], orig[1]
    expect = np.stack([np.ceil(row[:, 0].astype(int) * (80.0 / w)),
                       np.ceil(row[:, 1].astype(int) * (80.0 / h))], -1) / 80.0
    np.testing.assert_allclose(pts, expect, atol=1e-6)
