"""Remote-URI mirror seam (VERDICT r1 missing #2) and the ops hooks
(missing #3: --vis_upload_data dataset-render pass)."""

import csv
import os

import numpy as np
import pytest
from PIL import Image

from mit_driverless_cv_traininginfra.data.uri import resolve_uri


def test_local_paths_pass_through(tmp_path):
    p = str(tmp_path / "x.csv")
    assert resolve_uri(p, must_exist=False) == p
    assert resolve_uri(None) is None
    assert resolve_uri("") == ""


def test_gs_uri_resolves_through_mirror(tmp_path, monkeypatch):
    mirror = tmp_path / "mirror"
    (mirror / "mit-dut18d" / "data").mkdir(parents=True)
    f = mirror / "mit-dut18d" / "data" / "train.csv"
    f.write_text("hello")
    monkeypatch.setenv("MDCV_DATA_MIRROR", str(mirror))
    got = resolve_uri("gs://mit-dut18d/data/train.csv")
    assert got == str(f) and open(got).read() == "hello"


def test_remote_uri_without_mirror_raises(monkeypatch):
    monkeypatch.delenv("MDCV_DATA_MIRROR", raising=False)
    with pytest.raises(FileNotFoundError, match="MDCV_DATA_MIRROR"):
        resolve_uri("gs://bucket/file.weights")


def test_remote_uri_missing_in_mirror_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("MDCV_DATA_MIRROR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not found in mirror"):
        resolve_uri("gs://bucket/absent.csv")


def test_dataset_reads_csv_through_mirror(tmp_path, monkeypatch):
    """ImageLabelDataset accepts a gs:// train_uri when mirrored — the
    reference cfg's CLI contract (yolo_baseline.cfg:8-13) without egress."""
    from mit_driverless_cv_traininginfra.data.yolo_csv import (
        YoloCsvRow,
        write_yolo_csv,
    )
    from mit_driverless_cv_traininginfra.data.yolo_dataset import (
        ImageLabelDataset,
    )

    rng = np.random.default_rng(0)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
        imgs / "a.png")
    mirror = tmp_path / "mirror" / "bucket"
    mirror.mkdir(parents=True)
    write_yolo_csv(str(mirror / "train.csv"), [
        YoloCsvRow(image="a.png", width=64, height=64, scale=1.0,
                   boxes=np.asarray([[10., 10., 20., 15.]], np.float32))])
    monkeypatch.setenv("MDCV_DATA_MIRROR", str(tmp_path / "mirror"))
    ds = ImageLabelDataset("gs://bucket/train.csv", dataset_path=str(imgs),
                           width=32, height=32, ts=False)
    uri, img, labels = ds[0]
    assert img.shape == (32, 32, 3)


def test_vis_upload_data_pass(tmp_path):
    """--vis_upload_data renders the dataset then returns without training
    (train_eval.py:249-252; shutdown gated behind post_run_shutdown)."""
    from mit_driverless_cv_traininginfra.train import rektnet_driver

    rng = np.random.default_rng(2)
    cones = tmp_path / "cones"
    cones.mkdir()
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img", "other", "top", "mid_L_top", "mid_R_top",
                    "mid_L_bot", "mid_R_bot", "bot_L", "bot_R"])
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (40, 30, 3), np.uint8)).save(
                cones / f"c{i}.jpg")
            pts = [f"({int(rng.integers(1, 29))},{int(rng.integers(1, 39))})"
                   for _ in range(7)]
            w.writerow([f"c{i}.jpg", "x"] + pts)

    out = tmp_path / "out"
    ret = rektnet_driver.main(
        train_dataset_uri=str(tmp_path / "labels.csv"),
        dataset_path=str(cones) + "/", output_path=str(out),
        vis_upload_data=True, num_epochs=1, cache_location=str(tmp_path))
    assert ret is None  # no training happened
    rendered = os.listdir(out / "visualization")
    assert len(rendered) >= 3  # val split may hold one back
    assert not any(f.endswith(".tmp.jpg") for f in rendered)
