"""End-to-end training smoke tests on synthetic data: the full driver stack
(CSV → dataset → DP train steps → checkpoints → evaluation → score files)."""

import csv
import os

import numpy as np
import jax
import pytest
from PIL import Image

from mit_driverless_cv_traininginfra.data.yolo_csv import YoloCsvRow, write_yolo_csv


@pytest.fixture
def yolo_train_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        arr = rng.integers(0, 255, (96, 128, 3), np.uint8)
        name = f"t{i}.png"
        Image.fromarray(arr).save(img_dir / name)
        rows.append(YoloCsvRow(image=name, width=128, height=96, scale=1.0,
                               boxes=np.array([[30.0, 20.0, 40.0, 25.0]], np.float32)))
    write_yolo_csv(str(tmp_path / "train.csv"), rows[:4], anchors=None)
    write_yolo_csv(str(tmp_path / "validate.csv"), rows[4:], anchors=None)

    cfg = f"""[net]
width=64
height=64
onnx_height=64
classes=1
channels=3
yolo_masks=3,4,5|0,1,2
yolo_scales=4,2
validate_uri={tmp_path}/validate.csv
train_uri={tmp_path}/train.csv
weights_uri=
start_weights_dim=18,18
num_train_images=-1
num_validate_images=-1
leaky_slope=0.1
conv_activation=leaky
build_targets_ignore_thresh=0.5
conf_thresh=0.5
nms_thresh=0.25
iou_thresh=0.5

[convolutional]
filters=8
size=3
stride=2

[convolutional]
filters=16
size=3
stride=2

[convolutional]
filters=preyolo
size=1
stride=1

[yolo]
mask=3,4,5

[route]
layers=-3

[upsample]
stride=2

[convolutional]
filters=preyolo
size=1
stride=1

[yolo]
mask=0,1,2
"""
    cfg_path = tmp_path / "tiny.cfg"
    cfg_path.write_text(cfg)
    return str(cfg_path), str(img_dir), tmp_path


def test_yolo_driver_end_to_end(yolo_train_env):
    from mit_driverless_cv_traininginfra.train import yolo_driver

    cfg_path, img_dir, tmp_path = yolo_train_env
    val_loss = yolo_driver.main(
        model_cfg=cfg_path, weights_path=None, output_path=str(tmp_path / "out"),
        dataset_path=img_dir, batch_size=4, num_epochs=2, checkpoint_interval=1,
        lr=1e-4, gamma=0.95, vanilla_anchor=True, ts=False, num_workers=2,
        val_tolerance=99, min_epochs=3)
    assert np.isfinite(val_loss)
    # legacy weights checkpoints written per epoch
    assert os.path.exists(tmp_path / "out" / "1.weights")
    assert os.path.exists(tmp_path / "out" / "2.weights")
    # score file for the sweep layer
    assert os.path.exists("logs/result.txt")
    assert float(open("logs/result.txt").read()) == pytest.approx(val_loss)


@pytest.fixture
def rektnet_train_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    img_dir = tmp_path / "cones"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    names, cells = [], []
    for i in range(8):
        name = f"c{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (50, 36, 3), np.uint8)).save(img_dir / name)
        names.append(name)
        pts = [(int(rng.integers(1, 35)), int(rng.integers(1, 49))) for _ in range(7)]
        cells.append([f"({p[0]},{p[1]})" for p in pts])
    cols = ["img", "other", "top", "mid_L_top", "mid_R_top", "mid_L_bot",
            "mid_R_bot", "bot_L", "bot_R"]
    csv_path = tmp_path / "rektnet_label.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for n, c in zip(names, cells):
            w.writerow([n, "x"] + c)
    return str(csv_path), str(img_dir) + os.sep, tmp_path


def test_rektnet_driver_end_to_end(rektnet_train_env):
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.train import rektnet_driver

    csv_path, img_dir, tmp_path = rektnet_train_env
    best = rektnet_driver.main(
        train_dataset_uri=csv_path, dataset_path=img_dir,
        output_path=str(tmp_path / "out"), batch_size=4, num_epochs=2,
        lr=1e-3, validation_ratio=0.25, checkpoint_interval=2,
        study_name="teststudy", include_geo=True,
        geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05)
    assert np.isfinite(best)
    # .pt checkpoint in reference layout, loadable by our torch importer
    pts = [f for f in os.listdir(tmp_path / "out") if f.endswith(".pt")]
    assert pts, "expected a .pt checkpoint"
    params, state = rektnet.load_torch_checkpoint(str(tmp_path / "out" / pts[0]))
    assert params["stem"]["w"].shape == (7, 7, 3, 16)
    # score file from print_kpt_l2_distance
    assert os.path.exists("logs/teststudy.txt")


def test_rektnet_pt_roundtrip(tmp_path):
    """save_rektnet_pt → load_torch_checkpoint must be the identity."""
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.train.checkpoints import save_rektnet_pt

    params, state = rektnet.init(jax.random.PRNGKey(3))
    p = str(tmp_path / "m.pt")
    save_rektnet_pt(p, params, state, epoch=5)
    params2, state2 = rektnet.load_torch_checkpoint(p)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _saved_epoch(out):
    from mit_driverless_cv_traininginfra.train.checkpoints import STATE_FILE

    with np.load(os.path.join(out, STATE_FILE)) as data:
        return int(data["meta_epoch"])


def test_state_roundtrip(tmp_path):
    """save_state → restore_state is the identity on a TrainState, keeps
    the metadata, and leaves no temp file behind."""
    import optax

    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.train.checkpoints import (
        restore_state,
        save_state,
    )
    from mit_driverless_cv_traininginfra.train.steps import init_train_state

    params, state = rektnet.init(jax.random.PRNGKey(0))
    ts = init_train_state(params, state, optax.adam(1e-3))
    path = str(tmp_path / "state.npz")
    save_state(path, ts, epoch=3)
    assert os.listdir(tmp_path) == ["state.npz"]
    like = init_train_state(*rektnet.init(jax.random.PRNGKey(1)),
                            optax.adam(1e-3))
    out, meta = restore_state(path, like)
    assert meta == {"epoch": 3}
    assert type(out) is type(ts)
    for a, b in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_restore_rejects_other_shapes(tmp_path):
    from mit_driverless_cv_traininginfra.train.checkpoints import (
        restore_state,
        save_state,
    )

    path = str(tmp_path / "state.npz")
    save_state(path, {"w": np.zeros((3, 4), np.float32)}, epoch=1)
    with pytest.raises(ValueError, match="leaf 0"):
        restore_state(path, {"w": np.zeros((4, 3), np.float32)})
    with pytest.raises(ValueError, match="leaf 0"):
        restore_state(path, {"w": np.zeros((3, 4), np.int32)})
    with pytest.raises(ValueError, match="leaves"):
        restore_state(path, {"w": np.zeros((3, 4), np.float32),
                             "b": np.zeros((4,), np.float32)})


def test_require_torch_fails_early(monkeypatch):
    import importlib.util

    from mit_driverless_cv_traininginfra.train import checkpoints

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "torch"
                        else real(name, *a))
    with pytest.raises(RuntimeError, match="needs torch"):
        checkpoints.require_torch("save_checkpoints")


def test_hyper_study_tpe(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from mit_driverless_cv_traininginfra.hyper.search import TPESampler, create_study

    calls = []

    def objective(trial):
        x = trial.suggest_uniform("x", -5.0, 5.0)
        kind = trial.suggest_categorical("kind", ["a", "b"])
        val = (x - 2.0) ** 2 + (0.0 if kind == "a" else 1.0)
        calls.append(val)
        return val

    study = create_study("s1", storage_dir=str(tmp_path / "studies"), seed=0)
    study.optimize(objective, n_trials=25)
    best = study.best_trial
    assert best is not None and best["value"] < 1.5
    assert abs(best["params"]["x"] - 2.0) < 1.5
    # create-or-join: a second handle sees the same trials
    study2 = create_study("s1", storage_dir=str(tmp_path / "studies"))
    assert len(study2.trials) == 25
    # TPE outperforms the random phase on average
    sampler = study.sampler
    assert isinstance(sampler, TPESampler)
    assert np.mean(calls[-10:]) < np.mean(calls[:10])


def test_yolo_driver_resume(yolo_train_env):
    """Full-state resume: second run continues from the saved epoch."""
    from mit_driverless_cv_traininginfra.train import yolo_driver

    cfg_path, img_dir, tmp_path = yolo_train_env
    out = str(tmp_path / "out_resume")
    kw = dict(model_cfg=cfg_path, weights_path=None, output_path=out,
              dataset_path=img_dir, batch_size=4, checkpoint_interval=1,
              lr=1e-4, gamma=0.95, vanilla_anchor=True, ts=False,
              num_workers=2, val_tolerance=99, min_epochs=3)
    yolo_driver.main(num_epochs=1, **kw)
    assert _saved_epoch(out) == 1
    yolo_driver.main(num_epochs=2, resume=True, **kw)
    # epoch 1 already done → resumed run only writes epoch 2 weights
    assert os.path.exists(os.path.join(out, "2.weights"))
    assert _saved_epoch(out) == 2


def test_yolo_driver_device_aug(yolo_train_env):
    """On-device augmentation path: full epoch trains with finite loss."""
    from mit_driverless_cv_traininginfra.train import yolo_driver

    cfg_path, img_dir, tmp_path = yolo_train_env
    val_loss = yolo_driver.main(
        model_cfg=cfg_path, weights_path=None,
        output_path=str(tmp_path / "out_devaug"), dataset_path=img_dir,
        batch_size=4, num_epochs=1, checkpoint_interval=1, lr=1e-4,
        vanilla_anchor=True, ts=False, num_workers=2, val_tolerance=99,
        min_epochs=3, device_aug=True, mixed_precision=True)
    assert np.isfinite(val_loss)


def test_rektnet_driver_device_targets(rektnet_train_env):
    from mit_driverless_cv_traininginfra.train import rektnet_driver

    csv_path, img_dir, tmp_path = rektnet_train_env
    best = rektnet_driver.main(
        train_dataset_uri=csv_path, dataset_path=img_dir,
        output_path=str(tmp_path / "out_dt"), batch_size=4, num_epochs=1,
        lr=1e-3, validation_ratio=0.25, study_name="dtstudy",
        loss_type="l2_heatmap", device_targets=True, mixed_precision=True,
        save_checkpoints=False)
    assert np.isfinite(best)


def test_rektnet_driver_resume(rektnet_train_env):
    from mit_driverless_cv_traininginfra.train import rektnet_driver

    csv_path, img_dir, tmp_path = rektnet_train_env
    out = str(tmp_path / "out_resume")
    kw = dict(train_dataset_uri=csv_path, dataset_path=img_dir,
              output_path=out, batch_size=4, lr=1e-3, validation_ratio=0.25,
              study_name="rstudy", checkpoint_interval=2,
              save_checkpoints=True)
    rektnet_driver.main(num_epochs=2, **kw)
    assert _saved_epoch(out) == 2
    rektnet_driver.main(num_epochs=4, resume=True, **kw)
    assert _saved_epoch(out) == 4


def test_study_marks_failed_trial_before_propagating(tmp_path):
    """An objective error that is not a CalledProcessError (missing score
    file, garbage float, Ctrl-C) must mark the trial FAIL in shared
    storage BEFORE the exception propagates — no ghost RUNNING trial for
    other workers to see (optuna contract)."""
    import pytest

    from mit_driverless_cv_traininginfra.hyper.search import create_study

    study = create_study("sfail", storage_dir=str(tmp_path / "studies"))

    def objective(trial):
        trial.suggest_uniform("lr", 0.0, 1.0)
        raise FileNotFoundError("logs/result.txt")

    with pytest.raises(FileNotFoundError):
        study.optimize(objective, n_trials=3)
    trials = study.trials
    assert len(trials) == 1
    assert trials[0]["state"] == "FAIL"
    assert trials[0]["params"]["lr"] is not None
