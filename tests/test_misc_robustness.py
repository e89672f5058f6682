"""Cross-cutting robustness: training determinism per seed and the
grayscale (channels=1) model path (NetConfig.bw, models.py:236-242)."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models.darknet import (
    detections,
    init_params,
)
from mit_driverless_cv_traininginfra.train.optim import make_optimizer
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    yolo_train_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def test_training_is_deterministic_per_seed():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    tx = make_optimizer("Adam", lr=1e-3)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 1, (4, 64, 64, 3)), jnp.float32)
    tgts = np.zeros((4, 2, 5), np.float32)
    tgts[:, 0, 1:] = rng.uniform(0.3, 0.7, (4, 4)) * [1, 1, 0.2, 0.2]
    tgts = jnp.asarray(tgts)

    def run():
        params, ms = init_params(spec, jax.random.PRNGKey(17))
        ts = init_train_state(params, ms, tx)
        losses = []
        for _ in range(3):
            ts, loss, _ = yolo_train_step(spec, tx, ts, imgs, tgts)
            losses.append(float(loss))
        return losses

    a, b = run(), run()
    assert a == b, (a, b)


def test_grayscale_model_path(tmp_path):
    """channels=1 cfg: init, forward and detect all run with 1-channel
    inputs (the reference's bw mode, models.py:236-242)."""
    cfg = open(FIXTURE).read().replace("channels=3", "channels=1")
    p = tmp_path / "bw.cfg"
    p.write_text(cfg)
    spec = load_network_spec(str(p), vanilla_anchor=True)
    assert spec.net.bw
    params, state = init_params(spec, jax.random.PRNGKey(0))
    assert params["0"]["w"].shape[2] == 1
    x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 1)),
                    jnp.float32)
    out = detections(spec, params, state, x)
    assert out.shape[0] == 2 and np.isfinite(np.asarray(out)).all()


def test_grayscale_dataset_emits_single_channel(tmp_path):
    from PIL import Image

    from mit_driverless_cv_traininginfra.data.yolo_csv import (
        YoloCsvRow,
        write_yolo_csv,
    )
    from mit_driverless_cv_traininginfra.data.yolo_dataset import (
        ImageLabelDataset,
    )

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (96, 128, 3),
                                                      np.uint8)).save(
        img_dir / "a.png")
    rows = [YoloCsvRow(image="a.png", width=128, height=96, scale=1.0,
                       boxes=np.array([[30., 20., 40., 25.]], np.float32))]
    write_yolo_csv(str(tmp_path / "t.csv"), rows)
    ds = ImageLabelDataset(str(tmp_path / "t.csv"), str(img_dir), width=64,
                           height=64, ts=False, bw=True)
    _, img, labels = ds[0]
    assert img.shape == (64, 64, 1)


def test_conv_graph_flops_matches_published_yolov3():
    """Analytic FLOP accounting (bench reporting) pinned to darknet's own
    published figure: YOLOv3 at 416x416 = 65.86 BFLOPs."""
    from mit_driverless_cv_traininginfra.config.flagship import flagship_spec
    from mit_driverless_cv_traininginfra.utils.profiling import (
        conv_graph_flops,
        rektnet_flops,
    )

    spec = flagship_spec(416)
    assert abs(conv_graph_flops(spec) / 1e9 - 65.86) < 0.05
    # RektNet: 80x80, no downsampling, 311k params -> ~3.96 GFLOP/crop
    assert abs(rektnet_flops() / 1e9 - 3.957) < 0.01
