"""Full-size YOLOv3 weight-file round trip: validates the Darknet
``.weights`` walking order on the real 75-conv graph (not just the tiny
fixture) and the generated baseline cfg end-to-end."""

import os

import numpy as np
import jax
import pytest

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.config.cfg_factory import yolov3_cfg
from mit_driverless_cv_traininginfra.models.darknet import (
    init_params,
    load_darknet_weights,
    save_darknet_weights,
)


@pytest.mark.slow
def test_full_yolov3_weights_roundtrip(tmp_path):
    cfg = tmp_path / "yolo_baseline.cfg"
    cfg.write_text(yolov3_cfg(width=416, height=416, classes=80))
    spec = load_network_spec(str(cfg), vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))

    n_params = sum(int(np.prod(l.shape))
                   for l in jax.tree_util.tree_leaves(params))
    # Darknet-53 + FPN at 80 classes is the canonical ~61.9M parameters
    assert 61_000_000 < n_params < 63_000_000, n_params

    path = str(tmp_path / "full.weights")
    save_darknet_weights(spec, params, state, path)
    # file size: 5 int32 header + one f32 per param incl. BN stats
    n_bn = sum(int(np.prod(l.shape))
               for l in jax.tree_util.tree_leaves(state))
    assert os.path.getsize(path) == 4 * (5 + n_params + n_bn)

    p2, s2 = init_params(spec, jax.random.PRNGKey(1))
    loaded, lstate, _ = load_darknet_weights(
        spec, p2, s2, path, start_weights_dim=(255, 255, 255))
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((loaded, lstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
