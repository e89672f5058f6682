import os

import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models.darknet import (
    detections,
    fold_bn,
    init_params,
)
from mit_driverless_cv_traininginfra.models.quantize import (
    calibrate,
    detections_int8,
    quantize_params,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _setup():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    folded = fold_bn(params, state, spec)
    cal = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)),
                      jnp.float32)
    amax = calibrate(spec, folded, cal)
    return spec, folded, amax


def test_quantize_params_structure():
    spec, folded, amax = _setup()
    q = quantize_params(spec, folded, amax)
    # every conv input saw calibration
    assert set(amax) == set(q)
    n_int8 = sum(1 for v in q.values() if "wq" in v)
    n_pass = sum(1 for v in q.values() if "w" in v)
    assert n_pass == 2  # the two preyolo heads stay bf16
    assert n_int8 == len(q) - 2
    some = next(v for v in q.values() if "wq" in v)
    assert some["wq"].dtype == jnp.int8
    assert int(jnp.max(jnp.abs(some["wq"].astype(jnp.int32)))) <= 127
    # per-channel scale shape
    assert some["scale"].shape == (some["wq"].shape[-1],)


def test_int8_forward_tracks_f32():
    spec, folded, amax = _setup()
    q = quantize_params(spec, folded, amax, act_dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)),
                    jnp.float32)
    ref = np.asarray(detections(spec, folded, {}, x))
    got = np.asarray(detections_int8(spec, q, x, act_dtype=jnp.float32))
    # int8 PTQ on random (worst-case) weights: bounded confidence drift
    conf_ref, conf_got = ref[0, :, 4], got[0, :, 4]
    assert np.abs(conf_ref - conf_got).mean() < 0.05
    assert np.corrcoef(conf_ref, conf_got)[0, 1] > 0.9
    # centre coords bounded within a grid cell's scale
    assert np.abs(ref[0, :, 0] - got[0, :, 0]).mean() < 2.0


def test_calibration_covers_all_convs():
    spec, folded, amax = _setup()
    n_convs = sum(1 for b in spec.blocks
                  if type(b).__name__ == "ConvBlock")
    assert len(amax) == n_convs
    assert all(v > 0 for v in amax.values())


def test_packed_stem_quantization_tracks_f32():
    from mit_driverless_cv_traininginfra.models.quantize import (
        _qconv,
        quantize_packed_stem,
    )
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        apply_packed_stem,
        build_packed_stem,
        pack_input,
    )
    from mit_driverless_cv_traininginfra.config.cfg_factory import yolov3_cfg
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".cfg", delete=False) as f:
        f.write(yolov3_cfg(width=64, height=64, classes=1))
        path = f.name
    spec = load_network_spec(path, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(3))
    folded = fold_bn(params, state, spec)
    packed = build_packed_stem(folded)
    x = jnp.asarray(np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)),
                    jnp.float32)
    ref = apply_packed_stem(packed, x, spec.net.leaky_slope)
    amax = calibrate(spec, folded, x)
    sq = quantize_packed_stem(packed, amax)
    h = _qconv(pack_input(x), sq["c1"], 1, 1, jnp.float32)
    h = jnp.where(h >= 0, h, h * spec.net.leaky_slope)
    got = _qconv(h, sq["c2"], 1, [(1, 0), (1, 0)], jnp.float32)
    got = jnp.where(got >= 0, got, got * spec.net.leaky_slope)
    err = np.abs(np.asarray(ref) - np.asarray(got))
    assert err.mean() < 0.02 * float(jnp.abs(ref).mean() + 1e-6)


def test_rektnet_int8_tracks_f32():
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.quantize import (
        apply_rektnet_int8,
        calibrate_rektnet,
        quantize_rektnet_params,
    )

    params, state = rektnet.init(jax.random.PRNGKey(5))
    folded = rektnet.fold_bn(params, state)
    crops = jnp.asarray(np.random.default_rng(6).uniform(0, 1, (4, 80, 80, 3)),
                        jnp.float32)
    amax = calibrate_rektnet(folded, crops)
    q = quantize_rektnet_params(folded, amax)
    _, pts_ref = rektnet.apply_folded(folded, crops)
    _, pts_q = apply_rektnet_int8(q, crops, act_dtype=jnp.float32)
    # keypoints move by at most a few grid cells under int8 PTQ on
    # random (worst-case) weights
    assert float(jnp.abs(pts_ref - pts_q).mean()) < 0.05


def test_quantize_params_rejects_missing_amax():
    """A calibration dict that doesn't cover a conv must raise, not
    silently quantize with amax=1.0 (input scale 1/127 saturates any
    |x|>1 activation)."""
    import pytest

    from mit_driverless_cv_traininginfra.config.darknet_cfg import (
        ConvBlock,
    )

    spec, folded, amax = _setup()
    first_q = next(str(i) for i, b in enumerate(spec.blocks)
                   if isinstance(b, ConvBlock) and not b.is_preyolo)
    broken = {k: v for k, v in amax.items() if k != first_q}
    with pytest.raises(KeyError, match="calibration amax missing"):
        quantize_params(spec, folded, broken)
