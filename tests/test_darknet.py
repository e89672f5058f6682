import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models.darknet import (
    _maxpool,
    _upsample,
    decode_head,
    detections,
    fold_bn,
    forward_features,
    init_params,
    load_darknet_weights,
    save_darknet_weights,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _spec():
    return load_network_spec(FIXTURE, vanilla_anchor=True)


def test_init_params_shapes():
    spec = _spec()
    params, state = init_params(spec, jax.random.PRNGKey(0))
    # block 0: 3->8 conv 3x3 with BN
    assert params["0"]["w"].shape == (3, 3, 3, 8)
    assert "bn" in params["0"] and "0" in state
    # preyolo blocks: bias, no BN
    preyolo_keys = [k for k, p in params.items() if "b" in p]
    assert len(preyolo_keys) == 2
    for k in preyolo_keys:
        assert params[k]["w"].shape[-1] == 18
        assert k not in state


def test_forward_features_shapes():
    spec = _spec()
    params, state = init_params(spec, jax.random.PRNGKey(0))
    x = jnp.zeros((2, 64, 64, 3))
    heads, _ = forward_features(spec, params, state, x)
    assert [h.shape for h in heads] == [(2, 16, 16, 18), (2, 32, 32, 18)]


def test_decode_head_zero_logits():
    # zero logits → cx=0.5+grid_x, wh=anchor; checks layout + stride scaling
    anchors = [(10.0, 13.0), (16.0, 30.0), (33.0, 23.0)]
    head = jnp.zeros((1, 2, 2, 3 * 6))
    out = decode_head(head, anchors, img_height=64, num_classes=1)
    assert out.shape == (1, 3 * 2 * 2, 6)
    stride = 64 / 2
    o = np.asarray(out[0])
    # flattening order is (A, H, W): first 4 rows are anchor 0 over the grid
    np.testing.assert_allclose(o[0, :4], [0.5 * stride, 0.5 * stride, 10, 13], rtol=1e-6)
    np.testing.assert_allclose(o[1, :2], [1.5 * stride, 0.5 * stride], rtol=1e-6)
    np.testing.assert_allclose(o[2, :2], [0.5 * stride, 1.5 * stride], rtol=1e-6)
    np.testing.assert_allclose(o[4, 2:4], [16, 30], rtol=1e-6)  # anchor 1 wh
    np.testing.assert_allclose(o[:, 4], 0.5, rtol=1e-6)  # sigmoid(0) conf


def test_detections_concat_shape():
    spec = _spec()
    params, state = init_params(spec, jax.random.PRNGKey(0))
    out = detections(spec, params, state, jnp.zeros((1, 64, 64, 3)))
    assert out.shape == (1, 3 * 16 * 16 + 3 * 32 * 32, 6)


def test_fold_bn_matches_eval_forward():
    spec = _spec()
    params, state = init_params(spec, jax.random.PRNGKey(1))
    # randomise stats so folding is non-trivial
    state = jax.tree_util.tree_map(
        lambda x: x + jax.random.uniform(jax.random.PRNGKey(2), x.shape) * 0.3, state
    )
    x = jax.random.uniform(jax.random.PRNGKey(3), (1, 64, 64, 3))
    heads_full, _ = forward_features(spec, params, state, x)
    folded = fold_bn(params, state, spec)
    heads_fast, _ = forward_features(spec, folded, {}, x)
    # f32 drift compounds through leaky-relu branch flips; feature-level
    # agreement to ~1e-2 abs is the expected folding fidelity
    for a, b in zip(heads_full, heads_fast):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-2)
        assert np.median(np.abs(np.asarray(a) - np.asarray(b))) < 1e-3


def test_maxpool_matches_torch():
    torch = pytest.importorskip("torch")
    x = np.random.default_rng(0).normal(0, 1, (1, 6, 6, 4)).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    # k=2, s=1: reference zero-pads right/bottom then pools (models.py:74-84)
    ours = np.asarray(_maxpool(jnp.asarray(x), 2, 1))
    ref = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(xt, (0, 1, 0, 1)), 2, 1
    ).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    # k=5, s=2 with implicit -inf padding
    ours5 = np.asarray(_maxpool(jnp.asarray(x), 5, 2))
    ref5 = torch.nn.functional.max_pool2d(xt, 5, 2, padding=2).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours5, ref5, atol=1e-6)


def test_upsample_nearest():
    x = jnp.arange(4.0).reshape(1, 2, 2, 1)
    u = np.asarray(_upsample(x, 2))[0, :, :, 0]
    np.testing.assert_array_equal(u, [[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3], [2, 2, 3, 3]])


def test_weights_roundtrip(tmp_path):
    spec = _spec()
    params, state = init_params(spec, jax.random.PRNGKey(4))
    path = str(tmp_path / "w.weights")
    header = np.array([0, 2, 0, 32013, 0], dtype=np.int32)
    save_darknet_weights(spec, params, state, path, header=header)
    params2, state2 = init_params(spec, jax.random.PRNGKey(5))
    # start dims == actual dims → plain load
    loaded, lstate, h = load_darknet_weights(spec, params2, state2, path,
                                             start_weights_dim=(18, 18))
    np.testing.assert_array_equal(h, header)
    flat1 = jax.tree_util.tree_leaves({"p": params, "s": state})
    flat2 = jax.tree_util.tree_leaves({"p": loaded, "s": lstate})
    for a, b in zip(flat1, flat2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_preyolo_warm_start_slicing(tmp_path):
    """80-class→1-class warm start: write a wider preyolo head, load sliced
    (models.py:380-394 semantics: first num_b bias and output filters)."""
    cfg = """[net]
width=32
height=32
onnx_height=32
classes=1
channels=3
yolo_masks=0,1,2
yolo_scales=8
start_weights_dim=255
leaky_slope=0.1
conv_activation=leaky
build_targets_ignore_thresh=0.5
conf_thresh=0.8
nms_thresh=0.25
iou_thresh=0.5

[convolutional]
filters=4
size=3
stride=1

[convolutional]
filters=preyolo
size=1
stride=1

[yolo]
mask=0,1,2
"""
    p = tmp_path / "mini.cfg"
    p.write_text(cfg)
    spec = load_network_spec(str(p), vanilla_anchor=True)
    narrow = 18  # (1+5)*3

    # Hand-build a weights file with a 255-wide head.
    rng = np.random.default_rng(6)
    bn = [rng.normal(size=4).astype(np.float32) for _ in range(4)]
    conv0 = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    bias_wide = rng.normal(size=255).astype(np.float32)
    w_wide = rng.normal(size=(255, 4, 1, 1)).astype(np.float32)
    path = str(tmp_path / "wide.weights")
    with open(path, "wb") as f:
        np.zeros(5, np.int32).tofile(f)
        for a in bn:
            a.tofile(f)
        conv0.tofile(f)
        bias_wide.tofile(f)
        w_wide.tofile(f)

    params, state = init_params(spec, jax.random.PRNGKey(7))
    loaded, lstate, _ = load_darknet_weights(spec, params, state, path,
                                             start_weights_dim=(255,))
    np.testing.assert_array_equal(np.asarray(loaded["1"]["b"]), bias_wide[:narrow])
    got_w = np.transpose(np.asarray(loaded["1"]["w"]), (3, 2, 0, 1))
    np.testing.assert_array_equal(got_w, w_wide[:narrow])
    np.testing.assert_array_equal(np.asarray(loaded["0"]["bn"]["bias"]), bn[0])
    np.testing.assert_array_equal(np.asarray(lstate["0"]["var"]), bn[3])


def test_decode_head_bf16_input_decodes_in_f32():
    """Box decode always runs in f32: on the bf16 serving path pixel
    coordinates reach 416 where bf16's ulp is 2.0 (±1 px center error).
    A bf16 head must decode identically to its f32-cast twin."""
    rng = np.random.default_rng(9)
    # 13×13 head at 416 → stride 32; far cells have cx ≈ 400 px
    raw = rng.normal(0, 2, (2, 13, 13, 18)).astype(np.float32)
    bf = jnp.asarray(raw, jnp.bfloat16)
    anchors = [(10.0, 13.0), (16.0, 30.0), (33.0, 23.0)]
    out_bf = decode_head(bf, anchors, img_height=416, num_classes=1)
    out_f32 = decode_head(bf.astype(jnp.float32), anchors, img_height=416,
                          num_classes=1)
    assert out_bf.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(out_bf), np.asarray(out_f32))
