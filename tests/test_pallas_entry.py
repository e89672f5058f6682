"""int8 serving entry path (ops/entry): correctness on CPU.

The 4×4/s2 conv1 is pinned to the packed-stem conv1, and the whole entry
path to the plain int8 graph of models.quantize.
"""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models.darknet import (
    fold_bn,
    init_params,
)
from mit_driverless_cv_traininginfra.models.quantize import (
    calibrate,
    forward_features_int8,
    quantize_packed_stem,
    quantize_params,
)
from mit_driverless_cv_traininginfra.models.stem_opt import (
    build_packed_stem,
)
from mit_driverless_cv_traininginfra.ops.entry import (
    conv1_4x4_q8,
    entry_block_applicable,
    quantize_entry,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")

# minimal cfg with the real YOLOv3 entry pattern (blocks 0-5) + one head
ENTRY_CFG = textwrap.dedent("""\
    [net]
    width=64
    height=64
    onnx_height=32
    classes=1
    channels=3
    yolo_masks=0,1,2
    yolo_scales=2
    leaky_slope=0.1
    conv_activation=leaky
    conf_thresh=0.8
    nms_thresh=0.25
    iou_thresh=0.5

    [convolutional]
    batch_normalize=1
    filters=32
    size=3
    stride=1
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=2
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=32
    size=1
    stride=1
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=1
    pad=1
    activation=leaky

    [shortcut]
    from=-3
    activation=linear

    [convolutional]
    batch_normalize=1
    filters=128
    size=3
    stride=2
    pad=1
    activation=leaky

    [convolutional]
    size=1
    stride=1
    pad=1
    filters=preyolo
    activation=linear

    [yolo]
    mask = 0,1,2
    anchors = 10,13,  16,30,  33,23
    classes=1
    num=3
""")


def _rand_folded(rng):
    def conv(shape):
        return {"w": rng.standard_normal(shape).astype(np.float32) * 0.1,
                "b": rng.standard_normal(shape[-1]).astype(np.float32) * 0.1}

    return {"0": conv((3, 3, 3, 32)), "1": conv((3, 3, 32, 64)),
            "2": conv((1, 1, 64, 32)), "3": conv((3, 3, 32, 64))}


AMAX = {"0": 1.0, "1": 3.0, "2": 2.0, "3": 2.5, "5": 4.0}


def test_applicability():
    from mit_driverless_cv_traininginfra.config.flagship import (
        flagship_spec,
    )

    assert entry_block_applicable(flagship_spec(416))
    # the tiny test cfg has a maxpool stem — not applicable
    tiny = load_network_spec(FIXTURE, vanilla_anchor=True)
    assert not entry_block_applicable(tiny)


def test_conv1_4x4_matches_packed_stem():
    """The 4×4/s2 reformulation is exactly the packed conv1 (stem_opt):
    same int8 hq, because each output channel holds the same 27 weights
    (same per-channel absmax ⇒ same quant scales)."""
    from mit_driverless_cv_traininginfra.models.quantize import _qconv
    from mit_driverless_cv_traininginfra.models.stem_opt import pack_input

    rng = np.random.default_rng(1)
    folded = _rand_folded(rng)
    ep = quantize_entry(folded, AMAX)
    stem_q = quantize_packed_stem(build_packed_stem(folded), AMAX)
    # bf16 frames: forward_features_int8 casts to act_dtype before the
    # entry path, so both formulations quantize from the same bf16 values
    frames = jnp.asarray(rng.random((2, 64, 64, 3)), jnp.bfloat16)

    hq_new = np.asarray(conv1_4x4_q8(frames, ep, 0.1), np.int32)

    xp = pack_input(jnp.asarray(frames, jnp.bfloat16))
    h = _qconv(xp, stem_q["c1"], 1, 1, jnp.bfloat16)
    h = jnp.where(h >= 0, h, h * 0.1)
    hq_old = np.asarray(jnp.clip(
        jnp.round(h.astype(jnp.float32) * stem_q["c2"]["sx_inv"]),
        -127, 127).astype(jnp.int8), np.int32)

    agree = float((hq_new == hq_old).mean())
    assert agree >= 0.999, agree
    assert np.abs(hq_new - hq_old).max() <= 1


def test_forward_features_integration(tmp_path):
    """forward_features_int8 with entry_q matches the plain int8 path on a
    real (mini) spec end-to-end, within int8-step noise at the head."""
    cfg = tmp_path / "entry.cfg"
    cfg.write_text(ENTRY_CFG)
    spec = load_network_spec(str(cfg), vanilla_anchor=True)
    assert entry_block_applicable(spec)

    params, state = init_params(spec, jax.random.PRNGKey(0))
    folded = fold_bn(params, state, spec)
    rng = np.random.default_rng(3)
    frames = jnp.asarray(rng.random((2, 64, 64, 3)), jnp.float32)
    amax = calibrate(spec, folded, frames)
    yolo_q = quantize_params(spec, folded, amax)
    entry_q = quantize_entry(folded, amax)

    base = forward_features_int8(spec, yolo_q, frames)
    head = forward_features_int8(spec, yolo_q, frames, entry_q=entry_q)

    a = np.asarray(base[0], np.float32)
    b = np.asarray(head[0], np.float32)
    assert a.shape == b.shape
    # early-layer ±1 int8 steps propagate; bound the relative deviation
    scale = np.abs(a).mean() + 1e-3
    assert np.quantile(np.abs(a - b) / scale, 0.999) < 0.15
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def test_applicability_validates_block5(tmp_path):
    """The entry_q consumer hardcodes block 5 as an int8 3×3/s2 conv
    (quantize.forward_features_int8) — a spec whose block 5 is stride 1
    must be rejected by the gate, not silently run at stride 2."""
    from mit_driverless_cv_traininginfra.config import load_network_spec

    bad = "stride=1".join(ENTRY_CFG.rsplit("stride=2", 1))
    cfg = tmp_path / "bad5.cfg"
    cfg.write_text(bad)
    spec = load_network_spec(str(cfg), vanilla_anchor=True)
    assert not entry_block_applicable(spec)


def test_quantize_entry_bf16_conv1_variant(tmp_path):
    """conv1_dtype='bf16' (layout-bound stage; int8 buys nothing on
    3-channel input) must emit the same int8 hq stream within ±1 step of
    the int8 conv1."""

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.models.darknet import (
        fold_bn,
        init_params,
    )
    from mit_driverless_cv_traininginfra.models.quantize import calibrate
    from mit_driverless_cv_traininginfra.ops.entry import (
        conv1_4x4_q8,
        quantize_entry,
    )

    cfg = tmp_path / "entry.cfg"
    cfg.write_text(ENTRY_CFG)
    spec = load_network_spec(str(cfg), vanilla_anchor=True)
    p, s = init_params(spec, jax.random.PRNGKey(0))
    folded = fold_bn(p, s, spec)
    x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)),
                    jnp.float32)
    amax = calibrate(spec, folded, x)
    hq_i = np.asarray(conv1_4x4_q8(x, quantize_entry(folded, amax),
                                   spec.net.leaky_slope), np.int32)
    eq_b = quantize_entry(folded, amax, conv1_dtype="bf16")
    assert "c1_wb" in eq_b and "c1_wq" not in eq_b
    hq_b = np.asarray(conv1_4x4_q8(x, eq_b, spec.net.leaky_slope), np.int32)
    assert hq_b.shape == hq_i.shape
    assert np.abs(hq_b - hq_i).max() <= 1
    assert (hq_b == hq_i).mean() > 0.85
