"""The CPU-reachable parts of chip_smoke.py: argument parsing, phase
selection, the result line, the checks and their controls, the
comparison helpers on a tiny network, and the refusal to run without a
GPU. The phases themselves need the card."""

import json
import subprocess

import numpy as np
import pytest

import chip_smoke


def test_default_args_select_single_card_phases():
    args = chip_smoke.parse_args([])
    assert not args.four
    assert tuple(chip_smoke.phases_for(args)) == (
        "reference", "serve_bf16", "serve_int8", "train_yolo",
        "train_rektnet")


def test_four_selects_only_its_phase():
    args = chip_smoke.parse_args(["--four"])
    assert args.four
    assert tuple(chip_smoke.phases_for(args)) == ("four",)


def test_workdir_defaults_inside_checkout():
    args = chip_smoke.parse_args([])
    assert args.workdir.startswith(chip_smoke.ROOT)
    assert chip_smoke.parse_args(["--workdir", "/x"]).workdir == "/x"


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_main_without_gpu_fails_and_prints_no_result(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "GPU" in out.err


def test_card_info_takes_first_nvidia_smi_line(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\nsecond card\n", "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    assert chip_smoke.card_info() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls[0][1] == "--query-gpu=name,power.limit"


def test_card_info_without_cards_fails(monkeypatch):
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0, "\n", ""))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.card_info()


def test_reporter_prefixes_card_and_raises_on_broken_check(capsys):
    rep = chip_smoke.Reporter("Card X, 1.00 W")
    rep("p", a=1)
    rep.check("p", "err", 0.5, 1.0, "bf16")
    with pytest.raises(chip_smoke.SmokeFailure, match="err"):
        rep.check("p", "err", 2.0, 1.0, "bf16")
    with pytest.raises(chip_smoke.SmokeFailure):
        rep.check("p", "err", float("nan"), 1.0, "bf16")
    lines = capsys.readouterr().out.splitlines()
    assert all(l.startswith("[p] card=(Card X, 1.00 W) ") for l in lines)
    assert "ok=True" in lines[1] and "ok=False" in lines[2]


def test_rel_rms():
    a = np.ones((4, 4))
    assert chip_smoke.rel_rms(a, a) == 0.0
    assert chip_smoke.rel_rms(a, 1.1 * a) == pytest.approx(0.1)


def test_tolerances_are_stated_for_each_precision():
    tol = chip_smoke.TOLERANCES
    for prec in ("bf16", "int8"):
        for key in ("detector_stage_rel_rms", "kpt_logit_rel_rms", "kpt_px"):
            assert tol[f"{key}_{prec}"] > 0
    # int8 is never held to a tighter bound than bf16
    assert (tol["detector_stage_rel_rms_int8"]
            >= tol["detector_stage_rel_rms_bf16"])
    assert tol["kpt_px_int8"] >= tol["kpt_px_bf16"]
    # the controls' error lies beyond every stage bound it must trip
    assert chip_smoke.CONTROL_SCALE - 1 > 2 * tol["detector_stage_rel_rms_int8"]


def test_control_passes_only_when_a_check_fails(capsys):
    rep = chip_smoke.Reporter("Card X, 1.00 W")
    rep.control("p", "broken", [("a", 0.5, 1.0), ("b", 2.0, 1.0)], "bf16")
    with pytest.raises(chip_smoke.SmokeFailure, match="cannot catch"):
        rep.control("p", "broken", [("a", 0.5, 1.0), ("b", 0.1, 1.0)],
                    "bf16")
    lines = capsys.readouterr().out.splitlines()
    assert all("check=control:broken:" in l for l in lines)


@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("grid", [8, 13, 16, 26, 52])
def test_distinct_cell_targets_never_share_a_cell(batch, grid):
    t = chip_smoke.distinct_cell_targets(batch)
    assert t.shape == (batch, 5, 5)
    assert ((t[..., 1:] > 0) & (t[..., 1:] < 1)).all()
    for img in t:
        cells = {(int(cy * grid), int(cx * grid)) for _, cx, cy, _, _ in img}
        assert len(cells) == len(img)


def test_grad_errors_reads_relative_errors():
    ref = (2.0, [3.0, 4.0, 1e-6])
    errs = dict((n, v) for n, v, _ in chip_smoke.grad_errors(
        "train_", ref, (2.2, [3.0, 4.4, 5.0])))
    assert errs["train_loss_rel"] == pytest.approx(0.1)
    assert errs["train_grad_norm_rel_global"] == pytest.approx(
        (np.sqrt(9 + 4.4 ** 2 + 25) - 5) / 5, rel=1e-6)
    # the third leaf carries < 1e-3 of the global norm: not compared
    assert errs["train_grad_norm_rel_leaf"] == pytest.approx(0.1)
    limits = {n: l for n, _, l in chip_smoke.grad_errors("dp_", ref, ref)}
    assert limits["dp_loss_rel"] == chip_smoke.TOLERANCES["dp_loss_rel"]


@pytest.fixture(scope="module")
def tiny_detector():
    import jax
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.models.darknet import (
        fold_bn,
        forward_features,
        init_params,
    )
    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate,
        quantize_params,
    )

    spec = load_network_spec("tests/fixtures/tiny_test.cfg")
    params, state = init_params(spec, jax.random.PRNGKey(0))
    folded = fold_bn(params, state, spec)
    x = jnp.asarray(np.random.default_rng(0).uniform(
        0, 1, (2, spec.net.height, spec.net.width, 3)), jnp.float32)
    heads = forward_features(spec, folded, {}, x)[0]
    q = quantize_params(spec, folded, calibrate(spec, folded, x))
    bf = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), folded)
    return dict(spec=spec, folded=folded, x=x, heads=heads, params={
        "bf16": {"folded": bf, "packed": None},
        "int8": {"yolo_q": q, "entry_q": None}})


def test_conv_io_replays_the_forward(tiny_detector):
    from mit_driverless_cv_traininginfra.config.darknet_cfg import ConvBlock

    d = tiny_detector
    io = chip_smoke._conv_io(d["spec"], d["folded"], d["x"])
    convs = [i for i, b in enumerate(d["spec"].blocks)
             if isinstance(b, ConvBlock)]
    assert sorted(io) == convs
    np.testing.assert_array_equal(io[convs[0]][0], d["x"])
    # each pre-yolo conv's output is a head (linear activation)
    pre = [io[i][1] for i in convs if d["spec"].blocks[i].is_preyolo]
    for got, want in zip(pre, d["heads"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision,bound", [("bf16", 0.02), ("int8", 0.1)])
def test_detector_stages_sound_and_control(tiny_detector, precision, bound):
    d = tiny_detector
    io = chip_smoke._conv_io(d["spec"], d["folded"], d["x"])
    errors = chip_smoke.detector_stage_errors(d["spec"], precision)
    worst, errs = errors(d["params"][precision], io, d["x"])
    assert len(errs) == len(io)
    assert errs[worst] < bound
    _, c_errs = errors(chip_smoke.control_params(
        precision, d["params"][precision]), io, d["x"])
    # every stage of the control is a quarter off
    for v in c_errs.values():
        assert v == pytest.approx(chip_smoke.CONTROL_SCALE - 1, abs=bound)
