"""Serve CLI (cli/serve.py): warmed TwoStageServer over an image stream.

The reference has no serving runtime (its engines are hand-chained,
README.md:59); this drives ours end-to-end: weights from disk → serving
passes → warmup → batched stream with a short final batch (exercising the
zero-pad batch bucket) → CSV detections + JSON counters.
"""

import json
import os

import jax
import numpy as np
from PIL import Image

from mit_driverless_cv_traininginfra.cli import serve
from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import (
    init_params,
    save_darknet_weights,
)
from mit_driverless_cv_traininginfra.train.checkpoints import (
    save_rektnet_pt,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def test_serve_cli_image_dir(tmp_path, capsys):
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    w = str(tmp_path / "tiny.weights")
    save_darknet_weights(spec, params, state, w)
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    pt = str(tmp_path / "rekt.pt")
    save_rektnet_pt(pt, rp, rs)

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(
            rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
        ).save(src / f"f{i}.png")

    csv = str(tmp_path / "dets.csv")
    rc = serve.main([
        "--source", str(src), "--model_cfg", FIXTURE,
        "--yolo_weights", w, "--rektnet_weights", pt,
        "--precision", "f32", "--batch_size", "2",
        "--conf_thres", "0.1", "--max_det", "4",
        "--capacities", "8", "--output_csv", csv, "--vanilla_anchor",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 5
    assert summary["batch_pads"] == 1      # short final batch rode the pad
    assert summary["compiles"] == 0        # warmup covered every bucket
    assert summary["fps"] > 0
    with open(csv) as f:
        header = f.readline().strip()
    assert header.startswith("frame,det,x1,y1,x2,y2,conf,kp0_x")


def test_serve_cli_uint8_feed_matches_f32(tmp_path, capsys):
    """--feed_uint8 (default) ships uint8 over the wire and normalizes on
    device in f32 — 1-ulp-identical to the host f32/255 feed (XLA folds
    /255 into a reciprocal multiply), far inside the CSV's %.2f rounding,
    so the CSVs must match exactly. Also pins that warmup compiled the
    uint8 program (dtype keys the jit cache): compiles stays 0."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    w = str(tmp_path / "tiny.weights")
    save_darknet_weights(spec, params, state, w)
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    pt = str(tmp_path / "rekt.pt")
    save_rektnet_pt(pt, rp, rs)

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(
            rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
        ).save(src / f"f{i}.png")

    outs = {}
    for name, extra in (("u8", ["--feed_uint8"]),
                        ("f32", ["--no_feed_uint8"])):
        csv = str(tmp_path / f"dets_{name}.csv")
        rc = serve.main([
            "--source", str(src), "--model_cfg", FIXTURE,
            "--yolo_weights", w, "--rektnet_weights", pt,
            "--precision", "f32", "--batch_size", "2",
            "--conf_thres", "0.1", "--max_det", "4",
            "--capacities", "8", "--output_csv", csv, "--vanilla_anchor",
        ] + extra)
        assert rc == 0
        summary = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["compiles"] == 0
        with open(csv) as f:
            outs[name] = f.read()
    assert outs["u8"] == outs["f32"]


def test_serve_cli_synthetic_device_cache(tmp_path, capsys):
    """synthetic:N + --device_cache stages the scenes on the device once
    and cycles them --syn_repeat times: the device-rate measurement mode
    (no per-batch host->device frame transfer). Exercises int8 PTQ
    calibration from the synthetic lead frames too."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    w = str(tmp_path / "tiny.weights")
    save_darknet_weights(spec, params, state, w)
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    pt = str(tmp_path / "rekt.pt")
    save_rektnet_pt(pt, rp, rs)

    rc = serve.main([
        "--source", "synthetic:4", "--syn_repeat", "3",
        "--device_cache", "--inflight", "2",
        "--model_cfg", FIXTURE,
        "--yolo_weights", w, "--rektnet_weights", pt,
        "--precision", "int8", "--batch_size", "2",
        "--calib_frames", "2",
        "--conf_thres", "0.1", "--max_det", "4",
        "--capacities", "8", "--vanilla_anchor",
        "--assert_no_compiles",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 12        # 4 scenes x 3 cycles
    assert summary["compiles"] == 0
    assert summary["calls"] == 6


def test_serve_cli_oversize_tail_and_kernel_flag(tmp_path, capsys):
    """--syn_oversize_tail plumbing: the tail scenes carry a broad
    cone-height mix and serve through the warmed lattice compile-free."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    w = str(tmp_path / "tiny.weights")
    save_darknet_weights(spec, params, state, w)
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    pt = str(tmp_path / "rekt.pt")
    save_rektnet_pt(pt, rp, rs)

    rc = serve.main([
        "--source", "synthetic:6", "--syn_oversize_tail", "4",
        "--model_cfg", FIXTURE,
        "--yolo_weights", w, "--rektnet_weights", pt,
        "--precision", "bf16", "--batch_size", "2",
        "--conf_thres", "0.1", "--max_det", "4",
        "--capacities", "8", "--vanilla_anchor",
        "--assert_no_compiles",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 6
    assert summary["compiles"] == 0


def test_serve_cli_latency_mode(tmp_path, capsys):
    """--latency_mode (VERDICT r4 #3): the race-car operating point —
    frames go through the MicroBatcher one at a time, co-arrivals
    aggregate into warmed 1/2-buckets, every request is fenced, and the
    summary carries client-visible per-frame latency percentiles. The
    CSV detections must match the batched path (batching is
    result-transparent)."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    w = str(tmp_path / "tiny.weights")
    save_darknet_weights(spec, params, state, w)
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    pt = str(tmp_path / "rekt.pt")
    save_rektnet_pt(pt, rp, rs)

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(
            rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
        ).save(src / f"f{i}.png")

    csv_lat = str(tmp_path / "dets_lat.csv")
    rc = serve.main([
        "--source", str(src), "--model_cfg", FIXTURE,
        "--yolo_weights", w, "--rektnet_weights", pt,
        "--precision", "bf16", "--latency_mode",
        "--latency_buckets", "1,2", "--cameras", "2",
        "--conf_thres", "0.1", "--max_det", "4",
        "--capacities", "8", "--output_csv", csv_lat, "--vanilla_anchor",
        "--assert_no_compiles",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mode"] == "latency"
    assert summary["frames"] == 5
    assert summary["compiles"] == 0            # buckets 1 AND 2 were warmed
    lat = summary["request_frame_ms"]
    assert lat is not None and lat["99"] >= lat["50"] > 0
    hist = summary["microbatch"]["bucket_histogram"]
    assert hist["2"] >= 1                      # co-arrivals aggregated
    assert summary["microbatch"]["frames"] == 5

    # result transparency: batched CSV == latency-mode CSV
    csv_b = str(tmp_path / "dets_b.csv")
    rc = serve.main([
        "--source", str(src), "--model_cfg", FIXTURE,
        "--yolo_weights", w, "--rektnet_weights", pt,
        "--precision", "bf16", "--batch_size", "2",
        "--conf_thres", "0.1", "--max_det", "4",
        "--capacities", "8", "--output_csv", csv_b, "--vanilla_anchor",
    ])
    assert rc == 0
    capsys.readouterr()

    def rows(path):
        with open(path) as f:
            lines = f.read().splitlines()[1:]
        return {tuple(l.split(",")[:2]):
                np.array([float(x) for x in l.split(",")[2:] if x != ""])
                for l in lines}

    ra, rb = rows(csv_lat), rows(csv_b)
    assert set(ra) == set(rb)            # same (frame, det) detection set
    for k in ra:
        assert ra[k].size == rb[k].size
        # %.2f CSV rounding + batch-size-dependent XLA schedules in bf16
        np.testing.assert_allclose(ra[k], rb[k], atol=0.51)


def test_serve_cli_mesh_matches_single_device(tmp_path, capsys):
    """--mesh N shards each batch over the first N (virtual CPU) devices;
    the fused pipeline is per-sample independent, so the CSV detections
    must match the single-device run. Also exercises mesh-aware batch
    padding: 5 frames at B=2 leave a short final batch that zero-pads to
    a device multiple instead of compiling a new bucket."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    w = str(tmp_path / "tiny.weights")
    save_darknet_weights(spec, params, state, w)
    rp, rs = rektnet.init(jax.random.PRNGKey(1))
    pt = str(tmp_path / "rekt.pt")
    save_rektnet_pt(pt, rp, rs)

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(
            rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
        ).save(src / f"f{i}.png")

    outs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "2"])):
        csv = str(tmp_path / f"dets_{name}.csv")
        rc = serve.main([
            "--source", str(src), "--model_cfg", FIXTURE,
            "--yolo_weights", w, "--rektnet_weights", pt,
            "--precision", "f32", "--batch_size", "2",
            "--conf_thres", "0.1", "--max_det", "4",
            "--capacities", "8", "--output_csv", csv, "--vanilla_anchor",
        ] + extra)
        assert rc == 0
        summary = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["frames"] == 5
        assert summary["compiles"] == 0
        with open(csv) as f:
            outs[name] = f.read().splitlines()

    assert outs["single"][0] == outs["mesh"][0]          # header
    assert len(outs["single"]) == len(outs["mesh"])
    for a, b in zip(outs["single"][1:], outs["mesh"][1:]):
        fa = [v for v in a.split(",")]
        fb = [v for v in b.split(",")]
        assert fa[:2] == fb[:2]                          # frame, det index
        va = np.array([float(x) for x in fa[2:] if x != ""])
        vb = np.array([float(x) for x in fb[2:] if x != ""])
        assert va.size == vb.size
        np.testing.assert_allclose(va, vb, atol=0.02)    # %.2f CSV rounding
