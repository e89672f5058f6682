#!/usr/bin/env python3
"""Smoke run of the two-stage perception stack on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
full width of the flagship model (YOLOv3 at 416², config/flagship.py →
fixed-shape NMS → ROI crop → RektNet 80² keypoints), with random weights
made from fixed seeds:

- reference: the plain f32 pipeline at ``highest`` matmul precision on the
  GPU against the same program on the CPU backend; the bf16 and int8
  serving configurations against it stage by stage, each stage on the
  reference's input; one YOLO train step's loss and gradients on the GPU
  against the CPU;
- serve_bf16 / serve_int8: ``TwoStageServer`` over the BN-folded models,
  warmed up, then a few B=128 batches; no compile after warmup;
- train_yolo / train_rektnet: ``cli.yolo_train`` and ``cli.rektnet_train``
  on a small rendered disk dataset, one checkpoint, one resume.

Each comparison's tolerance is stated in ``TOLERANCES``; where a check has
a control, a deliberately wrong program goes through the same check and
the run fails unless the check rejects it. Every reading line starts with
the card's name and power limit. The last line of standard output is one
JSON object, ``{"ok": true, "device": {...}}``. Any failed phase raises,
so the script exits non-zero and prints no result; it also refuses to run
where JAX finds no GPU.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # only the four-GPU phase: DP train step
                                  # and mesh-sharded serving vs one GPU
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.abspath(__file__))
SINGLE_PHASES = ("reference", "serve_bf16", "serve_int8", "train_yolo",
                 "train_rektnet")
FOUR_PHASES = ("four",)

# Tolerances of the comparisons, each with the precision it applies to.
# Where a control is named, chip_smoke feeds a deliberately wrong program
# through the same check every run and fails unless the check rejects it.
TOLERANCES = {
    # f32 at "highest" on the GPU vs the CPU backend: the same program,
    # rounding only; boxes in frame pixels (0.0069 and 0.0264 px were
    # measured on H100s)
    "f32_gpu_vs_cpu_px": 0.05,
    # keypoints through the whole pipeline, GPU vs CPU: median over points
    # (a box shift of ~1e-2 px can move a peak of an untrained, peaked
    # heatmap; the maximum is reported)
    "f32_gpu_vs_cpu_kpt_median_px": 0.05,
    # detector, stage by stage with every stage's input pinned to the f32
    # reference's (the entry/stem path, then each conv): the largest
    # relative RMS error of a stage's output. Pinning keeps the untrained
    # network's amplification out (end to end, a 2^-8 input change moves
    # its heads by ~20%). Control: every conv's weights (bf16) or dequant
    # scale (int8) off by CONTROL_SCALE
    "detector_stage_rel_rms_bf16": 0.02,
    "detector_stage_rel_rms_int8": 0.1,
    # keypoint net on the same crops: relative RMS error of the heatmap
    # logits, and the median keypoint error in pixels of the 80² crop (the
    # untrained heatmaps are peaked, so a small logit error can move a
    # peak: the maximum is reported, the median is checked)
    "kpt_logit_rel_rms_bf16": 0.06,
    "kpt_logit_rel_rms_int8": 0.2,
    "kpt_px_bf16": 1.0,
    "kpt_px_int8": 3.0,
    # YOLO train step at "highest", GPU vs CPU, on targets in distinct
    # cells (colliding targets alone move the loss by 3.6e-3: see
    # distinct_cell_targets): relative error of the loss and of the
    # gradient norms (global, and per leaf over the leaves that carry
    # ≥1e-3 of the global norm). f32 rounding alone sets a floor: on the
    # CPU, frames perturbed by 1e-6 / 1e-5 relative read loss 1.1e-6 /
    # 2.9e-5, global 5.8e-4 / 4.2e-4, leaf 9.0e-3 / 1.5e-2 (the train-mode
    # backward of the untrained network cancels heavily); by 1e-3, the
    # scale of TF32 rounding, 3.2e-4, 1.2e-2 and 0.19. Control: the same
    # step on the GPU at default precision (TF32 convolutions) must fail
    # at least one of the three
    "train_loss_rel": 1e-4,
    "train_grad_norm_rel_global": 5e-3,
    "train_grad_norm_rel_leaf": 6e-2,
    # four GPUs vs one at "highest" (same global batch): the same readings
    # (four virtual CPU devices vs one read 1.4e-6, 1.1e-3, 8.8e-3), and
    # the served boxes (max) and keypoints (median) in pixels
    "dp_loss_rel": 1e-4,
    "dp_grad_norm_rel_global": 5e-3,
    "dp_grad_norm_rel_leaf": 6e-2,
    "mesh_serve_px": 0.05,
}
# the controls' error: weights or dequant scales a quarter off
CONTROL_SCALE = 1.25


class SmokeFailure(RuntimeError):
    """A phase's output broke its check."""


@dataclasses.dataclass(frozen=True)
class Config:
    """Sizes of one smoke run. The defaults are the flagship's."""

    size: int = 416              # detector input edge (config/flagship.py)
    cfg_path: Optional[str] = None   # None: the flagship YOLOv3 at `size`
    batch: int = 128             # serving batch
    serve_batches: int = 6
    crop_capacity: int = 768     # warmed crop bucket (6 crops per frame)
    max_det: int = 16
    cand_per_frame: int = 6      # pre-NMS candidates/frame at conf_thresh
    bn_calib_iters: int = 25
    train_batch: int = 8         # cli.yolo_train batch
    train_images: int = 16       # → 2 steps per epoch
    rekt_batch: int = 32         # cli.rektnet_train batch
    rekt_images: int = 64        # → 2 steps per epoch
    ref_batch: int = 4           # GPU vs CPU pipeline comparison
    grad_batch: int = 2          # GPU vs CPU train-step comparison,
    grad_size: int = 256         # at full width, smaller frames
    dp_batch: int = 8            # four-GPU train step, global batch
    four_batch: int = 32         # four-GPU serving batch
    seed: int = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (needs 4 GPUs)")
    ap.add_argument("--workdir", default=os.path.join(ROOT, "outputs",
                                                      "chip_smoke"),
                    help="scratch directory for the rendered datasets and "
                         "training outputs")
    return ap.parse_args(argv)


def phases_for(args: argparse.Namespace) -> Sequence[str]:
    return FOUR_PHASES if args.four else SINGLE_PHASES


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def card_info() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi (a child
    process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    if not lines:
        raise SmokeFailure("nvidia-smi printed no card")
    return lines[0]


# ---------------------------------------------------------------------------
# readings
# ---------------------------------------------------------------------------


class Reporter:
    """Prints one reading line per call, prefixed by the card."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, **readings) -> None:
        parts = []
        for k, v in readings.items():
            parts.append(f"{k}={v}")
        print(f"[{phase}] card=({self.card}) " + " ".join(parts), flush=True)

    def check(self, phase: str, name: str, value: float, limit: float,
              precision: str) -> None:
        ok = math.isfinite(value) and value <= limit
        self(phase, check=name, precision=precision, value=float(value),
             tolerance=limit, ok=ok)
        if not ok:
            raise SmokeFailure(f"{phase}: {name} = {value} exceeds {limit} "
                               f"({precision})")

    def control(self, phase: str, name: str, checks, precision: str) -> None:
        """A deliberately wrong program's readings, ``[(check, value,
        limit), ...]``: at least one must fail its check, or the check
        could not catch that fault and the run fails."""
        failed = 0
        for check, value, limit in checks:
            try:
                self.check(phase, f"control:{name}:{check}", value, limit,
                           precision)
            except SmokeFailure:
                failed += 1
        if not failed:
            raise SmokeFailure(f"{phase}: control {name} passed every check "
                               f"({precision}): the checks cannot catch it")


def memory_reading(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "n/a"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ",".join(f"{f.replace('_size_in_bytes', '')}:{getattr(ma, f, None)}"
                    for f in fields)


def device_memory(dev) -> Dict[str, Optional[int]]:
    from mit_driverless_cv_traininginfra.utils.profiling import (
        device_memory_stats,
    )

    stats = device_memory_stats().get(str(dev), {})
    return {k: stats.get(k) for k in ("peak_bytes_in_use", "bytes_in_use")}


def rel_rms(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(
        np.sqrt(np.mean(a ** 2)), 1e-30))


# ---------------------------------------------------------------------------
# models: random weights from seeds, BN statistics calibrated on frames
# ---------------------------------------------------------------------------


def calibrate_bn_yolo(spec, params, state, frames, iters: int):
    """Running BN statistics of an untrained detector, taken from frames.

    At initialisation the running stats are (0, 1), so eval-mode
    activations grow through the residual stages and the head's logits
    reach ~1e4 (exp overflows in the box decode). Train-mode forwards on
    frames move the running stats to the batch statistics (BN momentum
    0.1), as a few training steps would."""
    import jax

    from mit_driverless_cv_traininginfra.models.darknet import (
        forward_features,
    )

    step = jax.jit(lambda p, s, x: forward_features(spec, p, s, x,
                                                    train=True)[1])
    for _ in range(iters):
        state = step(params, state, frames)
    return state


def calibrate_bn_rektnet(params, state, crops, iters: int):
    import jax

    from mit_driverless_cv_traininginfra.models import rektnet

    step = jax.jit(lambda p, s, x: rektnet.apply(p, s, x, train=True)[2])
    for _ in range(iters):
        state = step(params, state, crops)
    return state


def flagship_or_cfg(cfg: Config):
    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.config.flagship import flagship_spec

    if cfg.cfg_path is None:
        return flagship_spec(cfg.size)
    return load_network_spec(cfg.cfg_path, vanilla_anchor=True)


def build_models(cfg: Config) -> dict:
    """BN-calibrated random models in the serving forms (folded, head
    sliced to one class, packed stem where the graph admits it), the
    serving frames and the conf threshold shared by every comparison."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mit_driverless_cv_traininginfra.data.synthetic import (
        rektnet_batch,
        yolo_batch,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import (
        detections,
        fold_bn,
        init_params,
    )
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        build_packed_stem,
        slice_preyolo,
        stem_is_packable,
    )

    spec = flagship_or_cfg(cfg)
    rng = np.random.default_rng(cfg.seed)
    calib_frames, _ = yolo_batch(rng, 8, size=cfg.size)
    params, state = init_params(spec, jax.random.PRNGKey(cfg.seed))
    state = calibrate_bn_yolo(spec, params, state, jnp.asarray(calib_frames),
                              cfg.bn_calib_iters)
    rp, rs = rektnet.init(jax.random.PRNGKey(cfg.seed + 1))
    crops, _ = rektnet_batch(rng, 32)
    rs = calibrate_bn_rektnet(rp, rs, jnp.asarray(crops), cfg.bn_calib_iters)

    folded = fold_bn(params, state, spec)
    spec_s, folded = slice_preyolo(spec, folded)
    packed = build_packed_stem(folded) if stem_is_packable(spec_s) else None
    rfold = rektnet.fold_bn(rp, rs)

    frames = [yolo_batch(rng, cfg.batch, size=cfg.size)[0]
              for _ in range(2)]
    with jax.default_matmul_precision("highest"):
        conf = np.asarray(detections(spec_s, folded, {},
                                     jnp.asarray(calib_frames),
                                     with_classes=False)[..., 4])
    # threshold with ~cand_per_frame pre-NMS candidates per frame
    q = 1.0 - cfg.cand_per_frame / conf.shape[1]
    conf_thresh = float(np.quantile(conf, q))
    if not 0.0 < conf_thresh < 1.0:
        raise SmokeFailure(f"objectness saturated: conf threshold "
                           f"{conf_thresh} (BN calibration failed?)")
    bf = lambda t: jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16), t)
    return dict(spec=spec_s, folded=folded, packed=packed, rfold=rfold,
                folded_bf=bf(folded), packed_bf=bf(packed) if packed else None,
                rfold_bf=bf(rfold), calib_frames=calib_frames,
                calib_crops=crops, frames=frames, conf_thresh=conf_thresh)


def quantize_models(models: dict) -> dict:
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.models.quantize import (
        calibrate,
        calibrate_rektnet,
        quantize_packed_stem,
        quantize_params,
        quantize_rektnet_params,
    )
    from mit_driverless_cv_traininginfra.ops.entry import (
        entry_block_applicable,
        quantize_entry,
    )

    spec, folded = models["spec"], models["folded"]
    amax = calibrate(spec, folded, models["calib_frames"])
    return dict(
        yolo_q=quantize_params(spec, folded, amax),
        stem_q=(quantize_packed_stem(models["packed"], amax)
                if models["packed"] is not None else None),
        rekt_q=quantize_rektnet_params(
            models["rfold"], calibrate_rektnet(
                models["rfold"], jnp.asarray(models["calib_crops"]))),
        entry_q=(quantize_entry(folded, amax)
                 if entry_block_applicable(spec) else None))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_serve(cfg: Config, models: dict, precision: str, report,
                dev) -> dict:
    """TwoStageServer warmup + a few batches; returns readings."""
    import jax
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline,
        two_stage_pipeline_int8,
    )
    from mit_driverless_cv_traininginfra.infer.serving import TwoStageServer

    import numpy as np

    phase = f"serve_{precision}"
    spec, cap = models["spec"], cfg.crop_capacity
    policy = AdaptiveCapacity(floor=cap, quantum=32, warmup_capacity=cap)
    kw = dict(conf_thresh=models["conf_thresh"], nms_thresh=0.25,
              max_det=cfg.max_det, policy=policy, observe_every=2)
    frames = [jnp.asarray(f, jnp.bfloat16) for f in models["frames"]]
    if precision == "int8":
        t0 = time.perf_counter()
        q = quantize_models(models)
        report(phase, ptq_calibration_s=time.perf_counter() - t0)
        server = TwoStageServer(spec, yolo_q=q["yolo_q"], stem_q=q["stem_q"],
                                rekt_q=q["rekt_q"], entry_q=q["entry_q"],
                                **kw)
        lowered = two_stage_pipeline_int8.lower(
            spec, q["yolo_q"], q["stem_q"], q["rekt_q"], frames[0],
            conf_thresh=kw["conf_thresh"], nms_thresh=0.25,
            max_det=cfg.max_det, crop_capacity=cap, entry_q=q["entry_q"])
    else:
        server = TwoStageServer(spec, yolo_params=models["folded_bf"],
                                rekt_params=models["rfold_bf"],
                                packed_stem=models["packed_bf"], **kw)
        lowered = two_stage_pipeline.lower(
            spec, models["folded_bf"], {}, models["rfold_bf"], {}, frames[0],
            conf_thresh=kw["conf_thresh"], nms_thresh=0.25,
            max_det=cfg.max_det, packed_stem=models["packed_bf"],
            crop_capacity=cap)
    warm_s = server.warmup([cfg.batch], capacities=[cap])
    mem = memory_reading(lowered.compile())

    outs = []
    t0 = time.perf_counter()
    for i in range(cfg.serve_batches):
        outs.append(server(frames[i % len(frames)]))
    jax.block_until_ready(outs)
    steady_ms = (time.perf_counter() - t0) * 1e3 / cfg.serve_batches
    st = server.stats()
    report(phase, compile_s=warm_s, steady_ms_per_batch=steady_ms,
           batch=cfg.batch, frames_per_s=cfg.batch * 1e3 / steady_ms,
           memory_analysis=mem, **device_memory(dev),
           compiles_after_warmup=st["compiles"],
           capacity=st["current_capacity"], mean_load=st["mean_load"])
    if st["compiles"] != 0:
        raise SmokeFailure(f"{phase}: serving path compiled after warmup: "
                           f"{st['compiles']}")
    n_det = 0
    for out in outs:
        assert_shape(phase, out.boxes, (cfg.batch, cfg.max_det, 4))
        assert_shape(phase, out.keypoints, (cfg.batch, cfg.max_det, 7, 2))
        mask = np.asarray(out.mask)
        n_det += int(mask.sum())
        if not (np.isfinite(np.asarray(out.boxes, np.float32)[mask]).all()
                and np.isfinite(np.asarray(out.keypoints, np.float32)).all()):
            raise SmokeFailure(f"{phase}: non-finite boxes or keypoints")
    if n_det == 0:
        raise SmokeFailure(f"{phase}: no detections in {len(outs)} batches")
    return {"steady_ms": steady_ms}


def assert_shape(phase: str, x, shape) -> None:
    if tuple(x.shape) != tuple(shape):
        raise SmokeFailure(f"{phase}: shape {tuple(x.shape)} != {shape}")


@contextlib.contextmanager
def _quiet(log_path: str):
    """Send a CLI's console output to ``log_path`` (the CLIs tee stdout to
    their own log files; the smoke run's stdout keeps only readings)."""
    with open(log_path, "w") as fh, contextlib.redirect_stdout(fh), \
            contextlib.redirect_stderr(fh):
        yield


def _load_tool(name: str):
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite_losses(phase: str, log_path: str, pattern: str,
                   want: int) -> List[float]:
    with open(log_path) as f:
        vals = [float(m) for m in re.findall(pattern, f.read())]
    if len(vals) < want or not all(math.isfinite(v) for v in vals):
        raise SmokeFailure(f"{phase}: expected {want} finite losses in "
                           f"{log_path}, got {vals}")
    return vals


def _params_changed(phase: str, before, after) -> int:
    import numpy as np

    changed = sum(not np.array_equal(np.asarray(a), np.asarray(b))
                  for a, b in zip(before, after))
    if changed == 0:
        raise SmokeFailure(f"{phase}: no parameter changed")
    return changed


def phase_train_yolo(cfg: Config, workdir: str, report, dev) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mit_driverless_cv_traininginfra.utils.profiling import time_ms
    from mit_driverless_cv_traininginfra import backend
    from mit_driverless_cv_traininginfra.cli import yolo_train
    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.models.darknet import init_params
    from mit_driverless_cv_traininginfra.train.checkpoints import (
        STATE_FILE,
        restore_state,
    )
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
    )

    phase = "train_yolo"
    data = os.path.join(workdir, "yolo_data")
    with _quiet(os.path.join(workdir, "make_yolo_data.log")):
        _load_tool("make_synth_dataset").main([
            "--out", data, "--train", str(cfg.train_images), "--val", "4",
            "--size", str(cfg.size), "--net-size", str(cfg.size)])
    cfg_path = os.path.join(data, f"yolo_synth_{cfg.size}.cfg")
    spec = load_network_spec(cfg_path, vanilla_anchor=True)
    dtype = "bfloat16" if backend.mixed_precision("auto") else "float32"

    # the CLI's step, timed on its own: same spec, optimizer and batch
    params, state = init_params(spec, jax.random.PRNGKey(17))
    tx = make_optimizer("Adam", lr=1e-3)
    imgs, tgts = yolo_batch(np.random.default_rng(1), cfg.train_batch,
                            size=cfg.size)
    imgs, tgts = jnp.asarray(imgs), jnp.asarray(tgts)
    ts = init_train_state(params, state, tx)
    t0 = time.perf_counter()
    compiled = yolo_train_step.lower(spec, tx, ts, imgs, tgts,
                                     compute_dtype=dtype).compile()
    compile_s = time.perf_counter() - t0
    box = [ts]

    def step():
        box[0], loss, _ = yolo_train_step(spec, tx, box[0], imgs, tgts,
                                          compute_dtype=dtype)
        return loss

    step_ms = time_ms(step, 5)
    report(phase, compute_dtype=dtype, batch=cfg.train_batch,
           compile_s=compile_s, steady_ms_per_step=step_ms,
           images_per_s=cfg.train_batch * 1e3 / step_ms,
           memory_analysis=memory_reading(compiled), **device_memory(dev))
    del box, ts

    out = os.path.join(workdir, "yolo_out")
    argv = ["--model_cfg", cfg_path, "--dataset_path",
            os.path.join(data, "images"), "--output_path", out,
            "--batch_size", str(cfg.train_batch), "--val_batch_size", "4",
            "--checkpoint_interval", "1", "--vanilla_anchor",
            "--val_tolerance", "99", "--min_epochs", "3",
            "--num_workers", "4", "--seed", "17"]
    log = os.path.join(workdir, "yolo_train.log")
    t0 = time.perf_counter()
    with _quiet(log):
        yolo_train.main(argv + ["--num_epochs", "1", "--num_steps", "2"])
    first_s = time.perf_counter() - t0
    state_path = os.path.join(out, STATE_FILE)
    like = init_train_state(*init_params(spec, jax.random.PRNGKey(17)), tx)
    ck1, meta1 = restore_state(state_path, like)
    leaves = lambda ts: jax.tree_util.tree_leaves(ts.params)
    n_changed = _params_changed(phase, leaves(like), leaves(ck1))
    t0 = time.perf_counter()
    with _quiet(os.path.join(workdir, "yolo_resume.log")):
        yolo_train.main(argv + ["--num_epochs", "2", "--num_steps", "1",
                                "--resume"])
    resume_s = time.perf_counter() - t0
    ck2, meta2 = restore_state(state_path, like)
    _params_changed(phase, leaves(ck1), leaves(ck2))
    steps = (int(ck1.step), int(ck2.step))
    if (meta1["epoch"], meta2["epoch"]) != (1, 2) or steps != (2, 3):
        raise SmokeFailure(f"{phase}: checkpoints epoch {meta1}/{meta2} "
                           f"steps {steps}, want epochs 1/2 steps 2/3")
    pat = r"train Epoch: \d+, Batch: [^,]+, Total:\s+([^,\s]+)"
    losses = _finite_losses(phase, log, pat, 2)
    losses += _finite_losses(phase, os.path.join(workdir, "yolo_resume.log"),
                             pat, 1)
    report(phase, cli_first_run_s=first_s, cli_resume_run_s=resume_s,
           steps=steps, params_changed=n_changed, loss_per_target=losses,
           checkpoint=os.path.relpath(state_path, ROOT))


def phase_train_rektnet(cfg: Config, workdir: str, report, dev) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mit_driverless_cv_traininginfra.utils.profiling import time_ms
    from mit_driverless_cv_traininginfra import backend
    from mit_driverless_cv_traininginfra.cli import rektnet_train
    from mit_driverless_cv_traininginfra.data.synthetic import rektnet_batch
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.train.checkpoints import (
        STATE_FILE,
        restore_state,
    )
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        rektnet_train_step,
    )

    phase = "train_rektnet"
    data = os.path.join(workdir, "rekt_data")
    val = cfg.rekt_images // 8
    with _quiet(os.path.join(workdir, "make_rekt_data.log")):
        _load_tool("make_synth_dataset").main([
            "--out", data, "--family", "rektnet",
            "--train", str(cfg.rekt_images), "--val", str(val)])
    dtype = "bfloat16" if backend.mixed_precision("auto") else "float32"

    params, state = rektnet.init(jax.random.PRNGKey(17))
    tx = make_optimizer("Adam", lr=1e-1)
    crops, pts = rektnet_batch(np.random.default_rng(2), cfg.rekt_batch)
    crops, pts = jnp.asarray(crops), jnp.asarray(pts)
    hms = jnp.zeros((cfg.rekt_batch, 7, 80, 80), jnp.float32)
    ts = init_train_state(params, state, tx)
    t0 = time.perf_counter()
    compiled = rektnet_train_step.lower(tx, ts, crops, hms, pts,
                                        compute_dtype=dtype).compile()
    compile_s = time.perf_counter() - t0
    box = [ts]

    def step():
        box[0], total, _, _ = rektnet_train_step(tx, box[0], crops, hms, pts,
                                                 compute_dtype=dtype)
        return total

    step_ms = time_ms(step, 10)
    report(phase, compute_dtype=dtype, batch=cfg.rekt_batch,
           compile_s=compile_s, steady_ms_per_step=step_ms,
           crops_per_s=cfg.rekt_batch * 1e3 / step_ms,
           memory_analysis=memory_reading(compiled), **device_memory(dev))
    del box, ts

    out = os.path.join(workdir, "rekt_out")
    # --no_save_checkpoints: the reference-layout .pt files need torch;
    # the full-state resume checkpoint is written regardless
    argv = ["--train_dataset_uri", os.path.join(data, "rektnet_label.csv"),
            "--dataset_path", os.path.join(data, "images"),
            "--output_path", out, "--batch_size", str(cfg.rekt_batch),
            # half a row of slack: the loader floors ratio × rows
            "--validation_ratio",
            f"{(val + 0.5) / (cfg.rekt_images + val):.6f}",
            "--checkpoint_interval", "1", "--study_name", "smoke",
            "--no_save_checkpoints", "--seed", "17"]
    log = os.path.join(workdir, "rekt_train.log")
    t0 = time.perf_counter()
    with _quiet(log):
        rektnet_train.main(argv + ["--num_epochs", "2"])
    first_s = time.perf_counter() - t0
    state_path = os.path.join(out, STATE_FILE)
    like = init_train_state(*rektnet.init(jax.random.PRNGKey(17)), tx)
    ck1, meta1 = restore_state(state_path, like)
    leaves = lambda ts: jax.tree_util.tree_leaves(ts.params)
    n_changed = _params_changed(phase, leaves(like), leaves(ck1))
    t0 = time.perf_counter()
    with _quiet(os.path.join(workdir, "rekt_resume.log")):
        rektnet_train.main(argv + ["--num_epochs", "3", "--resume"])
    resume_s = time.perf_counter() - t0
    ck2, meta2 = restore_state(state_path, like)
    _params_changed(phase, leaves(ck1), leaves(ck2))
    steps = (int(ck1.step), int(ck2.step))
    if (meta1["epoch"], meta2["epoch"]) != (2, 3) or steps[1] <= steps[0]:
        raise SmokeFailure(f"{phase}: checkpoints epoch {meta1}/{meta2} "
                           f"steps {steps}")
    pat = r"Training: MSE/Geometric/Total Loss: [^/]+/[^/]+/(\S+)"
    losses = _finite_losses(phase, log, pat, 2)
    losses += _finite_losses(phase, os.path.join(workdir, "rekt_resume.log"),
                             pat, 1)
    report(phase, cli_first_run_s=first_s, cli_resume_run_s=resume_s,
           steps=steps, params_changed=n_changed, epoch_losses=losses,
           checkpoint=os.path.relpath(state_path, ROOT))


def distinct_cell_targets(batch: int, per_image: int = 5):
    """(batch, per_image, 5) targets ``[class, cx, cy, w, h]`` whose
    centres lie in distinct cells of an 8×8 grid, hence in distinct cells
    of every head's grid (all are finer). ``build_targets`` writes targets
    that share an (anchor, cell) slot with a scatter whose order XLA
    leaves open, so two backends may keep different ones; on these
    targets the loss is one function on every backend."""
    import numpy as np

    if per_image > 8:
        raise ValueError("at most 8 targets per image fit distinct columns")
    t = np.zeros((batch, per_image, 5), np.float32)
    for b in range(batch):
        for k in range(per_image):
            w = 0.04 + 0.03 * ((b + k) % 5)
            t[b, k] = (0, (k + 0.45) / 8, ((3 * b + k) % 8 + 0.55) / 8,
                       w, 1.4 * w)
    return t


def _grad_norms(spec, params, state, imgs, tgts):
    """Loss and per-leaf gradient norms of the YOLO train loss (f32)."""
    import jax
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.models.darknet import (
        forward_features,
    )
    from mit_driverless_cv_traininginfra.models.yolo_loss import yolo_loss

    def loss_fn(p):
        heads, _ = forward_features(spec, p, state, imgs, train=True)
        return yolo_loss(spec, heads, tgts, 2.0, 1.6, 0.1, 25.0)[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, [jnp.sqrt(jnp.sum(g.astype(jnp.float32) ** 2))
                  for g in jax.tree_util.tree_leaves(grads)]


def grad_errors(prefix: str, ref, got):
    """``[(check, value, limit), ...]``: the relative errors of ``got``'s
    loss and gradient norms against ``ref``'s (each ``(loss, [per-leaf
    norm])``) under the ``{prefix}loss_rel`` / ``{prefix}grad_norm_rel_*``
    tolerances."""
    import numpy as np

    loss_r, norms_r = float(ref[0]), np.asarray([float(n) for n in ref[1]])
    loss_g, norms_g = float(got[0]), np.asarray([float(n) for n in got[1]])
    g_r, g_g = np.sqrt((norms_r ** 2).sum()), np.sqrt((norms_g ** 2).sum())
    big = norms_r > 1e-3 * g_r
    per_leaf = np.abs(norms_g[big] - norms_r[big]) / norms_r[big]
    values = (abs(loss_g - loss_r) / abs(loss_r), abs(g_g - g_r) / g_r,
              float(per_leaf.max()))
    names = ("loss_rel", "grad_norm_rel_global", "grad_norm_rel_leaf")
    return [(prefix + n, float(v), TOLERANCES[prefix + n])
            for n, v in zip(names, values)]


def _conv_io(spec, folded, x):
    """Every conv block's input and output (before its activation) in the
    plain BN-folded forward: ``{block index: (input, output)}``."""
    import jax
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.config.darknet_cfg import (
        ConvBlock,
        MaxPoolBlock,
        RouteBlock,
        ShortcutBlock,
        UpsampleBlock,
    )
    from mit_driverless_cv_traininginfra.models.darknet import (
        _leaky,
        _maxpool,
        _upsample,
    )
    from mit_driverless_cv_traininginfra.models.rektnet import conv2d

    io, outs = {}, []
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock):
            p = folded[str(i)]
            y = conv2d(x, p["w"], p["b"], stride=b.stride,
                       padding=(b.size - 1) // 2)
            io[i] = (x, y)
            x = (_leaky(y, spec.net.leaky_slope) if b.activation == "leaky"
                 else jax.nn.relu(y) if b.activation == "ReLU" else y)
        elif isinstance(b, MaxPoolBlock):
            x = _maxpool(x, b.size, b.stride)
        elif isinstance(b, UpsampleBlock):
            x = _upsample(x, b.stride)
        elif isinstance(b, RouteBlock):
            x = jnp.concatenate([outs[li] for li in b.layers], axis=-1)
        elif isinstance(b, ShortcutBlock):
            x = outs[-1] + outs[b.from_layer]
        outs.append(x)
    return io


def detector_stages(spec, precision: str, params, io, frames):
    """The serving configuration's detector, stage by stage on the f32
    reference's inputs: ``{stage: (reference output, output)}``.

    The first stage is what replaces the first blocks on the serving
    path (bf16: the packed stem, blocks 0-1; int8: the entry path,
    blocks 0-4, dequantized), then every later conv on its reference
    input. ``params``: bf16 ``{"folded", "packed"}`` or int8 ``{"yolo_q",
    "entry_q"}``."""
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.models.quantize import _qconv
    from mit_driverless_cv_traininginfra.models.rektnet import conv2d
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        apply_packed_stem,
    )
    from mit_driverless_cv_traininginfra.ops.entry import entry_forward_int8

    bf = jnp.bfloat16
    slope = spec.net.leaky_slope
    x = frames.astype(bf)
    stages, start = {}, 0
    if precision == "bf16" and params["packed"] is not None:
        start = 2
        stages["stem"] = (io[start][0], apply_packed_stem(
            params["packed"], x, slope))
    elif precision == "int8" and params["entry_q"] is not None:
        start = 5
        ep = params["entry_q"]
        stages["entry"] = (io[start][0], entry_forward_int8(
            ep, x, slope).astype(jnp.float32) / ep["sx"][0, 2])
    for i in sorted(k for k in io if k >= start):
        b = spec.blocks[i]
        inp = io[i][0].astype(bf)
        pad = (b.size - 1) // 2
        if precision == "bf16":
            p = params["folded"][str(i)]
            out = conv2d(inp, p["w"], p["b"], stride=b.stride, padding=pad)
        elif "wq" in params["yolo_q"][str(i)]:
            out = _qconv(inp, params["yolo_q"][str(i)], b.stride, pad, bf)
        else:                                   # pre-yolo convs stay bf16
            q = params["yolo_q"][str(i)]
            out = conv2d(inp, q["w"], q["b"], stride=b.stride, padding=pad)
        stages[f"conv{i}"] = (io[i][1], out)
    return stages


def control_params(precision: str, params):
    """``params`` with every conv's weights and bias (bf16) or dequant
    scale and bias (int8) multiplied by CONTROL_SCALE."""
    import jax

    s = CONTROL_SCALE
    if precision == "bf16":
        return {"folded": jax.tree_util.tree_map(lambda v: v * s,
                                                 params["folded"]),
                "packed": params["packed"]}
    yolo_q = {k: ({**q, "scale": q["scale"] * s, "b": q["b"] * s}
                  if "wq" in q else {"w": q["w"] * s, "b": q["b"] * s})
              for k, q in params["yolo_q"].items()}
    return {"yolo_q": yolo_q, "entry_q": params["entry_q"]}


def detector_stage_errors(spec, precision: str):
    """Jitted ``(params, io, frames) → (worst stage, {stage: relative RMS
    error})`` of :func:`detector_stages`, reduced on the device."""
    import jax
    import jax.numpy as jnp

    def errors(params, io, frames):
        return {k: jnp.sqrt(jnp.mean((o.astype(jnp.float32) - r) ** 2)
                            / jnp.maximum(jnp.mean(r ** 2), 1e-30))
                for k, (r, o) in detector_stages(spec, precision, params, io,
                                                 frames).items()}

    fn = jax.jit(errors)

    def run(params, io, frames):
        errs = {k: float(v) for k, v in fn(params, io, frames).items()}
        return max(errs, key=errs.get), errs
    return run


def phase_reference(cfg: Config, models: dict, report, dev) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline,
    )
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import init_params
    from mit_driverless_cv_traininginfra.models.quantize import (
        apply_rektnet_int8,
    )
    from mit_driverless_cv_traininginfra.ops.image import (
        roi_crop_bilinear_indexed,
    )

    phase = "reference"
    cpu = jax.devices("cpu")[0]
    spec = models["spec"]
    frames = np.asarray(models["frames"][0][:cfg.ref_batch], np.float32)
    ref_kw = dict(conf_thresh=models["conf_thresh"], nms_thresh=0.25,
                  max_det=cfg.max_det)

    # 1. plain f32 pipeline at highest: GPU vs the CPU backend
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        gpu = jax.block_until_ready(two_stage_pipeline(
            spec, models["folded"], {}, models["rfold"], {},
            jnp.asarray(frames), **ref_kw))
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = lambda t: jax.device_put(t, cpu)
        host = jax.block_until_ready(two_stage_pipeline(
            spec, on_cpu(models["folded"]), {}, on_cpu(models["rfold"]), {},
            on_cpu(frames), **ref_kw))
        cpu_s = time.perf_counter() - t0
    mask_g, mask_c = np.asarray(gpu.mask), np.asarray(host.mask)
    report(phase, f32_pipeline_gpu_s=gpu_s, f32_pipeline_cpu_s=cpu_s,
           detections=int(mask_g.sum()), frames=cfg.ref_batch)
    if mask_g.sum() == 0 or not np.array_equal(mask_g, mask_c):
        raise SmokeFailure(f"{phase}: detection masks differ or are empty "
                           f"(gpu {mask_g.sum()}, cpu {mask_c.sum()})")
    tol = TOLERANCES["f32_gpu_vs_cpu_px"]
    report.check(phase, "f32_gpu_vs_cpu_boxes_px", float(np.abs(
        np.asarray(gpu.boxes)[mask_g] - np.asarray(host.boxes)[mask_g]).max()),
        tol, "f32 highest")
    kpx = np.abs(np.asarray(gpu.keypoints)[mask_g]
                 - np.asarray(host.keypoints)[mask_g])
    report(phase, f32_gpu_vs_cpu_keypoints_px_max=float(kpx.max()))
    report.check(phase, "f32_gpu_vs_cpu_keypoints_px_median",
                 float(np.median(kpx)),
                 TOLERANCES["f32_gpu_vs_cpu_kpt_median_px"], "f32 highest")

    # 2. bf16 and int8 vs the f32 reference, stage by stage, each stage
    # on the reference's input to it
    q = quantize_models(models)
    x32 = jnp.asarray(frames)
    with jax.default_matmul_precision("highest"):
        io = jax.jit(lambda x: _conv_io(spec, models["folded"], x))(x32)
    stage_params = {
        "bf16": {"folded": models["folded_bf"], "packed": models["packed_bf"]},
        "int8": {"yolo_q": q["yolo_q"], "entry_q": q["entry_q"]}}
    for prec, params in stage_params.items():
        errors = detector_stage_errors(spec, prec)
        tol = TOLERANCES[f"detector_stage_rel_rms_{prec}"]
        worst, errs = errors(params, io, x32)
        # every conv stage of the control is wrong; each alone must fail
        _, c_errs = errors(control_params(prec, params), io, x32)
        c_min = min(v for k, v in c_errs.items() if k.startswith("conv"))
        report(phase, precision=prec, detector_stages=len(errs),
               worst_stage=worst,
               median_stage_rel_rms=float(np.median(list(errs.values()))),
               control_min_conv_stage_rel_rms=c_min)
        report.check(phase, "detector_stage_rel_rms_max", errs[worst], tol,
                     prec)
        report.control(phase, f"scale_x{CONTROL_SCALE}", [
            ("detector_stage_rel_rms_min_conv", c_min, tol)], prec)
    del io

    # the reference's own detections, cropped once in f32: every
    # precision's keypoint net sees the same crops
    crops = roi_crop_bilinear_indexed(
        x32, jnp.asarray(np.asarray(gpu.boxes)[mask_g]),
        jnp.asarray(np.nonzero(mask_g)[0]), 80, 80)      # (N, 80, 80, 3)
    def keypoint_net(prec):
        """crops → (heatmap logits, points in [0,1] crop coords)."""
        if prec == "f32":
            f = lambda c, hm: rektnet.apply_folded(models["rfold"], c,
                                                   hm_only=hm)
        elif prec == "bf16":
            f = lambda c, hm: rektnet.apply_folded(
                models["rfold_bf"], c.astype(jnp.bfloat16), hm_only=hm)
        else:
            f = lambda c, hm: apply_rektnet_int8(
                q["rekt_q"], c.astype(jnp.bfloat16), hm_only=hm)
        return (jax.jit(lambda c: f(c, True))(crops),
                jax.jit(lambda c: f(c, False)[1])(crops))

    with jax.default_matmul_precision("highest"):
        logits_ref, pts_ref = keypoint_net("f32")
    for prec in ("bf16", "int8"):
        logits, pts = keypoint_net(prec)
        px = np.abs(np.asarray(pts, np.float32) - np.asarray(pts_ref)) * 80
        report(phase, keypoints_same_crops_px_max=float(px.max()),
               precision=prec, crops=int(crops.shape[0]))
        report.check(phase, "keypoint_logits_rel_rms",
                     rel_rms(logits_ref, logits),
                     TOLERANCES[f"kpt_logit_rel_rms_{prec}"], prec)
        report.check(phase, "keypoints_same_crops_px_median",
                     float(np.median(px)), TOLERANCES[f"kpt_px_{prec}"], prec)

    # 3. one YOLO train step at highest: GPU vs CPU
    full = flagship_or_cfg(dataclasses.replace(cfg, size=cfg.grad_size))
    params, state = init_params(full, jax.random.PRNGKey(cfg.seed + 2))
    imgs, _ = yolo_batch(np.random.default_rng(3), cfg.grad_batch,
                         size=cfg.grad_size)
    args = (params, state, imgs, distinct_cell_targets(cfg.grad_batch))
    fn = jax.jit(lambda p, s, x, t: _grad_norms(full, p, s, x, t))
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        ref = jax.block_until_ready(fn(*on_cpu(args)))
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = jax.block_until_ready(fn(*args))
        gpu_s = time.perf_counter() - t0
    # the control: the same step at default precision (TF32 on the GPU)
    tf32 = jax.block_until_ready(fn(*args))
    sound = grad_errors("train_", ref, got)
    control = grad_errors("train_", ref, tf32)
    report(phase, train_step_gpu_s=gpu_s, train_step_cpu_s=cpu_s,
           loss_cpu=float(ref[0]), loss_gpu=float(got[0]),
           **{c: v for c, v, _ in sound},
           **{f"default_precision_{c}": v for c, v, _ in control})
    for check, value, limit in sound:
        report.check(phase, check, value, limit, "f32 highest")
    report.control(phase, "gpu_default_precision", control,
                   "f32 default (TF32)")


def phase_four(cfg: Config, models: dict, report, dev) -> None:
    """Four GPUs vs one: the data-parallel YOLO train step and mesh-sharded
    serving on the same global batch, both at f32 ``highest``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mit_driverless_cv_traininginfra.utils.profiling import time_ms
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra.infer.serving import TwoStageServer
    from mit_driverless_cv_traininginfra.models.darknet import init_params
    from mit_driverless_cv_traininginfra.parallel.mesh import (
        make_mesh,
        replicate,
        shard_batch,
    )
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
    )

    phase = "four"
    mesh = make_mesh(4)
    one = jax.devices()[0]
    full = flagship_or_cfg(dataclasses.replace(cfg, size=cfg.grad_size))
    key = jax.random.PRNGKey(cfg.seed + 2)
    gb = cfg.dp_batch                        # global batch
    imgs, _ = yolo_batch(np.random.default_rng(4), gb, size=cfg.grad_size)
    tgts = distinct_cell_targets(gb)
    # the production step as yolo_driver runs it on a mesh, with plain SGD
    # at lr 1 so each parameter's update is its gradient
    tx = make_optimizer("SGD", lr=1.0, momentum=0.0)
    p0 = [np.asarray(v) for v in
          jax.tree_util.tree_leaves(init_params(full, key)[0])]
    # separate buffers for each run: the step donates its state
    fresh = lambda: init_train_state(*init_params(full, key), tx)

    def update_norms(ts):
        return [np.sqrt(((np.asarray(v) - w) ** 2).sum()) for v, w in
                zip(jax.tree_util.tree_leaves(ts.params), p0)]

    x4 = shard_batch(mesh, jnp.asarray(imgs))
    t4 = shard_batch(mesh, jnp.asarray(tgts))
    with jax.default_matmul_precision("highest"):
        ts1, l1, _ = yolo_train_step(full, tx, jax.device_put(fresh(), one),
                                     *jax.device_put((imgs, tgts), one))
        t0 = time.perf_counter()
        ts4, l4, _ = yolo_train_step(full, tx, replicate(mesh, fresh()),
                                     x4, t4)
        jax.block_until_ready(ts4)
        dp_first_s = time.perf_counter() - t0
        dp = grad_errors("dp_", (l1, update_norms(ts1)),
                         (l4, update_norms(ts4)))
        report(phase, dp_global_batch=gb, size=cfg.grad_size,
               **{c: v for c, v, _ in dp})
        for check, value, limit in dp:
            report.check(phase, check, value, limit, "f32 highest")
        if not jax.tree_util.tree_leaves(ts4.params)[0] \
                .sharding.is_fully_replicated:
            raise SmokeFailure(f"{phase}: DP params lost replication")
        box = [ts4]

        def step():
            box[0], loss, _ = yolo_train_step(full, tx, box[0], x4, t4)
            return loss

        dp_ms = time_ms(step, 3)
        report(phase, dp_compile_and_first_s=dp_first_s,
               dp_steady_ms_per_step_f32=dp_ms, **device_memory(dev))
        del box, ts1, ts4

        # mesh-sharded serving vs one device, same f32 models
        kw = dict(yolo_params=models["folded"], rekt_params=models["rfold"],
                  conf_thresh=models["conf_thresh"], nms_thresh=0.25,
                  max_det=cfg.max_det, observe_every=2)
        frames = jnp.asarray(models["frames"][0][:cfg.four_batch],
                             jnp.float32)
        cap = cfg.crop_capacity * cfg.four_batch // cfg.batch
        outs = {}
        for name, mesh_arg in (("one", None), ("four", make_mesh(4))):
            srv = TwoStageServer(
                models["spec"], mesh=mesh_arg,
                policy=AdaptiveCapacity(floor=cap, quantum=32,
                                        warmup_capacity=cap), **kw)
            warm_s = srv.warmup([cfg.four_batch], capacities=[cap])
            ms = time_ms(lambda: srv(frames), 3)
            outs[name] = jax.device_get(srv(frames))
            report(phase, server=name, batch=cfg.four_batch, compile_s=warm_s,
                   steady_ms_per_batch_f32=ms,
                   compiles_after_warmup=srv.stats()["compiles"])
    a, b = outs["one"], outs["four"]
    mask = np.asarray(a.mask)
    if mask.sum() == 0 or not np.array_equal(mask, np.asarray(b.mask)):
        raise SmokeFailure(f"{phase}: mesh-served masks differ or are empty")
    tol = TOLERANCES["mesh_serve_px"]
    report.check(phase, "mesh_serve_boxes_px", float(np.abs(
        np.asarray(a.boxes)[mask] - np.asarray(b.boxes)[mask]).max()),
        tol, "f32 highest")
    kpx = np.abs(np.asarray(a.keypoints)[mask] - np.asarray(b.keypoints)[mask])
    report(phase, mesh_serve_keypoints_px_max=float(kpx.max()))
    report.check(phase, "mesh_serve_keypoints_px_median",
                 float(np.median(kpx)), tol, "f32 highest")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def environment_lines(card: str) -> List[str]:
    import jax

    from mit_driverless_cv_traininginfra.utils.jaxcache import cache_dir

    lines = [f"card: {card}",
             f"jax {jax.__version__} devices={jax.devices()}",
             f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r} "
             f"compile_cache={cache_dir()}"]
    for mod in ("PIL", "cv2", "orbax.checkpoint", "torch", "pandas"):
        ok = importlib.util.find_spec(mod.split(".")[0]) is not None
        if ok and "." in mod:
            try:
                ok = importlib.util.find_spec(mod) is not None
            except ModuleNotFoundError:
                ok = False
        lines.append(f"import {mod}: {'yes' if ok else 'no'}")
    try:
        sys.path.insert(0, ROOT)
        import native

        native.load()
        lines.append("native/cvloader.cc: builds")
    except (OSError, subprocess.CalledProcessError) as e:
        lines.append(f"native/cvloader.cc: does not build ({e})")
    return lines


def run(cfg: Config, phases: Sequence[str], card: str, workdir: str,
        dev) -> None:
    report = Reporter(card)
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    models = build_models(cfg)
    report("setup", models_s=time.perf_counter() - t0,
           conf_thresh=models["conf_thresh"])
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "serve_bf16":
            phase_serve(cfg, models, "bf16", report, dev)
        elif phase == "serve_int8":
            phase_serve(cfg, models, "int8", report, dev)
        elif phase == "train_yolo":
            phase_train_yolo(cfg, workdir, report, dev)
        elif phase == "train_rektnet":
            phase_train_rektnet(cfg, workdir, report, dev)
        elif phase == "reference":
            phase_reference(cfg, models, report, dev)
        elif phase == "four":
            phase_four(cfg, models, report, dev)
        else:
            raise ValueError(f"unknown phase {phase!r}")
        report(phase, phase_wall_s=time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import jax

    need = 4 if args.four else 1
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found {devs}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mit_driverless_cv_traininginfra import backend
    from mit_driverless_cv_traininginfra.utils.jaxcache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = backend.accelerator()
    card = card_info()
    for line in environment_lines(card):
        print(line, flush=True)
    t0 = time.perf_counter()
    run(Config(), phases_for(args), card, args.workdir, dev)
    print(f"card: {card} total_s={time.perf_counter() - t0:.1f}")
    print(result_line(dev.platform, dev.device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
