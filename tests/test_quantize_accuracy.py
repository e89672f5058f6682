"""End-metric bound on int8 PTQ at a HIGH-ACCURACY operating regime
(VERDICT r1 #6 + r2 #3): train the synthetic cone tasks to real
convergence, then compare f32 serving vs the EXACT int8 composition
bench.py uses (fold_bn → calibrate → quantize_params → detections_int8 /
quantize_rektnet_params → apply_rektnet_int8) on mAP and keypoint-L2.

The YOLO regime (r3): separable synthetic cone scenes (max_overlap=0.1 —
overlapping GT boxes beyond the NMS threshold are irreducible misses
that cap recall), 6000 Adam steps at lr 2e-3 with a hold-then-cosine
schedule (the confidence head ramps slowly under the reference's 0.1
object-loss weight; decaying too early freezes conf below the 0.8
operating point). Converges to mAP 0.844 at the REFERENCE operating
point conf 0.8 / NMS 0.25 / IoU 0.5 with every eval image valid
(reference target: mAP 0.8935 on the real dataset, README.md:43-47).

Numbers are quoted in PARITY.md §int8."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from mit_driverless_cv_traininginfra.config import load_network_spec
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
from mit_driverless_cv_traininginfra.models.quantize import (
    apply_rektnet_int8,
    calibrate,
    calibrate_rektnet,
    detections_int8,
    quantize_params,
    quantize_rektnet_params,
)
from mit_driverless_cv_traininginfra.ops.metrics import (
    evaluate_image_batch,
    summarize,
)
from mit_driverless_cv_traininginfra.train.optim import make_optimizer
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    rektnet_train_step,
    yolo_train_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")

# stated bounds (quoted in PARITY.md): PTQ on a converged model must cost
# at most this much of the end metric on the eval batch
MAP_DELTA_BOUND = 0.05
KPT_L2_DELTA_BOUND = 0.01  # normalised crop coords (80px crop → 0.8 px)

# the r3 high-accuracy regime (tools-side study recorded in PERF.md):
# f32 must reach this at the reference's conf-0.8 operating point
MAP_FLOOR_CONF08 = 0.80

SCENES = dict(max_cones=2, min_h=18, max_h=44, max_overlap=0.1)


def _train_yolo(spec, steps=6000, B=8, lr=2e-3, hold_frac=0.67, seed=0):
    params, mstate = init_params(spec, jax.random.PRNGKey(seed))
    hold = int(steps * hold_frac)
    lr_fn = optax.join_schedules(
        [optax.constant_schedule(lr),
         optax.cosine_decay_schedule(lr, steps - hold)], [hold])
    tx = make_optimizer("Adam", lr=lr_fn)
    ts = init_train_state(params, mstate, tx)
    rng = np.random.default_rng(seed)
    pool_i, pool_t = yolo_batch(rng, 256, size=64, **SCENES)
    pool_i, pool_t = jnp.asarray(pool_i), jnp.asarray(pool_t)
    for _ in range(steps):
        idx = rng.integers(0, pool_i.shape[0], B)
        ts, _, _ = yolo_train_step(spec, tx, ts, pool_i[idx], pool_t[idx])
    return ts


@pytest.mark.slow
def test_int8_yolo_map_delta_bounded_high_accuracy():
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    ts = _train_yolo(spec)

    imgs, targets = yolo_batch(np.random.default_rng(99), 16, size=64,
                               **SCENES)
    imgs, targets = jnp.asarray(imgs), jnp.asarray(targets)
    folded = fold_bn(ts.params, ts.model_state, spec)

    # reference operating point: conf 0.8 / NMS 0.25 / IoU 0.5
    # (model_cfg/yolo_baseline.cfg:18-20)
    dets32 = detections(spec, folded, {}, imgs, with_classes=False)
    ev32 = evaluate_image_batch(dets32, targets, 64, 64, conf_thresh=0.8,
                                nms_thresh=0.25, iou_thresh=0.5, top_k=16)
    map32, r32, p32 = summarize(ev32)
    n_valid = int(np.asarray(ev32.valid).sum())

    cal_i, _ = yolo_batch(np.random.default_rng(5), 4, size=64, **SCENES)
    amax = calibrate(spec, folded, jnp.asarray(cal_i))
    q = quantize_params(spec, folded, amax)
    dets8 = detections_int8(spec, q, imgs, with_classes=False)
    ev8 = evaluate_image_batch(dets8, targets, 64, 64, conf_thresh=0.8,
                               nms_thresh=0.25, iou_thresh=0.5, top_k=16)
    map8, r8, p8 = summarize(ev8)

    print(f"int8 bound @conf0.8: mAP f32={map32:.4f} int8={map8:.4f} "
          f"R {r32:.3f}->{r8:.3f} P {p32:.3f}->{p8:.3f} valid={n_valid}/16")
    # high-accuracy convergence gate (r3: raised from the r2 token 0.15)
    assert map32 >= MAP_FLOOR_CONF08, (
        f"f32 failed the high-accuracy regime (mAP {map32} @conf0.8)")
    assert n_valid >= 15, f"conf-0.8 detections missing on {16-n_valid} imgs"
    assert map32 - map8 <= MAP_DELTA_BOUND, (map32, map8)


@pytest.mark.slow
def test_int8_rektnet_kpt_l2_delta_bounded():
    rng = np.random.default_rng(1)
    params, mstate = rektnet.init(jax.random.PRNGKey(1))
    tx = make_optimizer("Adam", lr=3e-3)
    ts = init_train_state(params, mstate, tx)
    pool_i, pool_p = rektnet_batch(rng, 64)
    pool_i, pool_p = jnp.asarray(pool_i), jnp.asarray(pool_p)
    dummy = jnp.zeros((1,), jnp.float32)
    for _ in range(130):  # sized for the 1-CPU host (see PERF.md r3 study)
        idx = rng.integers(0, 64, 8)
        ts, _, _, _ = rektnet_train_step(
            tx, ts, pool_i[idx], dummy, pool_p[idx],
            loss_type="l1_softargmax", synth_target_sigma=1.0)

    ev_i, ev_p = rektnet_batch(np.random.default_rng(9), 16)
    ev_i, ev_p = jnp.asarray(ev_i), np.asarray(ev_p)
    folded = rektnet.fold_bn(ts.params, ts.model_state)

    _, pts32 = rektnet.apply_folded(folded, ev_i)
    l2_32 = float(np.linalg.norm(np.asarray(pts32) - ev_p, axis=-1).mean())

    cal_i, _ = rektnet_batch(np.random.default_rng(6), 16)
    q = quantize_rektnet_params(folded,
                                calibrate_rektnet(folded, jnp.asarray(cal_i)))
    _, pts8 = apply_rektnet_int8(q, ev_i)
    l2_8 = float(np.linalg.norm(np.asarray(pts8, np.float32) - ev_p,
                                axis=-1).mean())

    print(f"int8 bound: kpt-L2 f32={l2_32:.5f} int8={l2_8:.5f}")
    # r3: gate raised from the r2 token 0.15 (random soft-argmax ≈ 0.3;
    # the 130-step recipe converges well below this floor)
    assert l2_32 < 0.08, f"f32 rektnet failed to converge (L2 {l2_32})"
    assert l2_8 - l2_32 <= KPT_L2_DELTA_BOUND, (l2_32, l2_8)
