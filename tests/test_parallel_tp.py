"""Tensor-parallel and spatial-parallel placements over a 2-D (data, model)
mesh must be value-preserving vs the single-device program.

The reference's only parallelism is single-node DataParallel
(CVC-YOLOv3/train.py:193-195) — DP parity lives in test_parallel.py. These
are the scale-out axes beyond parity: the SAME jitted step/forward
functions run under different placements (parallel/mesh.py shard_channels /
shard_spatial) and GSPMD inserts the collectives. Certifying value
preservation here is what lets dryrun_multichip assert them cheaply.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models.darknet import (
    detections,
    init_params,
)
from mit_driverless_cv_traininginfra.parallel.mesh import (
    MODEL_AXIS,
    make_mesh_2d,
    shard_batch,
    shard_channels,
    shard_spatial,
)
from mit_driverless_cv_traininginfra.train.optim import make_optimizer
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    yolo_train_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _targets(B, T=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.zeros((B, T, 5), np.float32)
    t[:, 0, 1:] = rng.uniform(0.2, 0.8, (B, 4)) * [1, 1, 0.3, 0.3]
    return jnp.asarray(t)


def _fresh_state(spec, tx):
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    return init_train_state(*jax.tree_util.tree_map(jnp.array, (params, mstate)), tx)


def test_yolo_tp_dp_train_step_matches_single_device():
    """4x2 (data x model) mesh, conv kernels sharded on out-channels: one
    train step's loss AND updated params must match the single-device step."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    tx = make_optimizer("SGD", lr=1e-2, momentum=0.9)
    B = 8
    rng = np.random.default_rng(11)
    imgs = jnp.asarray(rng.uniform(0, 1, (B, 64, 64, 3)), jnp.float32)
    tgts = _targets(B, seed=12)

    ts_single = _fresh_state(spec, tx)
    ts1, loss_single, _ = yolo_train_step(spec, tx, ts_single, imgs, tgts)
    jax.block_until_ready(ts1.params)

    mesh = make_mesh_2d(4, 2)
    ts_tp = shard_channels(mesh, _fresh_state(spec, tx))
    ts2, loss_tp, _ = yolo_train_step(spec, tx, ts_tp,
                                      shard_batch(mesh, imgs),
                                      shard_batch(mesh, tgts))
    jax.block_until_ready(ts2.params)

    np.testing.assert_allclose(float(loss_single), float(loss_tp), rtol=1e-5)
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(ts1.params),
            jax.tree_util.tree_leaves_with_path(ts2.params)):
        assert ka == kb
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6,
                                   err_msg=jax.tree_util.keystr(ka))
    # TP placement sticks through the donated-state update: a divisible
    # conv kernel must come back SHARDED on 'model', not replicated
    w0 = ts2.params["0"]["w"]
    assert not w0.sharding.is_fully_replicated, w0.sharding
    assert w0.sharding.spec[-1] == MODEL_AXIS, w0.sharding.spec
    # BN running stats shard to match the kernel's out-channels
    st0 = ts2.model_state["0"]["mean"]
    assert st0.sharding.spec[-1] == MODEL_AXIS, st0.sharding.spec


def test_shard_channels_replicates_indivisible_and_scalar_leaves():
    mesh = make_mesh_2d(4, 2)
    tree = {"w": jnp.ones((3,)), "scalar": jnp.zeros(()),
            "b": jnp.ones((4, 8))}
    placed = shard_channels(mesh, tree)
    assert placed["w"].sharding.is_fully_replicated       # 3 % 2 != 0
    assert placed["scalar"].sharding.is_fully_replicated  # 0-d
    assert placed["b"].sharding.spec[-1] == MODEL_AXIS


def test_shard_channels_keypath_allowlist():
    """Only known channel-carrying leaf names shard — a divisible last dim
    alone (e.g. an (N, 2) anchor-like table under mp=2) must replicate."""
    mesh = make_mesh_2d(4, 2)
    tree = {"anchors": jnp.ones((9, 2)), "layer": {"w": jnp.ones((3, 3, 4, 8))}}
    placed = shard_channels(mesh, tree)
    assert placed["anchors"].sharding.is_fully_replicated
    assert placed["layer"]["w"].sharding.spec[-1] == MODEL_AXIS
    # opt-out: positional heuristic only
    placed2 = shard_channels(mesh, tree, key_allow=None)
    assert placed2["anchors"].sharding.spec[-1] == MODEL_AXIS


def test_pipeline_parallel_matches_fused():
    """TwoStagePP (detect stage on cpu:0, keypoint stage on cpu:1) must
    reproduce the fused single-program pipeline exactly: same mask/boxes,
    fp-tolerance keypoints — the device cut may not change values."""
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline,
    )
    from mit_driverless_cv_traininginfra.infer.pp import TwoStagePP
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn

    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(5))
    folded = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16), fold_bn(params, mstate, spec))
    rp, rst = rektnet.init(jax.random.PRNGKey(6))
    rfolded = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16), rektnet.fold_bn(rp, rst))

    rng = np.random.default_rng(7)
    batches = [jnp.asarray(rng.uniform(0, 1, (4, 64, 64, 3)), jnp.bfloat16)
               for _ in range(3)]
    cfg = dict(conf_thresh=0.0, nms_thresh=0.25, max_det=4, crop_size=16,
               crop_capacity=8)

    fused = [two_stage_pipeline(spec, folded, {}, rfolded, {}, fr, **cfg)
             for fr in batches]
    devs = jax.devices()
    pp = TwoStagePP(spec, folded, {}, rfolded, {}, devs[0], devs[1], **cfg)
    got = pp(batches)

    assert len(got) == len(fused)
    for f, g in zip(fused, got):
        np.testing.assert_array_equal(np.asarray(f.mask), np.asarray(g.mask))
        np.testing.assert_allclose(np.asarray(f.boxes, np.float32),
                                   np.asarray(g.boxes, np.float32),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(np.asarray(f.keypoints, np.float32),
                                   np.asarray(g.keypoints, np.float32),
                                   atol=0.5)
        # the stage cut really crossed devices
        assert list(g.keypoints.devices())[0] == devs[1]


def test_pipeline_parallel_capacity_exceeds_slots():
    """Regression (ADVICE r4): crop_capacity > B*max_det used to crash
    detect_stage's top_k ('k must be no larger than size') — with the
    class's OWN defaults on a small batch. The selection width must clamp
    to the slot count and still match the fused dense path."""
    from mit_driverless_cv_traininginfra.infer.pipeline import (
        two_stage_pipeline,
    )
    from mit_driverless_cv_traininginfra.infer.pp import TwoStagePP
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import fold_bn

    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(5))
    folded = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16), fold_bn(params, mstate, spec))
    rp, rst = rektnet.init(jax.random.PRNGKey(6))
    rfolded = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.bfloat16), rektnet.fold_bn(rp, rst))

    rng = np.random.default_rng(17)
    batch = jnp.asarray(rng.uniform(0, 1, (2, 64, 64, 3)), jnp.bfloat16)
    # capacity 64 > B*K = 2*4 = 8 — the crash shape
    cfg = dict(conf_thresh=0.0, nms_thresh=0.25, max_det=4, crop_size=16,
               crop_capacity=64)
    devs = jax.devices()
    pp = TwoStagePP(spec, folded, {}, rfolded, {}, devs[0], devs[1], **cfg)
    got = pp([batch])[0]
    ref = two_stage_pipeline(spec, folded, {}, rfolded, {}, batch,
                             conf_thresh=0.0, nms_thresh=0.25, max_det=4,
                             crop_size=16, crop_capacity=None)
    np.testing.assert_array_equal(np.asarray(ref.mask), np.asarray(got.mask))
    np.testing.assert_allclose(np.asarray(ref.keypoints, np.float32),
                               np.asarray(got.keypoints, np.float32),
                               atol=0.5)


def test_spatial_sharded_forward_matches_single_device():
    """Images sharded (batch over data, HEIGHT over model): the detect
    forward must equal the single-device run — XLA's spatial partitioner
    handles the conv/maxpool/upsample halos."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(3))
    B = 8
    imgs = jnp.asarray(np.random.default_rng(13).uniform(0, 1, (B, 64, 64, 3)),
                       jnp.float32)

    det_fn = jax.jit(lambda p, s, im: detections(spec, p, s, im))
    ref = np.asarray(det_fn(params, mstate, imgs), np.float32)

    mesh = make_mesh_2d(4, 2)
    with mesh:
        out = det_fn(params, mstate, shard_spatial(mesh, imgs))
    got = np.asarray(out, np.float32)
    np.testing.assert_allclose(ref, got, rtol=1e-5, atol=1e-5)
