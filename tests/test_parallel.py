import os

import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.darknet import init_params
from mit_driverless_cv_traininginfra.parallel.mesh import (
    batch_sharding,
    make_mesh,
    pad_batch_to_devices,
    replicate,
    shard_batch,
)
from mit_driverless_cv_traininginfra.train.optim import (
    exponential_lr,
    make_optimizer,
    set_lr,
    step_lr,
)
from mit_driverless_cv_traininginfra.train.steps import (
    init_train_state,
    rektnet_train_step,
    yolo_eval_step,
    yolo_train_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def _targets(B, T=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.zeros((B, T, 5), np.float32)
    t[:, 0, 1:] = rng.uniform(0.2, 0.8, (B, 4)) * [1, 1, 0.3, 0.3]
    return jnp.asarray(t)


def test_yolo_dp_train_step_8_devices():
    mesh = make_mesh(8)
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    tx = make_optimizer("Adam", lr=1e-4)
    ts = init_train_state(params, mstate, tx)
    ts = replicate(mesh, ts)

    B = 16
    imgs = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (B, 64, 64, 3)),
                       jnp.float32)
    tgts = _targets(B)
    imgs = shard_batch(mesh, imgs)
    tgts = shard_batch(mesh, tgts)

    old_leaf = np.asarray(jax.tree_util.tree_leaves(ts.params)[0])
    ts2, loss, comps = yolo_train_step(spec, tx, ts, imgs, tgts)
    assert np.isfinite(float(loss))
    assert comps.shape == (6,)
    new_leaf = np.asarray(jax.tree_util.tree_leaves(ts2.params)[0])
    assert not np.allclose(old_leaf, new_leaf)
    assert int(ts2.step) == 1
    # params remain replicated (same value on all devices)
    leaf = jax.tree_util.tree_leaves(ts2.params)[0]
    assert leaf.sharding.is_fully_replicated

    # eval step runs on the same shardings
    val_loss, val_comps = yolo_eval_step(spec, ts2.params, ts2.model_state, imgs, tgts)
    assert np.isfinite(float(val_loss))


def test_yolo_dp_matches_single_device():
    """DP over 8 virtual devices must produce the same loss/grads as one
    device — the global-batch equivalence check."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    tx = make_optimizer("SGD", lr=1e-2, momentum=0.9)

    B = 8
    imgs = jnp.asarray(np.random.default_rng(2).uniform(0, 1, (B, 64, 64, 3)),
                       jnp.float32)
    tgts = _targets(B, seed=3)

    # train steps donate their state, so give each run its own buffers
    mesh = make_mesh(8)
    ts_b = replicate(mesh, init_train_state(params, mstate, tx))

    params_a, mstate_a = jax.tree_util.tree_map(jnp.array, (params, mstate))
    ts_a = init_train_state(params_a, mstate_a, tx)
    _, loss_single, _ = yolo_train_step(spec, tx, ts_a, imgs, tgts)
    _, loss_dp, _ = yolo_train_step(spec, tx, ts_b, shard_batch(mesh, imgs),
                                    shard_batch(mesh, tgts))
    np.testing.assert_allclose(float(loss_single), float(loss_dp), rtol=1e-5)


def test_rektnet_dp_train_step():
    mesh = make_mesh(8)
    params, mstate = rektnet.init(jax.random.PRNGKey(0))
    tx = make_optimizer("Adam", lr=1e-3)
    ts = replicate(mesh, init_train_state(params, mstate, tx))
    B = 8
    rng = np.random.default_rng(5)
    imgs = shard_batch(mesh, jnp.asarray(rng.uniform(0, 1, (B, 80, 80, 3)), jnp.float32))
    thm = shard_batch(mesh, jnp.asarray(rng.uniform(0, 1, (B, 7, 80, 80)), jnp.float32))
    tpts = shard_batch(mesh, jnp.asarray(rng.uniform(0, 1, (B, 7, 2)), jnp.float32))
    ts2, total, loc, geo = rektnet_train_step(
        tx, ts, imgs, thm, tpts, loss_type="l1_softargmax",
        include_geo=True, geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05,
        cross_batch=False,
    )
    assert np.isfinite(float(total))
    assert int(ts2.step) == 1


def test_schedules_and_set_lr():
    assert step_lr(0.1, 0.5, epoch=2) == 0.025
    assert exponential_lr(0.1, 0.999, epoch=0) == 0.1
    tx = make_optimizer("Adam", lr=1e-3)
    params = {"w": jnp.zeros((3,))}
    st = tx.init(params)
    st = set_lr(st, 5e-4)
    assert abs(float(st.hyperparams["lr"]) - 5e-4) < 1e-9


def test_pad_batch_to_devices():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, n = pad_batch_to_devices(x, 8)
    assert padded.shape == (8, 2) and n == 5
    # repeat-padding wraps onto real samples (zero rows would poison the
    # YOLO loss via log(1e-16) wh targets)
    np.testing.assert_array_equal(padded[5:], x[:3])
    zp, _ = pad_batch_to_devices(x, 8, mode="zero")
    assert zp[5:].sum() == 0


def test_mixed_precision_train_step_tracks_f32():
    """bf16 compute with f32 master weights: one step's update direction
    agrees with the f32 step."""
    spec = load_network_spec(FIXTURE, vanilla_anchor=True)
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    tx = make_optimizer("SGD", lr=1e-2)
    imgs = jnp.asarray(np.random.default_rng(9).uniform(0, 1, (4, 64, 64, 3)),
                       jnp.float32)
    tgts = _targets(4, seed=9)

    ts32 = init_train_state(*jax.tree_util.tree_map(jnp.array, (params, mstate)), tx)
    ts16 = init_train_state(*jax.tree_util.tree_map(jnp.array, (params, mstate)), tx)
    ts32, l32, _ = yolo_train_step(spec, tx, ts32, imgs, tgts)
    ts16, l16, _ = yolo_train_step(spec, tx, ts16, imgs, tgts,
                                   compute_dtype="bfloat16")
    assert abs(float(l32) - float(l16)) / max(abs(float(l32)), 1e-6) < 0.05
    # params stay f32 master copies
    leaf = jax.tree_util.tree_leaves(ts16.params)[0]
    assert leaf.dtype == jnp.float32
    # update direction strongly correlated with the f32 step
    d32 = jnp.concatenate([
        (a - b).ravel() for a, b in zip(jax.tree_util.tree_leaves(ts32.params),
                                        jax.tree_util.tree_leaves(params))])
    d16 = jnp.concatenate([
        (a - b).ravel() for a, b in zip(jax.tree_util.tree_leaves(ts16.params),
                                        jax.tree_util.tree_leaves(params))])
    cos = float(jnp.dot(d32, d16) /
                (jnp.linalg.norm(d32) * jnp.linalg.norm(d16) + 1e-12))
    assert cos > 0.7, cos  # bf16 grads on a random-init net: aligned, not identical
