import os

import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.config import load_network_spec
from mit_driverless_cv_traininginfra.config.cfg_factory import yolov3_cfg
from mit_driverless_cv_traininginfra.models.darknet import (
    detections,
    fold_bn,
    forward_features,
    init_params,
)
from mit_driverless_cv_traininginfra.models.stem_opt import (
    apply_packed_stem,
    build_packed_stem,
    pack_input,
    stem_is_packable,
)


def _small_yolo_spec(tmp_path):
    cfg = yolov3_cfg(width=64, height=64, classes=1)
    p = tmp_path / "y.cfg"
    p.write_text(cfg)
    return load_network_spec(str(p), vanilla_anchor=True)


def test_pack_input_layout():
    x = jnp.arange(2 * 4 * 4 * 3, dtype=jnp.float32).reshape(2, 4, 4, 3)
    p = pack_input(x)
    assert p.shape == (2, 2, 2, 12)
    # packed channel (p_row, p_col, c): slot 0 = x[0,0], slot 3·? check a few
    np.testing.assert_array_equal(np.asarray(p[0, 0, 0, 0:3]), np.asarray(x[0, 0, 0]))
    np.testing.assert_array_equal(np.asarray(p[0, 0, 0, 3:6]), np.asarray(x[0, 0, 1]))
    np.testing.assert_array_equal(np.asarray(p[0, 0, 0, 6:9]), np.asarray(x[0, 1, 0]))
    np.testing.assert_array_equal(np.asarray(p[0, 0, 0, 9:12]), np.asarray(x[0, 1, 1]))


def test_packed_stem_exact_vs_plain(tmp_path):
    spec = _small_yolo_spec(tmp_path)
    assert stem_is_packable(spec)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    folded = fold_bn(params, state, spec)
    packed = build_packed_stem(folded)

    x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)),
                    jnp.float32)
    # plain: run blocks 0..1 (conv+leaky twice)
    import dataclasses

    sub = dataclasses.replace(spec, blocks=spec.blocks[:2])
    from mit_driverless_cv_traininginfra.models.rektnet import conv2d

    h = conv2d(x, folded["0"]["w"], folded["0"]["b"], stride=1, padding=1)
    h = jnp.where(h >= 0, h, h * spec.net.leaky_slope)
    h = conv2d(h, folded["1"]["w"], folded["1"]["b"], stride=2, padding=1)
    expected = jnp.where(h >= 0, h, h * spec.net.leaky_slope)

    got = apply_packed_stem(packed, x, spec.net.leaky_slope)
    assert got.shape == expected.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), atol=2e-5)


def test_full_detections_with_packed_stem(tmp_path):
    spec = _small_yolo_spec(tmp_path)
    params, state = init_params(spec, jax.random.PRNGKey(2))
    folded = fold_bn(params, state, spec)
    packed = build_packed_stem(folded)
    x = jnp.asarray(np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3)),
                    jnp.float32)
    plain = detections(spec, folded, {}, x)
    fast = detections(spec, folded, {}, x, packed_stem=packed)
    # random-init wh logits pass through exp(), so compare relatively
    # (f32 reassociation drift amplified exponentially on huge values)
    np.testing.assert_allclose(np.asarray(plain), np.asarray(fast),
                               rtol=1e-2, atol=1e-2)


def test_slice_preyolo_preserves_box_conf_outputs(tmp_path):
    from mit_driverless_cv_traininginfra.models.stem_opt import slice_preyolo

    spec = _small_yolo_spec(tmp_path)
    params, state = init_params(spec, jax.random.PRNGKey(5))
    folded = fold_bn(params, state, spec)
    spec_s, folded_s = slice_preyolo(spec, folded)
    assert spec_s.net.num_classes == 0
    x = jnp.asarray(np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)),
                    jnp.float32)
    full = detections(spec, folded, {}, x, with_classes=False)
    sliced = detections(spec_s, folded_s, {}, x, with_classes=False)
    np.testing.assert_allclose(np.asarray(full), np.asarray(sliced),
                               rtol=1e-5, atol=1e-4)


def test_packed_training_stem_matches_plain(tmp_path):
    """train_packed_stem reformulates blocks 0-1 as the space-to-depth
    conv pair with LIVE BatchNorm. The algebra is exact (conv1/conv2 and
    the BN statistics match at 1e-15 in f64 — verified while building
    this); what survives in f32 is the stats' summation-order drift
    (~1e-7 rel), which train-mode BN re-normalization amplifies through
    the 73 downstream layers — the same conditioning bf16 training rides
    at 1e5x the perturbation. Assertions are scoped accordingly: the stem
    itself tight, the deep-graph heads/state at chaotic-amplification
    tolerance, and full-gradient equality on the SHALLOW fixture graph
    where conditioning is mild."""
    import os

    from mit_driverless_cv_traininginfra.models.darknet import (
        _leaky,
        _packed_stem_train,
        batch_norm,
        conv2d,
    )

    spec = _small_yolo_spec(tmp_path)
    assert stem_is_packable(spec)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((2, 64, 64, 3)), jnp.float32)

    # 1) the stem itself: packed == plain to reassociation level
    p0, p1 = params["0"], params["1"]
    y = conv2d(x, p0["w"], None, stride=1, padding=1)
    y, st0 = batch_norm(y, {**p0["bn"], **state["0"]}, True)
    y = _leaky(y, spec.net.leaky_slope)
    out = conv2d(y, p1["w"], None, stride=2, padding=1)
    out, st1 = batch_norm(out, {**p1["bn"], **state["1"]}, True)
    plain_stem = _leaky(out, spec.net.leaky_slope)
    ns = {}
    packed_stem_out = _packed_stem_train(spec, params, state, x, True, ns)
    np.testing.assert_allclose(np.asarray(plain_stem),
                               np.asarray(packed_stem_out),
                               rtol=1e-5, atol=1e-5)
    for plain_stats, key in ((st0, "0"), (st1, "1")):
        from mit_driverless_cv_traininginfra.models.rektnet import (
            update_running,
        )

        want = update_running(state[key], plain_stats)
        for kk in want:
            np.testing.assert_allclose(np.asarray(want[kk]),
                                       np.asarray(ns[key][kk]),
                                       rtol=1e-5, atol=1e-6)

    # 2) deep graph: heads + BN states within chaotic amplification
    h1, s1 = forward_features(spec, params, state, x, train=True)
    h2, s2 = forward_features(spec, params, state, x, train=True,
                              train_packed_stem=True)
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)
    for k in s1:
        for kk in s1[k]:
            np.testing.assert_allclose(np.asarray(s1[k][kk]),
                                       np.asarray(s2[k][kk]),
                                       rtol=2e-3, atol=2e-3)

    # 3) full-gradient equality on the shallow fixture graph (8 convs)
    tiny = load_network_spec(
        os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg"),
        vanilla_anchor=True)
    assert stem_is_packable(tiny)
    tparams, tstate = init_params(tiny, jax.random.PRNGKey(1))

    def loss(p, packed):
        hs, _ = forward_features(tiny, p, tstate, x, train=True,
                                 train_packed_stem=packed)
        return sum(jnp.mean(h ** 2) for h in hs)

    g1 = jax.grad(lambda p: loss(p, False))(tparams)
    g2 = jax.grad(lambda p: loss(p, True))(tparams)
    # per-leaf scale-normalized bound: elementwise rtol is meaningless on
    # near-zero components, where the BN-stats noise lives. The floor is
    # set by batch_norm's DELIBERATE f32 stats accumulation (its mean/var
    # reduce in a different order on the packed layout): measured 2.3e-6
    # scale-relative at f64 (f32-stats term only) and ~1.4e-3 at f32,
    # where conv reassociation joins in. 5e-3 bounds it with margin while
    # still catching any algebra regression (which shows up at 1e-1+).
    # (+2e-4 absolute floor: small-scale leaves see the noise without the
    # scale — an algebra bug still shows at ~1e-1 of scale)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        scale = float(jnp.max(jnp.abs(a))) + 1e-12
        assert float(jnp.max(jnp.abs(a - b))) <= 5e-3 * scale + 2e-4


def test_packed_training_step_matches_plain(tmp_path):
    """One full yolo_train_step with packed_stem=True: same loss and BN
    states as the plain step. Parameters are NOT compared elementwise —
    Adam's first-step update is ~sign(g)*lr, so deep-graph gradient
    components near zero (where the BN-stats reassociation noise
    dominates) legitimately flip, bounded by 2*lr; trajectory-level
    equivalence is the train-to-convergence bench's job."""
    from mit_driverless_cv_traininginfra.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
    )

    spec = _small_yolo_spec(tmp_path)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    imgs, targets = yolo_batch(np.random.default_rng(0), 2, size=64)
    imgs, targets = jnp.asarray(imgs), jnp.asarray(targets)
    tx = make_optimizer("Adam", lr=1e-3)

    # the step donates its TrainState: copy the trees so both steps start
    # from identical, live buffers
    copy = lambda t: jax.tree_util.tree_map(lambda v: jnp.array(v), t)
    ts1 = init_train_state(copy(params), copy(state), tx)
    ts2 = init_train_state(copy(params), copy(state), tx)
    ts1, loss1, _ = yolo_train_step(spec, tx, ts1, imgs, targets)
    ts2, loss2, _ = yolo_train_step(spec, tx, ts2, imgs, targets,
                                    packed_stem=True)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-4)
    for k in ts1.model_state:
        for kk in ts1.model_state[k]:
            np.testing.assert_allclose(
                np.asarray(ts1.model_state[k][kk]),
                np.asarray(ts2.model_state[k][kk]), rtol=2e-3, atol=2e-3)
    # Adam bounds any first-step move by ~lr, so no element may drift
    # further than 2*lr + the f32 dust
    for a, b in zip(jax.tree_util.tree_leaves(ts1.params),
                    jax.tree_util.tree_leaves(ts2.params)):
        assert float(jnp.max(jnp.abs(a - b))) <= 2 * 1e-3 + 1e-6


def test_packed_stem_device_aug_step(tmp_path):
    """The device-aug train step also takes packed_stem=True (the two
    flags compose in train/steps.py:174); pin that path: same aug key →
    same loss/BN state as the plain device-aug step, at the same
    tolerances as the host-aug twin above."""
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step_device_aug,
    )

    spec = _small_yolo_spec(tmp_path)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    imgs = jnp.asarray(rng.random((2, 64, 64, 3)), jnp.float32)
    labels = np.zeros((2, 3, 5), np.float32)
    labels[:, 0] = [0, 10, 12, 40, 44]
    labels = jnp.asarray(labels)
    tx = make_optimizer("Adam", lr=1e-3)
    key = jax.random.PRNGKey(11)

    copy = lambda t: jax.tree_util.tree_map(lambda v: jnp.array(v), t)
    ts1 = init_train_state(copy(params), copy(state), tx)
    ts2 = init_train_state(copy(params), copy(state), tx)
    ts1, loss1, _ = yolo_train_step_device_aug(spec, tx, ts1, imgs, labels,
                                               key)
    ts2, loss2, _ = yolo_train_step_device_aug(spec, tx, ts2, imgs, labels,
                                               key, packed_stem=True)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-4)
    for k in ts1.model_state:
        for kk in ts1.model_state[k]:
            np.testing.assert_allclose(
                np.asarray(ts1.model_state[k][kk]),
                np.asarray(ts2.model_state[k][kk]), rtol=2e-3, atol=2e-3)
