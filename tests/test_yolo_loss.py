import numpy as np
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.models.yolo_loss import (
    _bce,
    build_targets,
    yolo_head_loss,
)


def _oracle_build_targets(target, anchors, num_classes, H, W, ignore_thresh):
    """Plain-loop numpy restatement of the reference assignment semantics
    (utils/utils.py:195-275), used as the test oracle."""
    B, T, _ = target.shape
    A = len(anchors)
    mask = np.zeros((B, A, H, W), bool)
    conf_mask = np.ones((B, A, H, W), bool)
    tx = np.zeros((B, A, H, W)); ty = np.zeros((B, A, H, W))
    tw = np.zeros((B, A, H, W)); th = np.zeros((B, A, H, W))
    tconf = np.zeros((B, A, H, W))
    tcls = np.zeros((B, A, H, W, num_classes))

    rows = []
    for b in range(B):
        for t in range(T):
            row = target[b, t] if target[b, t].sum() > 0 else target[b, 0]
            gx, gy = row[1] * W, row[2] * H
            gw, gh = row[3] * W, row[4] * H
            gi, gj = int(gx), int(gy)
            ious = []
            for aw, ah in anchors:
                inter = (min(gw, aw) + 1) * (min(gh, ah) + 1)
                union = (gw + 1) * (gh + 1) + (aw + 1) * (ah + 1) - inter
                ious.append(inter / (union + 1e-12))
            rows.append((b, gi, gj, gx, gy, gw, gh, np.array(ious), int(row[0])))

    # phase 1: batch-global conf zeroing for cells with any iou > thresh
    for b, gi, gj, *_rest, ious, lab in [
        (r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]) for r in rows
    ]:
        if (ious > ignore_thresh).any():
            conf_mask[:, :, gj, gi] = False
    # phase 2: best-anchor scatters
    for b, gi, gj, gx, gy, gw, gh, ious, lab in rows:
        best = int(np.argmax(ious))
        mask[b, best, gj, gi] = True
        conf_mask[b, best, gj, gi] = True
        tx[b, best, gj, gi] = gx - gi
        ty[b, best, gj, gi] = gy - gj
        tw[b, best, gj, gi] = np.log(gw / anchors[best][0] + 1e-16)
        th[b, best, gj, gi] = np.log(gh / anchors[best][1] + 1e-16)
        tconf[b, best, gj, gi] = 1.0
        tcls[b, best, gj, gi, lab] = 1.0
    return mask, conf_mask, tx, ty, tw, th, tconf, tcls


def _rand_targets(B, T, seed, distinct_cells=True):
    rng = np.random.default_rng(seed)
    target = np.zeros((B, T, 5), np.float32)
    for b in range(B):
        n = rng.integers(1, T + 1)
        cells = rng.choice(13 * 13, size=n, replace=False)
        for t in range(n):
            cy, cx = divmod(int(cells[t]), 13)
            target[b, t, 1] = (cx + rng.uniform(0.1, 0.9)) / 13
            target[b, t, 2] = (cy + rng.uniform(0.1, 0.9)) / 13
            target[b, t, 3] = rng.uniform(0.02, 0.4)
            target[b, t, 4] = rng.uniform(0.02, 0.4)
    return target


ANCHORS = [(1.2, 1.5), (2.5, 3.1), (5.0, 4.0)]


def test_build_targets_matches_oracle():
    target = _rand_targets(3, 5, seed=0)
    got = build_targets(jnp.asarray(target), jnp.asarray(ANCHORS), 1, 13, 13, 0.5)
    exp = _oracle_build_targets(target, ANCHORS, 1, 13, 13, 0.5)
    names = ["mask", "conf_mask", "tx", "ty", "tw", "th", "tconf", "tcls"]
    for name, g, e in zip(names, got, exp):
        np.testing.assert_allclose(np.asarray(g, np.float64), e.astype(np.float64),
                                   atol=5e-4, err_msg=name)


def test_build_targets_padded_rows_duplicate_row0():
    # one real target + padding → identical result to T=1
    t1 = _rand_targets(2, 1, seed=1)
    t4 = np.zeros((2, 4, 5), np.float32)
    t4[:, 0] = t1[:, 0]
    g1 = build_targets(jnp.asarray(t1), jnp.asarray(ANCHORS), 1, 13, 13, 0.5)
    g4 = build_targets(jnp.asarray(t4), jnp.asarray(ANCHORS), 1, 13, 13, 0.5)
    for a, b in zip(g1, g4):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_conf_mask_batch_global_quirk():
    """A big box in image 0 must zero the conf cell for image 1 too
    (utils/utils.py:244-255 quirk)."""
    target = np.zeros((2, 1, 5), np.float32)
    # image 0: box at cell (6,6) with size well above ignore thresh vs anchors
    target[0, 0] = [0, 0.5, 0.5, 0.3, 0.3]
    # image 1: tiny box in another cell
    target[1, 0] = [0, 0.1, 0.1, 0.01, 0.01]
    t = build_targets(jnp.asarray(target), jnp.asarray(ANCHORS), 1, 13, 13, 0.5)
    cm = np.asarray(t.conf_mask)
    # cell (6,6) zeroed for image 1 across anchors that aren't image1's best
    assert not cm[1, :, 6, 6].all()


def test_bce_matches_torch():
    torch = pytest.importorskip("torch")
    p = np.clip(np.random.default_rng(2).uniform(0, 1, 50), 1e-7, 1 - 1e-7)
    t = (np.random.default_rng(3).uniform(0, 1, 50) > 0.5).astype(np.float64)
    ours = np.asarray(_bce(jnp.asarray(p, jnp.float32), jnp.asarray(t, jnp.float32)))
    ref = torch.nn.functional.binary_cross_entropy(
        torch.tensor(p, dtype=torch.float32), torch.tensor(t, dtype=torch.float32),
        reduction="none",
    ).numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-4)


def test_yolo_head_loss_finite_and_components():
    rng = np.random.default_rng(4)
    head = rng.normal(0, 1, (2, 13, 13, 3 * 6)).astype(np.float32)
    target = _rand_targets(2, 4, seed=5)
    loss, comps = yolo_head_loss(
        jnp.asarray(head), jnp.asarray(target),
        [(39, 48), (80, 99), (160, 128)], img_height=416, num_classes=1,
        ignore_thresh=0.5, xy_loss=2.0, wh_loss=1.6,
        object_loss=0.1, no_object_loss=25.0,
    )
    assert np.isfinite(float(loss))
    assert comps.shape == (6,)
    np.testing.assert_allclose(float(loss), float(np.asarray(comps).sum()), rtol=1e-5)


def test_bce_logits_matches_bce_and_torch():
    """The logits BCE (the loss's stable form) must match both the
    post-sigmoid _bce and torch on moderate logits."""
    import jax
    from mit_driverless_cv_traininginfra.models.yolo_loss import (
        _bce_logits,
    )

    rng = np.random.default_rng(7)
    lgt = jnp.asarray(rng.normal(0, 3, 64), jnp.float32)
    t = jnp.asarray((rng.uniform(0, 1, 64) > 0.5).astype(np.float32))
    ours = np.asarray(_bce_logits(lgt, t))
    via_p = np.asarray(_bce(jax.nn.sigmoid(lgt), t))
    np.testing.assert_allclose(ours, via_p, atol=1e-4)


def test_yolo_loss_gradients_finite_at_saturated_conf():
    """Regression (r3 flagship divergence): once the conf sigmoid
    saturates to exactly 0/1 in f32, the post-sigmoid BCE backward emits
    0*inf = NaN and poisons the params. The logits formulation must keep
    gradients finite at arbitrarily large conf logits."""
    import jax

    rng = np.random.default_rng(8)
    head = rng.normal(0, 1, (2, 13, 13, 3 * 6)).astype(np.float32)
    # saturate every conf logit far beyond f32 sigmoid resolution
    head = head.reshape(2, 13, 13, 3, 6)
    head[..., 4] = np.where(rng.uniform(size=head[..., 4].shape) > 0.5,
                            120.0, -120.0)
    head = jnp.asarray(head.reshape(2, 13, 13, 18))
    target = _rand_targets(2, 4, seed=9)

    def loss_fn(h):
        loss, _ = yolo_head_loss(
            h, jnp.asarray(target), [(39, 48), (80, 99), (160, 128)],
            img_height=416, num_classes=1, ignore_thresh=0.5,
            xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)
        return loss

    loss, grad = jax.value_and_grad(loss_fn)(head)
    assert np.isfinite(float(loss))
    assert np.all(np.isfinite(np.asarray(grad))), "NaN/inf grads at saturation"
