import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.models import rektnet
from mit_driverless_cv_traininginfra.models.rektnet import (
    apply,
    init,
    params_from_torch_state_dict,
    soft_argmax_2d,
)


def test_init_shapes():
    params, state = init(jax.random.PRNGKey(0))
    assert params["stem"]["w"].shape == (7, 7, 3, 16)
    assert params["res4"]["conv1"]["w"].shape == (3, 3, 64, 128)
    assert params["out"]["w"].shape == (1, 1, 128, 7)
    assert state["res2"]["bn1"]["mean"].shape == (32,)


def test_forward_shapes_and_normalisation():
    params, state = init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 80, 80, 3))
    probs, points, _ = apply(params, state, x)
    assert probs.shape == (2, 7, 80, 80)
    assert points.shape == (2, 7, 2)
    np.testing.assert_allclose(np.asarray(probs.sum(axis=(2, 3))), 1.0, atol=1e-5)
    assert bool((points >= 0).all()) and bool((points < 1).all())


def test_hm_only_mode():
    params, state = init(jax.random.PRNGKey(0))
    x = jnp.zeros((1, 80, 80, 3))
    logits = apply(params, state, x, hm_only=True)
    assert logits.shape == (1, 80, 80, 7)


def test_soft_argmax_peak_recovery():
    # sharply peaked logits at (x=31, y=55) → expectation ≈ (31/80, 55/80)
    logits = jnp.full((1, 1, 80, 80), -30.0)
    logits = logits.at[0, 0, 55, 31].set(30.0)
    points, probs = soft_argmax_2d(logits)
    np.testing.assert_allclose(
        np.asarray(points[0, 0]), [31 / 80, 55 / 80], atol=1e-4
    )
    assert float(probs[0, 0, 55, 31]) > 0.999


def test_train_mode_updates_running_stats():
    params, state = init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 80, 80, 3)) * 3 + 1
    _, _, new_state = apply(params, state, x, train=True)
    assert not np.allclose(
        np.asarray(new_state["stem"]["mean"]), np.asarray(state["stem"]["mean"])
    )
    # eval mode leaves state untouched
    _, _, same_state = apply(params, state, x, train=False)
    np.testing.assert_array_equal(
        np.asarray(same_state["stem"]["mean"]), np.asarray(state["stem"]["mean"])
    )


@pytest.mark.parity
def test_forward_matches_torch_oracle():
    """Bit-level parity vs an independently-written torch oracle of the
    published architecture (7x7 stem + 4 residual blocks + 1x1 head with
    flat-softmax/soft-argmax decode), with shared random weights."""
    torch = pytest.importorskip("torch")
    nn, F = torch.nn, torch.nn.functional

    class Res(nn.Module):
        def __init__(s, cin, cout):
            super().__init__()
            s.conv1 = nn.Conv2d(cin, cout, 3, 1, 2, dilation=2)
            s.bn1 = nn.BatchNorm2d(cout)
            s.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
            s.bn2 = nn.BatchNorm2d(cout)
            s.shortcut_conv = nn.Conv2d(cin, cout, 1, 1)
            s.shortcut_bn = nn.BatchNorm2d(cout)

        def forward(s, x):
            a1 = F.relu(s.bn1(s.conv1(x)))
            return F.relu(s.shortcut_bn(s.shortcut_conv(x)) + s.bn2(s.conv2(a1)))

    class Oracle(nn.Module):
        def __init__(s):
            super().__init__()
            s.conv = nn.Conv2d(3, 16, 7, 1, 3)
            s.bn = nn.BatchNorm2d(16)
            s.res1, s.res2 = Res(16, 16), Res(16, 32)
            s.res3, s.res4 = Res(32, 64), Res(64, 128)
            s.out = nn.Conv2d(128, 7, 1, 1, 0)

        def forward(s, x):
            h = F.relu(s.bn(s.conv(x)))
            for r in (s.res1, s.res2, s.res3, s.res4):
                h = r(h)
            hm = s.out(h)
            b = hm.shape[0]
            flat = F.softmax(hm.reshape(-1, 80 * 80), dim=1).reshape(b, 7, 80, 80)
            vy = torch.linspace(0, 79 / 80, 80)
            vx = torch.linspace(0, 79 / 80, 80)
            ey = (flat.sum(3) * vy).sum(-1)
            ex = (flat.sum(2) * vx).sum(-1)
            return flat, torch.stack([ex, ey], -1)

    torch.manual_seed(0)
    oracle = Oracle().eval()
    # randomise running stats so the eval-BN path is non-trivial
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)

    params, state = params_from_torch_state_dict(oracle.state_dict())
    x = np.random.default_rng(3).uniform(0, 1, (2, 3, 80, 80)).astype(np.float32)
    with torch.no_grad():
        ref_hm, ref_pts = oracle(torch.from_numpy(x))

    probs, points, _ = apply(params, state, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(np.asarray(points), ref_pts.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.asarray(probs), ref_hm.numpy(), atol=1e-6)


def test_fold_bn_matches_apply():
    from mit_driverless_cv_traininginfra.models.rektnet import apply_folded, fold_bn

    params, state = init(jax.random.PRNGKey(7))
    state = jax.tree_util.tree_map(
        lambda x: x + jax.random.uniform(jax.random.PRNGKey(8), x.shape) * 0.2,
        state,
    )
    x = jax.random.uniform(jax.random.PRNGKey(9), (2, 80, 80, 3))
    probs, pts, _ = apply(params, state, x)
    fp = fold_bn(params, state)
    probs_f, pts_f = apply_folded(fp, x)
    np.testing.assert_allclose(np.asarray(pts), np.asarray(pts_f), atol=5e-4)
    np.testing.assert_allclose(np.asarray(probs), np.asarray(probs_f), atol=2e-3)
    # hm_only folded path keeps the export contract
    logits = apply_folded(fp, x, hm_only=True)
    assert logits.shape == (2, 80, 80, 7)
