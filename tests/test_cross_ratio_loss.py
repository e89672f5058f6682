import numpy as np
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.models.cross_ratio_loss import cross_ratio_loss


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_l2_softargmax_location():
    pts = _rand((3, 7, 2), 0)
    tgt = _rand((3, 7, 2), 1)
    loc, geo, total = cross_ratio_loss(
        None, jnp.asarray(pts), None, jnp.asarray(tgt),
        loss_type="l2_softargmax", include_geo=False,
    )
    expected = (((pts - tgt) ** 2).sum(axis=(1, 2))).mean()
    assert float(loc) == pytest.approx(float(expected), rel=1e-5)
    assert float(geo) == 0.0 and float(total) == pytest.approx(float(expected), rel=1e-5)


def test_l1_and_heatmap_variants():
    pts, tgt = _rand((2, 7, 2), 2), _rand((2, 7, 2), 3)
    hm, thm = _rand((2, 7, 8, 8), 4), _rand((2, 7, 8, 8), 5)
    l1, _, _ = cross_ratio_loss(jnp.asarray(hm), jnp.asarray(pts), jnp.asarray(thm),
                                jnp.asarray(tgt), loss_type="l1_sm", include_geo=False)
    assert float(l1) == pytest.approx(float(np.abs(pts - tgt).sum(axis=(1, 2)).mean()), rel=1e-5)
    l2h, _, _ = cross_ratio_loss(jnp.asarray(hm), jnp.asarray(pts), jnp.asarray(thm),
                                 jnp.asarray(tgt), loss_type="l2_hm", include_geo=False)
    assert float(l2h) == pytest.approx(float(((hm - thm) ** 2).sum(axis=(1, 2, 3)).mean()), rel=1e-5)


def test_geo_loss_zero_for_perfect_cone():
    # perfectly colinear sides and parallel horizontals → geo loss ~0
    pts_np = np.array([[0.5, 0.0], [0.4, 0.3], [0.6, 0.3], [0.3, 0.6],
                       [0.7, 0.6], [0.2, 0.9], [0.8, 0.9]], dtype=np.float32)
    pts = jnp.asarray(pts_np[None])
    # horizontals 1-2, 3-4, 5-6 are parallel; chains 0-1-3-5 / 0-2-4-6 colinear
    _, geo, _ = cross_ratio_loss(None, pts, None, pts, loss_type="l1_sm",
                                 include_geo=True, geo_loss_gamma_horz=0.05,
                                 geo_loss_gamma_vert=0.05, cross_batch=False)
    assert float(geo) == pytest.approx(0.0, abs=1e-5)


def test_unknown_loss_type_raises():
    with pytest.raises(ValueError):
        cross_ratio_loss(None, jnp.zeros((1, 7, 2)), None, jnp.zeros((1, 7, 2)),
                         loss_type="nope", include_geo=False)


@pytest.mark.parity
def test_geo_matches_torch_tensordot_semantics():
    """The reference's tensordot produces a (B,B) cross-batch matrix
    (cross_ratio_loss.py:36-57); verify our cross_batch=True reproduces the
    full formula against a torch restatement."""
    torch = pytest.importorskip("torch")
    F = torch.nn.functional

    pts_np = _rand((4, 7, 2), 7)
    gh, gv = 0.053, 0.071

    p = torch.from_numpy(pts_np)
    def tdot(a, b):
        return torch.tensordot(a, b, dims=([1], [1]))
    v53 = F.normalize(p[:, 5] - p[:, 3], dim=1)
    v31 = F.normalize(p[:, 3] - p[:, 1], dim=1)
    v10 = F.normalize(p[:, 1] - p[:, 0], dim=1)
    v64 = F.normalize(p[:, 6] - p[:, 4], dim=1)
    v42 = F.normalize(p[:, 4] - p[:, 2], dim=1)
    v20 = F.normalize(p[:, 2] - p[:, 0], dim=1)
    vA, vB = 1.0 - tdot(v31, v53), 1.0 - tdot(v10, v31)
    vC, vD = 1.0 - tdot(v64, v42), 1.0 - tdot(v42, v20)
    h21 = F.normalize(p[:, 2] - p[:, 1], dim=1)
    h43 = F.normalize(p[:, 4] - p[:, 3], dim=1)
    h65 = F.normalize(p[:, 6] - p[:, 5], dim=1)
    hA, hB = 1.0 - tdot(h43, h21), 1.0 - tdot(h65, h43)
    expected = gh * (hA + hB).mean() / 2 + gv * (vA + vB + vC + vD).mean() / 4

    _, geo, _ = cross_ratio_loss(None, jnp.asarray(pts_np), None,
                                 jnp.asarray(pts_np), loss_type="l1_sm",
                                 include_geo=True, geo_loss_gamma_horz=gh,
                                 geo_loss_gamma_vert=gv, cross_batch=True)
    assert float(geo) == pytest.approx(float(expected), rel=1e-3)


def test_geo_loss_gradients_finite_at_coincident_points():
    """Regression (r3): at init every soft-argmax point collapses to the
    heatmap centre, so keypoint differences can be EXACTLY zero and the
    geo-loss normalize must follow torch's zero-subgradient convention
    instead of emitting 0/0 = NaN (which poisoned B=256 training)."""
    import jax

    B = 4
    hm = jnp.full((B, 7, 8, 8), 0.25, jnp.float32)
    tgt_hm = jnp.ones((B, 7, 8, 8), jnp.float32) / 64.0
    tgt_pts = jnp.full((B, 7, 2), 0.5, jnp.float32)

    def loss_fn(points):
        loc, geo, total = cross_ratio_loss(
            hm, points, tgt_hm, tgt_pts, loss_type="l1_softargmax",
            include_geo=True, geo_loss_gamma_horz=0.05,
            geo_loss_gamma_vert=0.05)
        return total

    pts = jnp.full((B, 7, 2), 0.5, jnp.float32)  # all points coincident
    total, grad = jax.value_and_grad(loss_fn)(pts)
    assert np.isfinite(float(total))
    assert np.all(np.isfinite(np.asarray(grad))), "NaN grads at coincidence"
