"""Fused softargmax and fixed-shape NMS (ops/fused.py) against plain
references: float64 numpy for the softargmax and its VJP, ops.nms for the
suppression semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.ops.fused import (
    _xla_nms_topk,
    fused_softargmax,
)


def _np_softargmax(z):
    """float64 flat softmax + expectation over linspace(0, (N-1)/N, N)."""
    m, h, w = z.shape
    flat = np.asarray(z, np.float64).reshape(m, h * w)
    p = np.exp(flat - flat.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    xv = np.tile(np.arange(w) / w, h)
    yv = np.repeat(np.arange(h) / h, w)
    pts = np.stack([(p * xv).sum(1), (p * yv).sum(1)], axis=1)
    return pts, p.reshape(m, h, w), xv, yv


@pytest.mark.parametrize("m,h,w,scale", [(12, 80, 80, 3.0), (5, 80, 80, 1.0),
                                         (3, 20, 12, 6.0)])
def test_xla_softargmax_matches_float64_reference(m, h, w, scale):
    x = np.random.default_rng(m).normal(0, scale, (m, h, w))
    pts, probs = fused_softargmax(jnp.asarray(x, jnp.float32))
    pts_r, probs_r, _, _ = _np_softargmax(x)
    np.testing.assert_allclose(np.asarray(pts), pts_r, atol=2e-6)
    np.testing.assert_allclose(np.asarray(probs), probs_r, atol=1e-6)


def test_fused_softargmax_vjp_matches_float64_reference():
    """The custom VJP against the analytic float64 gradient of
    <a, pts> + <b, probs>: dz = p·(g − Σ g·p), g = b + a_x·x + a_y·y."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (6, 40, 40))
    a = rng.normal(0, 1, (6, 2))
    b = rng.normal(0, 1, (6, 40, 40))
    _, vjp = jax.vjp(fused_softargmax, jnp.asarray(x, jnp.float32))
    (dz,) = vjp((jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    _, p, xv, yv = _np_softargmax(x)
    p = p.reshape(6, -1)
    g = b.reshape(6, -1) + a[:, :1] * xv + a[:, 1:] * yv
    ref = p * (g - (g * p).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(np.asarray(dz).reshape(6, -1), ref, atol=1e-6)


def test_fused_softargmax_gradients_match_reference():
    x = jnp.asarray(np.random.default_rng(1).normal(0, 2, (4, 80, 80)),
                    jnp.float32)

    def via_fused(z):
        pts, probs = fused_softargmax(z)
        return jnp.sum(pts ** 2) + 0.1 * jnp.sum(probs ** 2)

    def reference(z):
        m, h, w = z.shape
        p = jax.nn.softmax(z.reshape(m, h * w), axis=1)
        ys = jnp.linspace(0, (h - 1.0) / h, h)
        xs = jnp.linspace(0, (w - 1.0) / w, w)
        yv, xv = jnp.repeat(ys, w), jnp.tile(xs, h)
        pts = jnp.stack([jnp.sum(p * xv, 1), jnp.sum(p * yv, 1)], 1)
        return jnp.sum(pts ** 2) + 0.1 * jnp.sum(p ** 2)

    g1 = jax.grad(via_fused)(x)
    g2 = jax.grad(reference)(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-6)


def test_fused_softargmax_padding_path():
    """Any row count and a bf16 input: f32 points, probabilities in the
    input dtype that sum to one per map."""
    x = jnp.asarray(np.random.default_rng(2).normal(0, 1, (5, 80, 80)),
                    jnp.bfloat16)
    pts, probs = fused_softargmax(x)
    assert pts.shape == (5, 2) and pts.dtype == jnp.float32
    assert probs.shape == (5, 80, 80) and probs.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(probs.astype(jnp.float32).sum(axis=(1, 2))), 1.0,
        atol=2e-2)


def test_nms_topk_matches_reference_semantics_interpret():
    """Kept slots of the fixed-shape NMS are exactly ops.nms's survivors,
    and the gathered boxes are the candidates' own."""
    from mit_driverless_cv_traininginfra.ops.nms import nms

    rng = np.random.default_rng(3)
    B, N, K = 4, 256, 8
    xy = rng.uniform(0, 100, (B, N, 2))
    wh = rng.uniform(2, 30, (B, N, 2))
    boxes = jnp.asarray(np.concatenate([xy, xy + wh], -1), jnp.float32)
    scores = jnp.asarray(rng.uniform(0, 1, (B, N)), jnp.float32)

    bX, sX, iX, kX = _xla_nms_topk(boxes, scores, 0.5, K, 0.25)

    def ref_one(bb, ss):
        m = jnp.where(ss > 0.5, ss, -jnp.inf)
        idx, mask = nms(bb, m, overlap=0.25, top_k=K)
        return idx, mask

    iR, kR = jax.vmap(ref_one)(boxes, scores)
    for b in range(B):
        set_x = set(np.asarray(iX[b])[np.asarray(kX[b])].tolist())
        set_r = set(np.asarray(iR[b])[np.asarray(kR[b])].tolist())
        assert set_x == set_r, b
    gb = np.asarray(boxes[0])[np.asarray(iX[0])]
    np.testing.assert_array_equal(gb, np.asarray(bX[0]))
    # slots are in descending score order
    assert np.all(np.diff(np.asarray(sX), axis=1) <= 0)
