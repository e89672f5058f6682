import numpy as np
import jax
import jax.numpy as jnp

from mit_driverless_cv_traininginfra.data.augment import affine_labels
from mit_driverless_cv_traininginfra.ops.device_aug import (
    _affine_labels_batch,
    _affine_matrices,
    _warp_bilinear,
    augment_batch,
)


def test_warp_identity():
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 1, (2, 32, 32, 3)), jnp.float32)
    M_inv = jnp.tile(jnp.eye(3)[None], (2, 1, 1))
    out = _warp_bilinear(imgs, M_inv)
    np.testing.assert_allclose(np.asarray(out), np.asarray(imgs), atol=1e-6)


def test_warp_translation_fills_grey():
    imgs = jnp.ones((1, 16, 16, 3), jnp.float32)
    # inverse map: src_x = dst_x - 8 → content shifts right by 8, left half grey
    M_inv = jnp.asarray([[[1, 0, -8], [0, 1, 0], [0, 0, 1]]], jnp.float32)
    out = np.asarray(_warp_bilinear(imgs, M_inv))
    assert abs(out[0, 8, 2, 0] - 127 / 255) < 1e-3
    assert abs(out[0, 8, 12, 0] - 1.0) < 1e-6


def test_affine_labels_batch_matches_host_rewarp():
    """The batched jax label rewarp must agree with the HOST implementation
    (data.augment.affine_labels — the reference-parity rewarp) when both
    use the same affine parameters."""
    import mit_driverless_cv_traininginfra.data.augment as A

    rng = np.random.default_rng(1)
    B, T = 3, 4
    labels = np.zeros((B, T, 5), np.float32)
    for b in range(B):
        for t in range(T):
            x0, y0 = rng.uniform(40, 300, 2)
            wdt, hgt = rng.uniform(20, 80, 2)
            labels[b, t] = [0, x0, y0, x0 + wdt, y0 + hgt]

    params = [(-7.0, (12.0, -30.0), 1.05, 2.0),
              (9.5, (-35.0, 5.0), 0.92, -2.5),
              (0.0, (0.0, 0.0), 1.0, 0.0)]
    # batch matrices built with the HOST matrix constructor
    M = jnp.asarray(np.stack([
        A._affine_matrix(416, 416, ang, tr, sc, (sh, 0))
        for ang, tr, sc, sh in params
    ]), jnp.float32)
    ang = jnp.asarray([p[0] for p in params], jnp.float32)

    out = np.asarray(_affine_labels_batch(jnp.asarray(labels), M, ang, 416, 416))
    for b, (a, tr, sc, sh) in enumerate(params):
        expected = A.affine_labels(416, 416, labels[b].copy(), angle=a,
                                   translate=tr, scale=sc, shear=(sh, 0))
        np.testing.assert_allclose(out[b], expected, atol=2e-2)


def test_augment_batch_end_to_end():
    rng = np.random.default_rng(2)
    imgs = jnp.asarray(rng.uniform(0, 1, (4, 64, 64, 3)), jnp.float32)
    labels = np.zeros((4, 3, 5), np.float32)
    labels[:, 0] = [0, 10, 10, 40, 50]
    out_i, out_l = augment_batch(jax.random.PRNGKey(1), imgs,
                                 jnp.asarray(labels), noise=True)
    assert out_i.shape == imgs.shape and out_l.shape == labels.shape
    assert bool((out_i >= 0).all()) and bool((out_i <= 1).all())
    # padded label rows stay zero
    np.testing.assert_array_equal(np.asarray(out_l[:, 1:]), labels[:, 1:])
    # determinism per key
    out_i2, out_l2 = augment_batch(jax.random.PRNGKey(1), imgs,
                                   jnp.asarray(labels), noise=True)
    np.testing.assert_array_equal(np.asarray(out_i), np.asarray(out_i2))


def test_lr_flip_label_consistency():
    imgs = jnp.zeros((8, 64, 64, 3), jnp.float32)
    labels = np.zeros((8, 1, 5), np.float32)
    labels[:, 0] = [0, 10, 20, 30, 40]
    out_i, out_l = augment_batch(jax.random.PRNGKey(3), imgs,
                                 jnp.asarray(labels),
                                 augment_affine=False, jitter=False)
    l = np.asarray(out_l[:, 0])
    flipped = np.isclose(l[:, 1], 64 - 30)
    unflipped = np.isclose(l[:, 1], 10)
    assert (flipped | unflipped).all()
    assert flipped.any() and unflipped.any()
    # x1 < x2 preserved under flip
    assert (l[:, 1] < l[:, 3]).all()


def test_warp_bf16_images_identity_exact():
    """Coordinate math must run in f32 even for bf16 image pools: bf16
    coordinates cannot represent odd pixel indices ≥ 257, so an identity
    warp of a 416² bf16 image would sample every second far column from
    the wrong pixel (the ops/image.py crop-coords bug class)."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (1, 416, 416, 3)).astype(np.float32)
    imgs = jnp.asarray(base, jnp.bfloat16)
    M_inv = jnp.tile(jnp.eye(3)[None], (1, 1, 1))
    out = np.asarray(_warp_bilinear(imgs, M_inv)).astype(np.float32)
    # identity warp == input, including rows/cols beyond 256
    np.testing.assert_array_equal(out, np.asarray(imgs).astype(np.float32))
