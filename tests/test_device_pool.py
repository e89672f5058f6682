"""DevicePool (data/device_pool.py): device-resident training input."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mit_driverless_cv_traininginfra.data.device_pool import DevicePool
from mit_driverless_cv_traininginfra.parallel.mesh import make_mesh


class _FakeDataset:
    """Tiny map-style dataset with the (uri, image, labels) item shape."""

    def __init__(self, n=10, size=32):
        rng = np.random.default_rng(0)
        self.images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
        self.labels = rng.uniform(0, 1, (n, 3, 5)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return f"img{i}.png", self.images[i], self.labels[i]


def test_pool_matches_dataset_items():
    ds = _FakeDataset()
    pool = DevicePool.from_dataset(ds)
    assert len(pool) == len(ds)
    np.testing.assert_array_equal(np.asarray(pool.images), ds.images)
    np.testing.assert_array_equal(pool.labels, ds.labels)
    imgs, labels = pool.sample([3, 1, 4])
    np.testing.assert_array_equal(np.asarray(imgs), ds.images[[3, 1, 4]])
    np.testing.assert_array_equal(labels, ds.labels[[3, 1, 4]])
    assert isinstance(labels, np.ndarray)  # labels stay host-side


def test_loader_epoch_without_replacement_then_with():
    ds = _FakeDataset(n=8)
    pool = DevicePool.from_dataset(ds)
    loader = pool.loader(batch_size=4, seed=5, steps_per_epoch=3)
    assert len(loader) == 3
    batches = list(loader)
    assert len(batches) == 3
    # first two batches = one full shuffled pass (no repeats)
    seen = [u for b in batches[:2] for u in b[0]]
    assert sorted(seen) == sorted(f"img{i}.png" for i in range(8))
    for uris, imgs, labels in batches:
        assert imgs.shape == (4, 32, 32, 3)
        assert labels.shape == (4, 3, 5)


def test_budget_guard():
    ds = _FakeDataset(n=10, size=32)
    with pytest.raises(ValueError, match="budget"):
        DevicePool.from_dataset(ds, budget_bytes=1000)


def test_bf16_pool_halves_bytes_and_feeds_bf16():
    """dtype=bfloat16 halves the HBM footprint (the budget guard must
    account it) and yields bf16 batches — exactly what a bf16 train step
    casts its images to anyway."""
    ds = _FakeDataset(n=8, size=32)
    pool32 = DevicePool.from_dataset(ds)
    pool16 = DevicePool.from_dataset(ds, dtype=jnp.bfloat16)
    assert pool16.nbytes * 2 == pool32.nbytes
    imgs, _ = pool16.sample([0, 1])
    assert imgs.dtype == jnp.bfloat16
    # quantisation error bounded by bf16 eps on [0,1]
    err = np.abs(np.asarray(imgs, np.float32) - ds.images[[0, 1]]).max()
    assert err < 4e-3, err
    # a pool that busts the budget at f32 fits at bf16
    budget = pool32.nbytes - 1
    with pytest.raises(ValueError, match="budget"):
        DevicePool.from_dataset(ds, budget_bytes=budget)
    assert len(DevicePool.from_dataset(ds, budget_bytes=budget,
                                       dtype=jnp.bfloat16)) == 8


def test_pool_feeds_sharded_train_step():
    """Pool batches must drive the DP train step over the virtual mesh."""
    import os

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.models.darknet import init_params
    from mit_driverless_cv_traininginfra.parallel.mesh import replicate
    from mit_driverless_cv_traininginfra.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra.train.steps import (
        init_train_state,
        yolo_train_step,
    )

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "tiny_test.cfg")
    spec = load_network_spec(fixture, vanilla_anchor=True)
    mesh = make_mesh(8)
    ds = _FakeDataset(n=16, size=64)
    pool = DevicePool.from_dataset(ds, mesh=mesh)
    params, mstate = init_params(spec, jax.random.PRNGKey(0))
    tx = make_optimizer("Adam", lr=1e-3)
    ts = replicate(mesh, init_train_state(params, mstate, tx))

    for uris, imgs, labels in pool.loader(batch_size=8, steps_per_epoch=2):
        assert len(imgs.sharding.device_set) == 8  # batch-sharded gather
        ts, loss, _ = yolo_train_step(spec, tx, ts, imgs,
                                      jnp.asarray(labels))
        assert np.isfinite(float(loss))


def test_pool_loader_rejects_batch_larger_than_pool():
    """A pool smaller than one batch must raise, not silently yield
    zero-step epochs that 'train' nothing while checkpointing init
    weights."""
    import pytest

    ds = _FakeDataset(n=4)
    pool = DevicePool.from_dataset(ds)
    with pytest.raises(ValueError, match="cannot fill one batch"):
        pool.loader(8)
    # explicit steps_per_epoch opts into with-replacement sampling
    loader = pool.loader(8, steps_per_epoch=2)
    assert len(list(loader)) == 2
