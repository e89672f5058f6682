"""Device-resident sample pool — training input for host-bound machines.

A host core sustains only a few images/s through the full
``ImageLabelDataset.__getitem__`` path (bench_loader.py --full measures
it), far below what the device consumes on hosts with few cores (edge
deployments). ``DevicePool`` closes the gap the way the benchmark and the
convergence tools already do, as a first-class API: decode/patch the
dataset ONCE, park the images in HBM, and sample training batches with a
device gather — the host's per-step work drops to an index draw.

Tradeoffs (documented, not hidden):
- the pool freezes one materialisation of each sample — the per-epoch
  host-side randomness (patch choice, PIL affine) is drawn once. Pair
  with ``device_aug=True`` so photometric jitter + flips stay fresh every
  step inside the jitted train step (`train/steps.py`);
- HBM cost is ``N·H·W·C·itemsize`` bytes; the ``budget_bytes`` guard
  refuses pools that would crowd out the training step's working set.
  ``dtype=jnp.bfloat16`` halves the pool (a bf16 train step casts its
  images to bf16 anyway, so a bf16 pool feeds it losslessly); f32 stays
  the default for parity runs.

Replaces the reference's DataLoader worker pool
(CVC-YOLOv3/train.py:124-141) on hosts where that pool cannot keep up.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class DevicePool:
    """Images in HBM (replicated over the mesh), labels on the host.

    Build with :meth:`from_dataset`, then iterate ``pool.loader(batch)``
    exactly like a ``DataLoader`` (yields ``(uris, images, labels)``; the
    images are device arrays sharded for the mesh, the labels host numpy
    so the driver's per-step target counting stays sync-free).
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 uris: Optional[Sequence[str]] = None, mesh=None,
                 dtype=jnp.float32):
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.labels = np.asarray(labels, np.float32)
        self.uris = list(uris) if uris is not None else [""] * len(labels)
        if mesh is not None:
            from mit_driverless_cv_traininginfra.parallel.mesh import (
                replicated,
            )

            self.images = jax.device_put(jnp.asarray(images, self.dtype),
                                         replicated(mesh))
        else:
            self.images = jnp.asarray(images, self.dtype)

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.images.shape)) * self.dtype.itemsize

    @classmethod
    def from_dataset(cls, dataset, num: Optional[int] = None, mesh=None,
                     budget_bytes: float = 6e9,
                     dtype=jnp.float32) -> "DevicePool":
        """Materialise ``dataset[i]`` once per sample (one host pass) and
        park the images on device. ``num`` caps the pool size;
        ``budget_bytes`` is the HBM guard; ``dtype`` the on-device image
        dtype (bf16 halves the footprint for bf16 training)."""
        n = len(dataset) if num is None else min(num, len(dataset))
        if n == 0:
            raise ValueError("empty dataset")
        uri0, img0, lab0 = dataset[0]
        itemsize = jnp.dtype(dtype).itemsize
        est = n * int(np.prod(np.asarray(img0).shape)) * itemsize
        if est > budget_bytes:
            raise ValueError(
                f"device pool would need {est/1e9:.2f} GB "
                f"(> budget {budget_bytes/1e9:.2f} GB); lower `num`, raise "
                "budget_bytes, or use dtype=bfloat16")
        # stage on the host in the TARGET dtype: staging bf16 pools as f32
        # would transiently need (and ship to device) 2× budget_bytes —
        # the guard above models only the final footprint. numpy handles
        # ml_dtypes.bfloat16 natively via jnp.dtype.
        host_dtype = jnp.dtype(dtype).type
        images = np.empty((n,) + np.asarray(img0).shape, host_dtype)
        labels = np.empty((n,) + np.asarray(lab0).shape, np.float32)
        uris = []
        images[0], labels[0] = img0, lab0
        uris.append(uri0)
        for i in range(1, n):
            u, im, lb = dataset[i]
            images[i], labels[i] = im, lb
            uris.append(u)
        return cls(images, labels, uris, mesh=mesh, dtype=dtype)

    def sample(self, idx):
        """Device gather of a batch: (images_device, labels_host)."""
        idx = np.asarray(idx, np.int64)
        imgs = self.images[jnp.asarray(idx)]
        if self.mesh is not None:
            from mit_driverless_cv_traininginfra.parallel.mesh import (
                batch_sharding,
            )

            imgs = jax.device_put(imgs, batch_sharding(self.mesh))
        return imgs, self.labels[idx]

    def loader(self, batch_size: int, shuffle: bool = True, seed: int = 17,
               steps_per_epoch: Optional[int] = None):
        """DataLoader-compatible epoch iterator (full batches only — the
        tail that doesn't fill a batch is dropped, matching
        ``DataLoader(drop_last=True)``)."""
        return _PoolLoader(self, batch_size, shuffle, seed, steps_per_epoch)


class _PoolLoader:
    def __init__(self, pool: DevicePool, batch_size: int, shuffle: bool,
                 seed: int, steps_per_epoch: Optional[int]):
        self.pool = pool
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        n_full = len(pool) // batch_size
        if n_full == 0 and steps_per_epoch is None:
            # a silent zero-step epoch would "train" nothing while the
            # driver's epoch counter advances and checkpoints init weights
            raise ValueError(
                f"pool of {len(pool)} samples cannot fill one batch of "
                f"{batch_size}; lower batch_size, raise the pool size, or "
                "pass steps_per_epoch to sample with replacement")
        self.steps = steps_per_epoch if steps_per_epoch is not None else n_full

    def __len__(self) -> int:
        return self.steps

    def __iter__(self):
        n = len(self.pool)
        bs = self.batch_size
        n_full = n // bs
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for s in range(self.steps):
            if s < n_full:   # one shuffled pass without replacement
                idx = order[s * bs:(s + 1) * bs]
            else:            # beyond one pass: sample with replacement
                idx = self._rng.integers(0, n, bs)
            imgs, labels = self.pool.sample(idx)
            yield [self.pool.uris[i] for i in idx], imgs, labels
