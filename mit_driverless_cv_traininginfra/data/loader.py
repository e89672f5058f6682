"""Host-parallel batched loader with device prefetch.

Replaces ``torch.utils.data.DataLoader(num_workers=n_cpu, pin_memory=True)``
(CVC-YOLOv3/train.py:124-141): a thread pool decodes/augments ahead of the
consumer (PIL/cv2 release the GIL for the heavy parts), batches are stacked
into pinned-layout numpy, and :func:`prefetch_to_device` keeps ``depth``
batches in flight to HBM with the mesh sharding applied — compute never
waits on the host.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np


class DataLoader:
    """Map-style dataset → shuffled batches of stacked numpy arrays.

    Yields (uris: list[str], images: (B,H,W,C) f32, labels: (B,T,5) f32).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 17,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        batches: List[Sequence[int]] = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        def collate(futures):
            items = [f.result() for f in futures]
            uris = [it[0] for it in items]
            imgs = np.stack([it[1] for it in items]).astype(np.float32)
            labels = np.stack([it[2] for it in items]).astype(np.float32)
            return uris, imgs, labels

        with ThreadPoolExecutor(self.num_workers) as pool:
            # bounded pipeline: keep at most `prefetch_batches` batches of
            # decoded samples in flight ahead of the consumer (an unbounded
            # submit of the whole epoch would accumulate decoded images
            # faster than training consumes them and exhaust host memory)
            window = [
                [pool.submit(self.dataset.__getitem__, i) for i in b]
                for b in batches[: self.prefetch_batches]
            ]
            next_batch = self.prefetch_batches
            for _ in range(len(batches)):
                futures = window.pop(0)
                if next_batch < len(batches):
                    window.append([
                        pool.submit(self.dataset.__getitem__, i)
                        for i in batches[next_batch]
                    ])
                    next_batch += 1
                yield collate(futures)


def prefetch_to_device(iterator, mesh=None, depth: int = 2):
    """Wrap a batch iterator: device_put (sharded over ``mesh`` if given)
    ``depth`` batches ahead on a background thread.

    Each batch may be any tuple; ndarray fields are transferred (batch axis
    sharded over the mesh), non-array fields pass through untouched.
    Producer exceptions are re-raised in the consumer — a failing dataset
    must crash the epoch, not silently truncate it.
    """
    import jax

    from mit_driverless_cv_traininginfra.parallel.mesh import batch_sharding

    sharding = batch_sharding(mesh) if mesh is not None else None

    def put(batch):
        def one(x):
            if isinstance(x, np.ndarray) and x.ndim > 0:
                return jax.device_put(x, sharding) if sharding is not None \
                    else jax.device_put(x)
            return x
        return tuple(one(x) for x in batch)

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def producer():
        try:
            for batch in iterator:
                q.put(put(batch))
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(("__prefetch_error__", e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
            raise item[1]
        yield item
