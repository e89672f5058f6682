"""RektNet dataset: label CSV loader with content-hash cache + ConeDataset.

Parity with ``RektNet/utils.py:152-235`` (load_train_csv_dataset) and
``RektNet/dataset.py:20-56`` (ConeDataset):

- pandas-read ``rektnet_label.csv`` (col 0 = image, cols 2.. = 7 keypoint
  cells as ``"(x,y)"`` strings);
- skip NaN-labelled rows and images shorter than 10 px;
- cache the decoded arrays as ``.npy`` keyed by the SHA-256 of the
  dataframe content;
- chronological (non-shuffled) validation split: FIRST
  ``validation_percent`` of rows (train_eval.py uses 0.15 by default).

``ConeDataset.__getitem__`` → (image (80,80,3) f32 NHWC in [0,1],
heatmaps (7,80,80), points (7,2) normalised, name, orig_size).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Sequence, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from mit_driverless_cv_traininginfra.data.decode import imread_bgr
from mit_driverless_cv_traininginfra.ops.heatmap import (
    get_scale,
    prep_image,
    prep_label,
    scale_keypoints,
)

DEFAULT_KEYPOINT_KEYS = [
    "top", "mid_L_top", "mid_R_top", "mid_L_bot", "mid_R_bot", "bot_L", "bot_R",
]


def load_train_csv_dataset(
    train_csv_uri: str,
    validation_percent: float,
    keypoint_keys: Sequence[str] = tuple(DEFAULT_KEYPOINT_KEYS),
    dataset_path: str = "",
    cache_location: str = None,
):
    import pandas as pd

    from mit_driverless_cv_traininginfra.data.uri import resolve_uri

    train_csv_uri = resolve_uri(train_csv_uri)  # gs:// via local mirror
    table = pd.read_csv(train_csv_uri)
    table_hash = hashlib.sha256(
        pd.util.hash_pandas_object(table, index=True).values
    ).hexdigest()

    train_images = train_labels = None
    if cache_location:
        folder = os.path.join(cache_location, table_hash)
        imgs_path = os.path.join(folder, "images.npy")
        labels_path = os.path.join(folder, "labels.npy")
        if os.path.exists(imgs_path) and os.path.exists(labels_path):
            train_images = np.load(imgs_path)
            train_labels = np.load(labels_path)

    if train_labels is None:
        images = table.values[:, 0]
        labels = table.values[:, 2 : 2 + len(keypoint_keys)]

        tmp_labels: List[np.ndarray] = []
        image_uris: List[str] = []
        for i in range(len(labels)):
            label = labels[i]
            if label[0] != label[0]:  # NaN row
                continue
            pts = np.zeros((len(keypoint_keys), 2))
            for j, col in enumerate(keypoint_keys):
                cell = label[table.columns.get_loc(col) - 2]
                txt = cell[1:-1].split(",")
                pts[j, 0], pts[j, 1] = float(txt[0]), float(txt[1])
            tmp_labels.append(pts)
            image_uris.append(os.path.join(dataset_path, images[i]))

        kept_images: List[str] = []
        kept_labels: List[np.ndarray] = []
        for num, uri in enumerate(image_uris):
            image = imread_bgr(uri)  # native C++ decode when built
            if image is None:
                continue
            if image.shape[0] < 10:
                continue
            kept_images.append(os.path.basename(uri))
            kept_labels.append(tmp_labels[num])
        train_images = np.asarray(kept_images)
        train_labels = np.asarray(kept_labels)

        if cache_location:
            folder = os.path.join(cache_location, table_hash)
            os.makedirs(folder, exist_ok=True)
            np.save(os.path.join(folder, "images.npy"), train_images)
            np.save(os.path.join(folder, "labels.npy"), train_labels)

    num_val = int(len(train_labels) * validation_percent)
    val_images, val_labels = train_images[:num_val], train_labels[:num_val]
    train_images, train_labels = train_images[num_val:], train_labels[num_val:]
    print(f"training image number: {len(train_images)}")
    print(f"validation image number: {len(val_images)}")
    return train_images, train_labels, val_images, val_labels


class ConeDataset:
    def __init__(self, images, labels, dataset_path: str,
                 target_image_size: Tuple[int, int] = (80, 80),
                 vis_dataloader: bool = False,
                 compute_heatmaps: bool = True):
        self.images = images
        self.labels = labels
        self.dataset_path = dataset_path
        self.target_image_size = tuple(target_image_size)
        self.vis_dataloader = vis_dataloader
        # compute_heatmaps=False: ship a placeholder — targets are
        # synthesised on-device (ops.heatmap.gaussian_heatmaps) inside the
        # train step, freeing the (single-core) host of cv2 resize+blur work
        self.compute_heatmaps = compute_heatmaps

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        path = os.path.join(self.dataset_path, str(self.images[index]))
        image = imread_bgr(path)  # native C++ decode when built
        if image is None:
            raise FileNotFoundError(path)
        orig_size = image.shape
        name = str(self.images[index]).split(".")[0]
        image = prep_image(image, self.target_image_size)

        if self.compute_heatmaps:
            hm = prep_label(np.asarray(self.labels[index]),
                            self.target_image_size, orig_size,
                            str(self.images[index]))
        else:
            hm = np.zeros((len(self.labels[index]), 1, 1), np.float32)
        h_scale, w_scale = get_scale(orig_size, self.target_image_size)
        pts = scale_keypoints(self.labels[index], h_scale, w_scale).astype(np.float32)
        pts = pts / self.target_image_size[0]

        # BGR→ RGB? The reference trains on cv2's BGR order directly
        # (dataset.py:37-55 never converts); keep BGR for weight parity.
        img = image.astype(np.float32) / 255.0
        return img, hm.astype(np.float32), pts, name, orig_size


class RektNetLoader:
    """Single-process batcher matching the reference's DataLoader usage
    (shuffle=False, num_workers=0 — train_eval.py:255-258), with optional
    threading for throughput."""

    def __init__(self, dataset: ConeDataset, batch_size: int, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            batches = [range(i, min(i + self.batch_size, n))
                       for i in range(0, n, self.batch_size)]
            with ThreadPoolExecutor(self.num_workers) as pool:
                # bounded pipeline, same rationale as data/loader.DataLoader:
                # Executor.map submits EVERY item up front, so workers would
                # decode the whole dataset ahead of the consumer and
                # accumulate it in memory; keep ≤2 batches in flight instead
                prefetch = 2
                window = [[pool.submit(self.dataset.__getitem__, i)
                           for i in b] for b in batches[:prefetch]]
                nxt = prefetch
                for _ in range(len(batches)):
                    futs = window.pop(0)
                    if nxt < len(batches):
                        window.append([
                            pool.submit(self.dataset.__getitem__, i)
                            for i in batches[nxt]])
                        nxt += 1
                    yield self._stack([f.result() for f in futs])
        else:
            yield from self._batch(map(self.dataset.__getitem__, range(n)))

    def _batch(self, items):
        buf = []
        for it in items:
            buf.append(it)
            if len(buf) == self.batch_size:
                yield self._stack(buf)
                buf = []
        if buf:
            yield self._stack(buf)

    @staticmethod
    def _stack(buf):
        imgs = np.stack([b[0] for b in buf])
        hms = np.stack([b[1] for b in buf])
        pts = np.stack([b[2] for b in buf])
        names = [b[3] for b in buf]
        sizes = [b[4] for b in buf]
        return imgs, hms, pts, names, sizes
