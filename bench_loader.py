"""Host input-pipeline benchmark: decode+letterbox images/sec on this host.

Compares the PIL fallback path against the native C++ core (libjpeg decode
+ letterbox across the ``native`` thread pool) — the replacement for the
reference's DataLoader worker processes (CVC-YOLOv3/train.py:124-141).
NOTE: this host has a single CPU core, so the pool shows no thread scaling
here; the native win is decode+resize efficiency per core.

``--full`` (VERDICT r2 #5) measures the COMPLETE training feed: on-disk
JPEGs → ``ImageLabelDataset.__getitem__`` (decode + tile-and-scale patch
+ PIL affine + jitter, the hybrid host/device split's host half) through
the prefetching ``DataLoader``, in imgs/sec — comparable directly to the
train-step demand from tools/bench_train.py. ``--full --device-aug``
measures the device-aug host half (decode + patch only; photometric and
flips move into the jitted train step).

Prints one JSON line.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
from PIL import Image


def bench_full_feed(n_images=48, size=(1600, 1200), out=416, batch=32,
                    epochs=2, device_aug=False, num_workers=8):
    """Full ImageLabelDataset feed from disk JPEGs, imgs/sec through the
    DataLoader (host half of the hybrid augmentation split)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mit_driverless_cv_traininginfra.data.loader import DataLoader
    from mit_driverless_cv_traininginfra.data.yolo_csv import (
        YoloCsvRow,
        write_yolo_csv,
    )
    from mit_driverless_cv_traininginfra.data.yolo_dataset import (
        ImageLabelDataset,
    )

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as td:
        img_dir = os.path.join(td, "imgs")
        os.makedirs(img_dir)
        rows = []
        for i in range(n_images):
            arr = rng.integers(0, 255, (size[1], size[0], 3), np.uint8)
            name = f"{i}.jpg"
            Image.fromarray(arr).save(os.path.join(img_dir, name), quality=90)
            boxes = np.stack([
                rng.uniform(40, size[0] - 140, 4),
                rng.uniform(40, size[1] - 140, 4),
                rng.uniform(30, 90, 4),           # h
                rng.uniform(20, 60, 4),           # w
            ], axis=1).astype(np.float32)
            rows.append(YoloCsvRow(image=name, width=size[0], height=size[1],
                                   scale=0.5, boxes=boxes))
        csv_path = os.path.join(td, "train.csv")
        write_yolo_csv(csv_path, rows, anchors=[(10, 13)] * 9)

        ds = ImageLabelDataset(
            csv_path, img_dir, width=out, height=out, ts=True,
            # hybrid split: host does decode+patch+affine, device does
            # photometric — unless device_aug ships the raw patches
            augment_affine=not device_aug, data_aug=not device_aug,
            device_aug=device_aug, seed=3)
        loader = DataLoader(ds, batch, shuffle=True, num_workers=num_workers,
                            seed=3)
        # warm one epoch (caches, allocator), then measure
        for _ in loader:
            pass
        t0 = time.perf_counter()
        n = 0
        for _ in range(epochs):
            for _, imgs, _ in loader:
                n += imgs.shape[0]
        rate = n / (time.perf_counter() - t0)
    return rate, len(ds)


def main_full(argv):
    device_aug = "--device-aug" in argv
    rate, n_samples = bench_full_feed(device_aug=device_aug)
    print(json.dumps({
        "metric": "host_full_feed_imgs_per_s",
        "mode": "device_aug" if device_aug else "host_affine",
        "value": round(rate, 1),
        "n_samples_per_epoch": n_samples,
    }))
    return 0


def main(n_images=64, size=(1024, 768), out=(416, 416)):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import native

    from mit_driverless_cv_traininginfra.data.decode import open_rgb

    rng = np.random.default_rng(0)
    blobs = []
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(n_images):
            arr = rng.integers(0, 255, (size[1], size[0], 3), np.uint8)
            p = os.path.join(td, f"{i}.jpg")
            Image.fromarray(arr).save(p, quality=90)
            paths.append(p)
            with open(p, "rb") as f:
                blobs.append(f.read())

        # PIL: decode + letterbox-equivalent resize
        t0 = time.perf_counter()
        for p in paths:
            img = Image.open(p).convert("RGB")
            img.resize(out, Image.BILINEAR)
        pil_rate = n_images / (time.perf_counter() - t0)

        # seam (native decode when built, PIL geometry)
        t0 = time.perf_counter()
        for p in paths:
            open_rgb(p).resize(out, Image.BILINEAR)
        seam_rate = n_images / (time.perf_counter() - t0)

        nat_rate = None
        if native.available():
            native.decode_letterbox_batch(blobs[:4], out[1], out[0])  # warm
            t0 = time.perf_counter()
            _, fails = native.decode_letterbox_batch(blobs, out[1], out[0],
                                                     n_threads=8)
            nat_rate = n_images / (time.perf_counter() - t0)
            assert fails == 0

    print(json.dumps({
        "metric": "host_decode_letterbox_imgs_per_s",
        "n_images": n_images,
        "src_size": list(size),
        "pil_imgs_per_s": round(pil_rate, 1),
        "seam_imgs_per_s": round(seam_rate, 1),
        "native_batch_imgs_per_s": (round(nat_rate, 1)
                                    if nat_rate is not None else None),
        "native_active": native.available(),
    }))
    return 0


if __name__ == "__main__":
    if "--full" in sys.argv:
        sys.exit(main_full(sys.argv))
    sys.exit(main())
