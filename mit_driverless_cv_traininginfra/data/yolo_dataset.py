"""Tile-and-scale training dataset (reference ``ImageLabelDataset``,
utils/datasets.py:34-315) — host side, torch-free.

Per image, tile-and-scale (``ts``) mode:
  scale by the per-resolution CSV factor → pad to the patch grid → pick one
  random patch per sample (dataset length is pre-expanded to n_patches
  entries per image, :71-79) → filter/clip labels to the patch.
Non-ts mode: letterbox pad + resize.

Label pipeline: add class dim → corner xyxy → scale → pad-offset → patch
filter → augment → normalise to xywh → zero-pad to ``num_targets_per_image``
rows. Raises on negative final labels like the reference (:313-314).

Returns numpy NHWC float32 images in [0,1] — the device pipeline consumes
batches straight from here via the prefetching loader.
"""

from __future__ import annotations

import os
import random
import sys
import threading
from typing import List, Tuple

import numpy as np

from mit_driverless_cv_traininginfra.data import augment as A
from mit_driverless_cv_traininginfra.data.decode import open_rgb
from mit_driverless_cv_traininginfra.data.yolo_csv import read_yolo_csv
from mit_driverless_cv_traininginfra.ops.boxes import calculate_padding
from mit_driverless_cv_traininginfra.ops.patches import (
    filter_and_offset_labels,
    get_patch_bounds,
    get_patch_spacings,
    pre_tile_padding,
)

VIS_DIR = "outputs/visualization"


def _np_xyhw_to_corner_with_class(boxes: np.ndarray) -> np.ndarray:
    """[x, y, h, w] top-left → [0, x1, y1, x2, y2] (class col prepended)."""
    n = boxes.shape[0]
    out = np.zeros((n, 5), np.float32)
    out[:, 1] = boxes[:, 0]
    out[:, 2] = boxes[:, 1]
    out[:, 3] = boxes[:, 0] + boxes[:, 3]
    out[:, 4] = boxes[:, 1] + boxes[:, 2]
    return out


class ImageLabelDataset:
    """Map-style dataset with the reference's constructor surface."""

    def __init__(
        self,
        path: str,
        dataset_path: str,
        width: int,
        height: int,
        augment_affine: bool = False,
        num_images: int = -1,
        augment_hsv: bool = False,
        lr_flip: bool = False,
        ud_flip: bool = False,
        bw: bool = False,
        vis_batch: int = 0,
        data_aug: bool = False,
        blur: bool = False,
        salt: bool = False,
        noise: bool = False,
        contrast: bool = False,
        sharpen: bool = False,
        ts: bool = True,
        debug_mode: bool = False,
        seed: int = 17,
        device_aug: bool = False,
    ):
        from mit_driverless_cv_traininginfra.data.uri import resolve_uri
        table = read_yolo_csv(resolve_uri(path))  # gs:// via local mirror
        self.img_files: List[str] = []
        self.labels: List[np.ndarray] = []
        self.scales: List[float] = []
        self.ts = ts
        self.debug_mode = debug_mode
        self.width = width
        self.height = height

        for row in table.rows:
            new_w = int(row.width * row.scale)
            new_h = int(row.height * row.scale)
            vert_pad, horiz_pad = pre_tile_padding(new_w, new_h, width, height)
            full = os.path.join(dataset_path, row.image)
            if ts:
                _, _, n_patches, _, _ = get_patch_spacings(
                    new_w + horiz_pad * 2, new_h + vert_pad * 2, width, height
                )
                self.img_files.extend([full] * n_patches)
                self.labels.extend([row.boxes] * n_patches)
                self.scales.extend([row.scale] * n_patches)
            else:
                self.img_files.append(full)
                self.labels.append(row.boxes)
                self.scales.append(row.scale)

        self._seed = seed
        self._epoch = 0
        self._rng = random.Random(seed)  # constructor-time subset pick only
        if num_images >= 0 and num_images < len(self.img_files):
            idx = self._rng.sample(range(len(self.img_files)), k=num_images)
            self.img_files = [self.img_files[i] for i in idx]
            self.labels = [self.labels[i] for i in idx]
            self.scales = [self.scales[i] for i in idx]

        self.num_targets_per_image = max((len(l) for l in self.labels), default=0)

        self.augment_affine = augment_affine
        self.augment_hsv = augment_hsv
        self.lr_flip = lr_flip
        self.ud_flip = ud_flip
        self.data_aug = data_aug
        self.bw = bw
        self.vis_batch = vis_batch
        self.vis_counter = 0
        self._vis_lock = threading.Lock()
        self.blur = blur
        self.salt = salt
        self.noise = noise
        self.contrast = contrast
        self.sharpen = sharpen
        # device_aug: skip all host-side augmentation and keep labels in
        # pixel corner format — ops.device_aug.augment_batch runs inside the
        # jitted train step instead (BASELINE: on-device XLA preprocessing)
        self.device_aug = device_aug

    def __len__(self) -> int:
        return len(self.img_files)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item RNG stream (DistributedSampler.set_epoch
        pattern): augmentation draws are keyed on (seed, epoch, index), so
        the same index re-augments differently across epochs while staying
        deterministic regardless of loader worker count or batch order."""
        self._epoch = int(epoch)

    def _item_rngs(self, index: int):
        mix = (self._seed * 1_000_003 + self._epoch) * 1_000_003 + index
        return random.Random(mix), np.random.default_rng(
            [self._seed, self._epoch, index])

    def _pad_labels(self, labels: np.ndarray) -> np.ndarray:
        pad = self.num_targets_per_image - len(labels)
        if pad > 0:
            labels = np.concatenate([labels, np.zeros((pad, 5), np.float32)], 0)
        return labels

    def _vis(self, img, labels, uri: str, suffix: str, color: str):
        """Stage-by-stage artifact dump for the --vis_batch harness
        (utils/datasets.py:134-140,182-224: original/scaled/per-patch/
        pre-aug/post-aug renders into the visualization dir)."""
        from mit_driverless_cv_traininginfra.utils.vis import (
            visualize_and_save_to_local,
        )

        name = os.path.basename(uri).rsplit(".", 1)[0]
        path = os.path.join(VIS_DIR, f"{name}_{suffix}.jpg")
        visualize_and_save_to_local(img.copy(), labels, path, box_color=color)
        print(f"new image saved to {path}")

    def __getitem__(self, index: int) -> Tuple[str, np.ndarray, np.ndarray]:
        from PIL import Image

        # per-item RNGs: __getitem__ runs concurrently on loader worker
        # threads, so drawing from a shared Random would destroy seed
        # reproducibility and interleave streams across items
        rng, np_rng = self._item_rngs(index)
        img_uri = self.img_files[index]
        img_boxes = self.labels[index]
        orig_img = open_rgb(img_uri)  # native C++ decode when built
        if self.vis_batch and len(img_boxes) > 0:
            raw = _np_xyhw_to_corner_with_class(np.asarray(img_boxes, np.float32))
            self._vis(orig_img, raw, img_uri, "original", "green")

        if self.ts:
            scale = self.scales[index]
            ow, oh = orig_img.size
            scaled_img = orig_img.resize(
                (int(ow * scale), int(oh * scale)), Image.LANCZOS
            )
            sw, sh = scaled_img.size
            pw, ph = self.width, self.height
            vert_pad, horiz_pad = pre_tile_padding(sw, sh, pw, ph)
            padded = Image.new("RGB", (sw + 2 * horiz_pad, sh + 2 * vert_pad),
                               (127, 127, 127))
            padded.paste(scaled_img, (horiz_pad, vert_pad))
            _, _, n_patches, _, _ = get_patch_spacings(padded.size[0], padded.size[1], pw, ph)
            patch_index = 0 if self.debug_mode else rng.randint(0, n_patches - 1)
            boundary = get_patch_bounds(padded.size[0], padded.size[1], pw, ph, patch_index)
            img = padded.crop(boundary)
            ratio = None
        else:
            ow, oh = orig_img.size
            vert_pad, horiz_pad, ratio = calculate_padding(
                oh, ow, self.height, self.width)
            padded = Image.new("RGB", (ow + 2 * horiz_pad, oh + 2 * vert_pad),
                               (127, 127, 127))
            padded.paste(orig_img, (horiz_pad, vert_pad))
            img = padded.resize((self.width, self.height), Image.BILINEAR)

        if len(img_boxes) == 0:
            if self.bw:
                img = img.convert("L")
            arr = np.asarray(img, np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[..., None]
            return img_uri, arr, self._pad_labels(np.zeros((0, 5), np.float32))

        labels = _np_xyhw_to_corner_with_class(np.asarray(img_boxes, np.float32))
        if self.ts:
            labels[:, 1:5] *= self.scales[index]
            labels[:, 1:5] += [horiz_pad, vert_pad, horiz_pad, vert_pad]
            if self.vis_batch:
                self._vis(padded, labels, img_uri, "scaled", "red")
                for pi in range(n_patches):
                    bnd = get_patch_bounds(padded.size[0], padded.size[1],
                                           pw, ph, pi)
                    plabels = filter_and_offset_labels(labels, bnd)
                    self._vis(padded.crop(bnd), plabels, img_uri,
                              f"patch_{pi}", "blue")
            labels = filter_and_offset_labels(labels, boundary)
        else:
            labels[:, 1:5] += [horiz_pad, vert_pad, horiz_pad, vert_pad]
            labels[:, 1:5] *= ratio
            if self.vis_batch:
                self._vis(img, labels, img_uri, "pad_resized", "blue")

        if self.device_aug:
            # host keeps only the affine (PIL's C warp is cheap; the
            # equivalent on-device gather costs ~6 ms/frame) — photometric
            # jitter/flip/noise run on-device in the train step
            if self.augment_affine or self.data_aug:
                img_w, img_h = img.size
                angle = rng.uniform(-10, 10)
                translate = (rng.uniform(-40, 40), rng.uniform(-40, 40))
                sc = rng.uniform(0.9, 1.1)
                shear = rng.uniform(-3, 3)
                img = A.affine_image(img, angle, translate, sc, shear)
                labels = A.affine_labels(img_h, img_w, labels, -angle,
                                         translate, sc, (-shear, 0))
            if self.bw:
                # channel config must be honoured on the host path even
                # in device-aug mode — the on-device photometric step
                # can't change conv1's input channel count
                img = img.convert("L")
            arr = np.asarray(img, np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[..., None]
            return img_uri, arr, self._pad_labels(labels.astype(np.float32))

        if self.vis_batch and self.data_aug:
            self._vis(img, labels, img_uri, "before_aug", "red")
        if (self.augment_hsv or self.data_aug) and rng.random() > 0.5:
            img = A.color_jitter(img, rng)

        img_w, img_h = img.size
        if self.augment_affine or self.data_aug:
            angle = rng.uniform(-10, 10)
            translate = (rng.uniform(-40, 40), rng.uniform(-40, 40))
            sc = rng.uniform(0.9, 1.1)
            shear = rng.uniform(-3, 3)
            img = A.affine_image(img, angle, translate, sc, shear)
            labels = A.affine_labels(img_h, img_w, labels, -angle, translate,
                                     sc, (-shear, 0))

        if self.bw:
            img = img.convert("L")

        if self.lr_flip and rng.random() > 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            # reference quirk: swaps x coords without reordering x1/x2
            # (utils/datasets.py:245-251)
            labels[:, 1] = img_w - labels[:, 1]
            labels[:, 3] = img_w - labels[:, 3]
            labels[:, [1, 3]] = labels[:, [3, 1]]

        arr = np.asarray(img, np.uint8)
        if self.blur and rng.random() > 0.2:
            arr = A.gaussian_blur(arr, rng.uniform(0, 3.0))
        if self.noise and rng.random() > 0.3:
            arr = A.additive_gaussian_noise(arr, rng.uniform(0, 0.03 * 255),
                                            np_rng)
        if self.contrast and rng.random() > 0.5:
            arr = A.sigmoid_contrast(arr, rng.randint(5, 10), rng.uniform(0.45, 0.75))
        if self.sharpen and rng.random() > 0.3:
            arr = A.sharpen(arr, rng.uniform(0, 0.5))

        if self.vis_batch:
            if self.data_aug:
                self._vis(Image.fromarray(arr if arr.ndim == 3 else arr[..., 0]),
                          labels, img_uri, "post_augmentation", "green")
            with self._vis_lock:
                self.vis_counter += 1
                done = self.vis_counter > (self.vis_batch - 1)
            if done:
                sys.exit("Finished visualizing enough images. Exiting!")

        # normalise to xywh in [0,1] (utils/datasets.py:307-309; the
        # reference's xyxy2xywh builds a NEW tensor). The corner columns
        # MUST be materialized before writing into `out`: numpy column
        # slices are views, so writing cx into out[:, 1] would silently
        # turn the later w = |x2 - x1| into |x2 - cx| ≈ x2 — corrupting
        # every host-path target (caught by the first on-chip production
        # training run: val mAP pinned at 0 while train loss converged).
        out = labels.copy()
        x1, y1 = labels[:, 1].copy(), labels[:, 2].copy()
        x2, y2 = labels[:, 3].copy(), labels[:, 4].copy()
        out[:, 1] = (x1 + x2) / 2 / self.width
        out[:, 2] = (y1 + y2) / 2 / self.height
        out[:, 3] = np.abs(x2 - x1) / self.width
        out[:, 4] = np.abs(y2 - y1) / self.height

        out = self._pad_labels(out.astype(np.float32))
        if (out < 0).sum() > 0:
            raise Exception(f"labels for image {img_uri} have negative values")
        arr = np.asarray(arr, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return img_uri, arr, out
