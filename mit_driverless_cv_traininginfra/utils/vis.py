"""Visualization utilities (reference ``RektNet/utils.py:41-71,113-150`` and
``CVC-YOLOv3/utils/utils.py:301-312``): keypoint/heatmap/box renderers used
by the detect CLIs and the ``--vis_batch``/``--vis_dataloader`` debug
harnesses. Writes via a temp name then renames, like the reference."""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from PIL import Image, ImageDraw

KPT_COLORS = [(0, 255, 0), (255, 0, 0), (255, 255, 0), (0, 255, 255),
              (255, 0, 255), (127, 255, 127), (255, 127, 127)]


def visualize_and_save_to_local(img: Image.Image, labels, tmp_path: str,
                                box_color: str = "red"):
    """Draw (N,5) [c,x1,y1,x2,y2] boxes on a PIL image and save
    (utils/utils.py:301-312)."""
    if labels is not None:
        draw = ImageDraw.Draw(img)
        for row in np.asarray(labels):
            draw.rectangle((float(row[1]), float(row[2]), float(row[3]),
                            float(row[4])), outline=box_color)
    os.makedirs(os.path.dirname(tmp_path) or ".", exist_ok=True)
    img.save(tmp_path + ".tmp.jpg", format="JPEG")
    os.rename(tmp_path + ".tmp.jpg", tmp_path)


def vis_kpt_and_save(np_image, image_name: str, labels,
                     color=(52, 31, 163), output_uri: str = "outputs/visualization"):
    """Draw keypoints (pixel coords) on an image (RektNet/utils.py:41-48)."""
    for pt in np.asarray(labels):
        cv2.circle(np_image, (int(pt[0]), int(pt[1])), 3, color, -1)
    os.makedirs(output_uri, exist_ok=True)
    dest = os.path.join(output_uri, image_name + "_label_vis.jpg")
    if not cv2.imwrite(dest + ".tmp.jpg", np_image):
        raise Exception("Could not write image")
    os.rename(dest + ".tmp.jpg", dest)
    return dest


def vis_hm_and_save(np_heat_map, image_name: str,
                    output_uri: str = "outputs/visualization"):
    """Sum the per-keypoint heatmaps into one normalised image
    (RektNet/utils.py:50-59)."""
    summed = np.asarray(np_heat_map, np.float64).sum(axis=0)
    lo, hi = summed.min(), summed.max()
    img = Image.fromarray(((summed - lo) * 255.0 / max(hi - lo, 1e-12)).astype(np.uint8))
    os.makedirs(output_uri, exist_ok=True)
    dest = os.path.join(output_uri, image_name + "_heat_map.jpg")
    img.save(dest + ".tmp.jpg", format="JPEG")
    os.rename(dest + ".tmp.jpg", dest)
    return dest


def heatmap_strip(np_heat_map) -> np.ndarray:
    """The reference detect CLI's heatmap rendering (RektNet/detect.py:40-48):
    each keypoint channel min-max normalised INDEPENDENTLY, concatenated
    vertically into a (K·H, W) float array in [0, 1] — per-keypoint quality
    stays inspectable, unlike the summed map."""
    hm = np.asarray(np_heat_map, np.float64)
    rows = []
    for chan in hm:
        lo, hi = chan.min(), chan.max()
        rows.append((chan - lo) / max(hi - lo, 1e-12))
    return np.concatenate(rows, axis=0)


def vis_hm_strip_and_save(np_heat_map, image_name: str,
                          output_uri: str = "outputs/visualization"):
    """Write the per-channel heatmap strip as ``<name>_hm.jpg``
    (RektNet/detect.py:48 ``cv2.imwrite(... + "_hm.jpg", out * 255)``)."""
    strip = (heatmap_strip(np_heat_map) * 255.0).astype(np.uint8)
    os.makedirs(output_uri, exist_ok=True)
    dest = os.path.join(output_uri, image_name + "_hm.jpg")
    Image.fromarray(strip).save(dest + ".tmp.jpg", format="JPEG")
    os.rename(dest + ".tmp.jpg", dest)
    return dest


def vis_tensor_and_save(image, h: int, w: int, tensor_output, image_name: str,
                        output_uri: str):
    """Draw normalised keypoints scaled to the original image
    (RektNet/utils.py:61-71)."""
    for i, pt in enumerate(np.asarray(tensor_output)):
        cv2.circle(image, (int(pt[0] * w), int(pt[1] * h)), 2,
                   KPT_COLORS[i % len(KPT_COLORS)], -1)
    os.makedirs(output_uri, exist_ok=True)
    dest = os.path.join(output_uri, image_name + "_inference.jpg")
    if not cv2.imwrite(dest + ".tmp.jpg", image):
        raise Exception("Could not write image")
    os.rename(dest + ".tmp.jpg", dest)
    return image


def visualize_dataset(images, labels, dataset_path: str,
                      output_uri: str = "outputs/visualization/"):
    """Whole-dataset keypoint render — the reference's ``--vis_upload_data``
    pass (RektNet/utils.py:113-150): pad each image to a square with grey
    128, resize to 1000², draw the keypoint chain in green, write via
    tmp-then-rename. Returns the number of images rendered."""
    import cv2
    import numpy as np

    from mit_driverless_cv_traininginfra.data.decode import imread_bgr

    os.makedirs(output_uri, exist_ok=True)
    n = 0
    for name, label in zip(images, labels):
        img = imread_bgr(os.path.join(dataset_path, str(name)))
        if img is None:
            continue
        h, w, _ = img.shape
        d = abs(h - w)
        if h <= w:
            img = cv2.copyMakeBorder(img, 0, d, 0, 0, cv2.BORDER_CONSTANT,
                                     value=[128, 128, 128])
        else:
            img = cv2.copyMakeBorder(img, 0, 0, 0, d, cv2.BORDER_CONSTANT,
                                     value=[128, 128, 128])
        # normalise by the PADDED square dims (the reference re-reads
        # h, w after copyMakeBorder, utils.py:124) — pre-padding dims
        # would stretch the keypoint chain on every non-square image
        h, w, _ = img.shape
        norm = np.asarray(label, np.float32) / np.asarray([w, h], np.float32)
        img = cv2.resize(img, (1000, 1000))
        prev = None
        for pt in norm:
            cvpt = (int(pt[0] * 1000), int(pt[1] * 1000))
            cv2.circle(img, cvpt, 3, (0, 255, 0), -1)
            if prev is not None:
                cv2.line(img, prev, cvpt, (0, 255, 0), 2)
            prev = cvpt
        dest = os.path.join(output_uri, str(name))
        cv2.imwrite(dest + ".tmp.jpg", img)
        os.rename(dest + ".tmp.jpg", dest)
        n += 1
    return n
