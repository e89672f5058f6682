"""``RektNet/detect.py`` CLI surface: run the keypoint net on one cone crop,
write the heatmap strip + keypoints drawn on the original image
(RektNet/detect.py:13-55)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="RektNet detection")
    parser.add_argument("--model", type=str, required=True,
                        help=".pt checkpoint")
    parser.add_argument("--img", type=str, required=True)
    parser.add_argument("--img_size", type=int, default=80)
    parser.add_argument("--output", type=str, default="outputs/visualization/")
    opt = parser.parse_args(argv)

    import cv2
    import jax.numpy as jnp

    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.utils.vis import (
        vis_hm_strip_and_save,
        vis_tensor_and_save,
    )

    params, state = rektnet.load_torch_checkpoint(opt.model)
    image = cv2.imread(opt.img)
    if image is None:
        raise FileNotFoundError(opt.img)
    h, w, _ = image.shape
    image_size = (opt.img_size, opt.img_size)
    resized = cv2.resize(image, image_size)
    x = jnp.asarray(resized[None].astype(np.float32) / 255.0)
    hm, points, _ = rektnet.apply(params, state, x)

    os.makedirs(opt.output, exist_ok=True)
    name = os.path.basename(opt.img).split(".")[0]
    # per-keypoint vertical strip, each channel min-max normalised — the
    # reference detect CLI's "_hm.jpg" output (detect.py:40-48), NOT the
    # summed single map utils.vis_hm_and_save draws for the train harness
    vis_hm_strip_and_save(np.asarray(hm[0]), name, output_uri=opt.output)
    vis_tensor_and_save(image.copy(), h, w, np.asarray(points[0]), name,
                        opt.output)
    print(f"keypoints: {np.asarray(points[0]).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
