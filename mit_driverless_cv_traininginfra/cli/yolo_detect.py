"""``detect.py`` CLI surface (CVC-YOLOv3/detect.py:198-245): single-image
and video detection with box rendering."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mit_driverless_cv_traininginfra.utils.logger import add_bool_arg


def single_img_detect(spec, params, state, target_path, output_path, mode,
                      conf_thres, nms_thres):
    from PIL import Image, ImageDraw

    from mit_driverless_cv_traininginfra.infer.detect import detect_image

    img = Image.open(target_path).convert("RGB")
    boxes, scores = detect_image(spec, params, state, np.asarray(img),
                                 conf_thresh=conf_thres, nms_thresh=nms_thres)
    out_img = Image.open(target_path)
    draw = ImageDraw.Draw(out_img)
    for b in boxes:
        draw.rectangle((float(b[0]), float(b[1]), float(b[2]), float(b[3])),
                       outline="red")
    if mode == "image":
        dest = os.path.join(output_path, os.path.basename(target_path))
    else:
        dest = target_path
    out_img.save(dest)
    return dest


def detect_video(spec, params, state, target_path, output_path, conf_thres,
                 nms_thres):
    """Per-frame detect + re-encode with the original FPS
    (detect.py:143-194, via cv2 VideoCapture/Writer directly)."""
    import cv2

    from mit_driverless_cv_traininginfra.infer.detect import detect_image

    cap = cv2.VideoCapture(target_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {target_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    os.makedirs(output_path, exist_ok=True)
    # always re-encode to .mp4: mp4v fourcc into other containers fails
    # silently (writer.write on an unopened VideoWriter is a no-op)
    base = os.path.splitext(os.path.basename(target_path))[0]
    dest = os.path.join(output_path, "detected_" + base + ".mp4")
    writer = cv2.VideoWriter(dest, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        cap.release()
        raise RuntimeError(f"cannot open video writer for {dest}")
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        boxes, _ = detect_image(spec, params, state, rgb,
                                conf_thresh=conf_thres, nms_thresh=nms_thres)
        for b in boxes:
            cv2.rectangle(frame, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])),
                          (0, 0, 255), 2)
        writer.write(frame)
        n += 1
    cap.release()
    writer.release()
    print(f"{n} frames processed -> {dest}")
    return dest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="YOLO detection")
    parser.add_argument("--target_path", type=str, required=True,
                        help="image or video to run detection on")
    parser.add_argument("--output_path", type=str, default="outputs/visualization/")
    parser.add_argument("--weights_path", type=str, required=True)
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--conf_thres", type=float, default=0.8)
    parser.add_argument("--nms_thres", type=float, default=0.25)
    parser.add_argument("--xy_loss", type=float, default=2.0)
    parser.add_argument("--wh_loss", type=float, default=1.6)
    parser.add_argument("--no_object_loss", type=float, default=25.0)
    parser.add_argument("--object_loss", type=float, default=0.1)
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchor list")
    opt = parser.parse_args(argv)

    import jax

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.models.darknet import (
        fold_bn,
        init_params,
        load_darknet_weights,
    )

    spec = load_network_spec(opt.model_cfg, vanilla_anchor=opt.vanilla_anchor)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    params, state, _ = load_darknet_weights(spec, params, state, opt.weights_path)
    params = fold_bn(params, state, spec)
    state = {}

    os.makedirs(opt.output_path, exist_ok=True)
    ext = os.path.splitext(opt.target_path)[1].lower()
    if ext in (".mp4", ".avi", ".mov", ".mkv"):
        detect_video(spec, params, state, opt.target_path, opt.output_path,
                     opt.conf_thres, opt.nms_thres)
    else:
        dest = single_img_detect(spec, params, state, opt.target_path,
                                 opt.output_path, "image", opt.conf_thres,
                                 opt.nms_thres)
        print(f"Saved detection to {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
