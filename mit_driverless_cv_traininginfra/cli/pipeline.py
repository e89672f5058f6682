"""Two-stage pipeline CLI: detect→crop→keypoints on images or video.

The reference composes the two models operationally on the vehicle via
ONNX/TensorRT (README.md:59); here the fused pipeline is exposed directly:
one compiled program per frame batch, boxes + 7 keypoints out.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mit_driverless_cv_traininginfra.utils.logger import add_bool_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="detect→crop→keypoints pipeline")
    parser.add_argument("--target_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="outputs/visualization/")
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--yolo_weights", type=str, required=True)
    parser.add_argument("--rektnet_weights", type=str, required=True,
                        help="RektNet .pt checkpoint")
    parser.add_argument("--conf_thres", type=float, default=0.8)
    parser.add_argument("--nms_thres", type=float, default=0.25)
    parser.add_argument("--max_det", type=int, default=16)
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchor list")
    opt = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from PIL import Image, ImageDraw

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.infer.detect import unletterbox_boxes
    from mit_driverless_cv_traininginfra.infer.pipeline import two_stage_pipeline
    from mit_driverless_cv_traininginfra.models import rektnet
    from mit_driverless_cv_traininginfra.models.darknet import (
        fold_bn,
        init_params,
        load_darknet_weights,
    )
    from mit_driverless_cv_traininginfra.models.stem_opt import (
        build_packed_stem,
        stem_is_packable,
    )
    from mit_driverless_cv_traininginfra.ops.boxes import calculate_padding
    from mit_driverless_cv_traininginfra.ops.image import letterbox
    from mit_driverless_cv_traininginfra.utils.vis import KPT_COLORS

    spec = load_network_spec(opt.model_cfg, vanilla_anchor=opt.vanilla_anchor)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    params, state, _ = load_darknet_weights(spec, params, state, opt.yolo_weights)
    folded = fold_bn(params, state, spec)
    packed = build_packed_stem(folded) if stem_is_packable(spec) else None
    rp, rs = rektnet.load_torch_checkpoint(opt.rektnet_weights)

    def run_frame(img_np):
        h, w = img_np.shape[:2]
        pad_h, pad_w, ratio = calculate_padding(h, w, spec.net.height, spec.net.width)
        boxed, _ = letterbox(jnp.asarray(img_np, jnp.float32)[None] / 255.0,
                             spec.net.height, spec.net.width)
        out = two_stage_pipeline(
            spec, folded, {}, rp, rs, boxed,
            conf_thresh=opt.conf_thres, nms_thresh=opt.nms_thres,
            max_det=opt.max_det, packed_stem=packed,
        )
        m = np.asarray(out.mask[0])
        boxes = np.asarray(unletterbox_boxes(out.boxes[0], pad_h, pad_w, ratio))[m]
        kpts = np.asarray(out.keypoints[0])[m]
        kpts = kpts / ratio - np.asarray([pad_w, pad_h])
        return boxes, kpts, np.asarray(out.scores[0])[m]

    os.makedirs(opt.output_path, exist_ok=True)
    ext = os.path.splitext(opt.target_path)[1].lower()
    if ext in (".mp4", ".avi", ".mov", ".mkv"):
        import cv2

        cap = cv2.VideoCapture(opt.target_path)
        if not cap.isOpened():
            print(f"ERROR: cannot open video {opt.target_path}", file=sys.stderr)
            return 1
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        # always re-encode to .mp4: mp4v fourcc into other containers fails
        base = os.path.splitext(os.path.basename(opt.target_path))[0]
        dest = os.path.join(opt.output_path, "pipeline_" + base + ".mp4")
        writer = cv2.VideoWriter(dest, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w, h))
        if not writer.isOpened():
            print(f"ERROR: cannot open video writer for {dest}", file=sys.stderr)
            cap.release()
            return 1
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            boxes, kpts, scores = run_frame(rgb)
            for b, ks in zip(boxes, kpts):
                cv2.rectangle(frame, (int(b[0]), int(b[1])),
                              (int(b[2]), int(b[3])), (0, 0, 255), 2)
                for i, (x, y) in enumerate(ks):
                    # KPT_COLORS are RGB; cv2 frames are BGR
                    c = KPT_COLORS[i % len(KPT_COLORS)][::-1]
                    cv2.circle(frame, (int(x), int(y)), 3, tuple(c), -1)
            writer.write(frame)
            n += 1
        cap.release()
        writer.release()
        print(f"{n} frames -> {dest}")
        return 0

    img = Image.open(opt.target_path).convert("RGB")
    boxes, kpts, scores = run_frame(np.asarray(img))
    draw = ImageDraw.Draw(img)
    for b, ks in zip(boxes, kpts):
        draw.rectangle(tuple(float(v) for v in b), outline="red", width=2)
        for i, (x, y) in enumerate(ks):
            c = KPT_COLORS[i % len(KPT_COLORS)]
            draw.ellipse((x - 2, y - 2, x + 2, y + 2), fill=tuple(c))
    dest = os.path.join(opt.output_path,
                        "pipeline_" + os.path.basename(opt.target_path))
    img.save(dest)
    print(f"{len(boxes)} cones; keypoints drawn -> {dest}")
    for b, s, ks in zip(boxes, scores, kpts):
        print(f"  box={np.round(b, 1).tolist()} conf={s:.3f} "
              f"kpts={np.round(ks, 1).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
