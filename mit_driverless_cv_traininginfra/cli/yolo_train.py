"""``train.py`` CLI surface (CVC-YOLOv3/train.py:262-362 argparse parity)."""

from __future__ import annotations

import argparse
import os
import sys

from mit_driverless_cv_traininginfra.train import yolo_driver
from mit_driverless_cv_traininginfra.utils.logger import Logger, add_bool_arg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="YOLO training")

    def boolarg(name, default, help):
        add_bool_arg(parser, name, default, help)

    # default 7 like the reference (train.py:270) — an odd quirk of the
    # original config surface, kept so default invocations match
    parser.add_argument("--batch_size", type=int, default=7)
    parser.add_argument("--optimizer_pick", type=str, default="Adam",
                        choices=["Adam", "SGD"])
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--output_path", type=str, default="automatic")
    parser.add_argument("--dataset_path", type=str, default="dataset/YOLO_Dataset/")
    parser.add_argument("--num_epochs", type=int, default=2048)
    parser.add_argument("--num_steps", type=int, default=8388608)
    parser.add_argument("--checkpoint_interval", type=int, default=1)
    parser.add_argument("--val_tolerance", type=int, default=3)
    parser.add_argument("--min_epochs", type=int, default=3)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--gamma", type=float, default=0.95)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--xy_loss", type=float, default=2.0)
    parser.add_argument("--wh_loss", type=float, default=1.6)
    parser.add_argument("--no_object_loss", type=float, default=25.0)
    parser.add_argument("--object_loss", type=float, default=0.1)
    # extensions beyond the reference surface (defaults off):
    # large-batch from-scratch training (B>=32) needs global-norm clip +
    # lr warmup to avoid early NaN (PERF.md "Training"), and checkpoint
    # evaluation may need a smaller batch than training to fit HBM
    parser.add_argument("--grad_clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 = off)")
    parser.add_argument("--lr_warmup_steps", type=int, default=0,
                        help="linear lr warmup over the first N steps")
    parser.add_argument("--val_batch_size", type=int, default=None,
                        help="validation batch size (default: batch_size)")
    parser.add_argument("--vis_batch", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--seed", type=int, default=17)
    boolarg("evaluate", False, "evaluate only, no training")
    boolarg("resume", False, "resume from the output_path state checkpoint")
    # default None → driver's "auto": bf16 on the GPU, f32 elsewhere;
    # --no_mixed_precision pins f32
    boolarg("mixed_precision", None, "bf16 compute with f32 master weights")
    boolarg("device_aug", False, "run augmentation on-device inside the train step")
    boolarg("packed_stem", False,
            "train blocks 0-1 through the exact space-to-depth rewrite "
            "(the 3-channel conv1 is the step's layout-bound stage)")
    boolarg("preload_device", False,
            "train from a device-resident sample pool (host-bound machines)")
    parser.add_argument("--preload_num", type=int, default=None,
                        help="cap the device pool to this many samples "
                             "(default: whole dataset)")
    parser.add_argument("--preload_budget_gb", type=float, default=6.0,
                        help="HBM budget for the device pool; with bf16 "
                             "mixed precision the pool is stored bf16 "
                             "(half the bytes)")
    # flag names follow the reference exactly (train.py:288-296):
    # --augment_lr_flip etc., so reference-compatible invocations work
    boolarg("augment_affine", False, "enable affine augmentation")
    boolarg("augment_hsv", False, "enable HSV jitter")
    boolarg("augment_lr_flip", False, "enable left-right flips")
    boolarg("augment_ud_flip", False, "enable up-down flips")
    boolarg("data_aug", False, "enable the full augmentation suite")
    boolarg("augment_blur", False, "enable gaussian blur augmentation")
    boolarg("augment_salt", False, "enable salt augmentation")
    boolarg("augment_noise", False, "enable additive gaussian noise")
    boolarg("augment_contrast", False, "enable sigmoid contrast")
    boolarg("augment_sharpen", False, "enable sharpen augmentation")
    boolarg("ts", True, "enable tile-and-scale mode")
    boolarg("debug_mode", False, "batch 1, no shuffle, patch 0")
    boolarg("vanilla_anchor", False, "use the vanilla anchor list")
    boolarg("upload_dataset", False, "upload dataset visualizations")
    return parser


def main(argv=None) -> int:
    # persistent XLA compile cache: every production entry point enables
    # the on-disk cache (utils/jaxcache.py)
    from mit_driverless_cv_traininginfra.utils.jaxcache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    opt = build_parser().parse_args(argv)
    if opt.output_path == "automatic":
        from datetime import datetime

        stem = os.path.basename(opt.model_cfg).split(".")[0]
        month = datetime.now().strftime("%B").lower()
        year = str(datetime.now().year)
        opt.output_path = os.path.join("outputs", f"{month}-{year}-experiments", stem)
    os.makedirs("logs", exist_ok=True)
    stem = os.path.basename(opt.model_cfg).split(".")[0]
    sys.stdout = Logger(os.path.join("logs", stem + ".log"))
    sys.stderr = Logger(os.path.join("logs", stem + ".error"))

    # CLI keeps the reference's --augment_* names; the driver's kwargs use
    # the bare names
    rename = {"augment_lr_flip": "lr_flip", "augment_ud_flip": "ud_flip",
              "augment_blur": "blur", "augment_salt": "salt",
              "augment_noise": "noise", "augment_contrast": "contrast",
              "augment_sharpen": "sharpen"}
    kwargs = {
        rename.get(k, k): v for k, v in vars(opt).items()
        if k not in ("upload_dataset",)
    }
    if kwargs.get("mixed_precision") is None:
        kwargs["mixed_precision"] = "auto"
    yolo_driver.main(**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
