"""``train_eval.py`` CLI surface (RektNet/train_eval.py:188-284 parity)."""

from __future__ import annotations

import argparse
import os
import sys
import uuid

from mit_driverless_cv_traininginfra.train import rektnet_driver
from mit_driverless_cv_traininginfra.utils.logger import Logger, add_bool_arg


def main(argv=None) -> int:
    from mit_driverless_cv_traininginfra.utils.jaxcache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    parser = argparse.ArgumentParser(description="RektNet training")
    parser.add_argument("--study_name", type=str, default="rektnet")
    parser.add_argument("--train_dataset_uri", type=str,
                        default="dataset/rektnet_label.csv")
    parser.add_argument("--dataset_path", type=str, default="dataset/RektNet_Dataset/")
    parser.add_argument("--output_path", type=str, default="automatic")
    parser.add_argument("--loss_type", type=str, default="l1_softargmax",
                        help="l2_softargmax|l2_heatmap|l1_softargmax")
    parser.add_argument("--validation_ratio", type=float, default=0.15)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_epochs", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=1e-1)
    parser.add_argument("--lr_gamma", type=float, default=0.999)
    parser.add_argument("--geo_loss_gamma_horz", type=float, default=0.0)
    parser.add_argument("--geo_loss_gamma_vert", type=float, default=0.0)
    parser.add_argument("--checkpoint_interval", type=int, default=4)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--cache_location", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--seed", type=int, default=17)
    add_bool_arg(parser, "geo_loss", True, "enable the geometric loss")
    add_bool_arg(parser, "evaluate_mode", False, "evaluate only")
    add_bool_arg(parser, "save_checkpoints", True, "save checkpoints")
    add_bool_arg(parser, "cross_batch_geo", True,
                 "reference cross-batch geo-loss semantics")
    # default None -> driver "auto": bf16 on the GPU, f32 elsewhere
    add_bool_arg(parser, "mixed_precision", None, "bf16 compute with f32 master weights")
    add_bool_arg(parser, "device_targets", False, "synthesise heatmap targets on-device")
    add_bool_arg(parser, "resume", False, "resume from the output_path state checkpoint")
    add_bool_arg(parser, "vis_upload_data", False,
                 "render the whole dataset with keypoints, then exit "
                 "(train_eval.py:249-252)")
    add_bool_arg(parser, "post_run_shutdown", False,
                 "ops hook: shut the instance down after the "
                 "vis_upload_data pass (the reference's 'sudo shutdown now')")
    opt = parser.parse_args(argv)

    if opt.output_path == "automatic":
        opt.output_path = os.path.join("outputs", str(uuid.uuid4()))
    os.makedirs("logs", exist_ok=True)
    sys.stdout = Logger(os.path.join("logs", opt.study_name + ".log"))
    sys.stderr = Logger(os.path.join("logs", opt.study_name + ".error"))

    rektnet_driver.main(
        train_dataset_uri=opt.train_dataset_uri,
        dataset_path=opt.dataset_path,
        output_path=opt.output_path,
        batch_size=opt.batch_size,
        num_epochs=opt.num_epochs,
        lr=opt.lr,
        lr_gamma=opt.lr_gamma,
        validation_ratio=opt.validation_ratio,
        loss_type=opt.loss_type,
        include_geo=opt.geo_loss,
        geo_loss_gamma_horz=opt.geo_loss_gamma_horz,
        geo_loss_gamma_vert=opt.geo_loss_gamma_vert,
        cross_batch=opt.cross_batch_geo,
        checkpoint_interval=opt.checkpoint_interval,
        study_name=opt.study_name,
        evaluate_mode=opt.evaluate_mode,
        save_checkpoints=opt.save_checkpoints,
        cache_location=opt.cache_location,
        checkpoint_path=opt.checkpoint_path,
        num_workers=opt.num_workers,
        n_devices=opt.n_devices,
        seed=opt.seed,
        mixed_precision=("auto" if opt.mixed_precision is None else opt.mixed_precision),
        device_targets=opt.device_targets,
        resume=opt.resume,
        vis_upload_data=opt.vis_upload_data,
        post_run_shutdown=opt.post_run_shutdown,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
