"""``validate.py`` CLI surface (CVC-YOLOv3/validate.py:184-226): standalone
mAP/recall/precision evaluation over the validate CSV."""

from __future__ import annotations

import argparse
import sys

from mit_driverless_cv_traininginfra.utils.logger import add_bool_arg


def main(argv=None) -> int:
    from mit_driverless_cv_traininginfra.utils.jaxcache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    parser = argparse.ArgumentParser(description="YOLO validation")
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--weights_path", type=str, required=True)
    parser.add_argument("--dataset_path", type=str, default="dataset/YOLO_Dataset/")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--xy_loss", type=float, default=2.0)
    parser.add_argument("--wh_loss", type=float, default=1.6)
    parser.add_argument("--no_object_loss", type=float, default=25.0)
    parser.add_argument("--object_loss", type=float, default=0.1)
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchor list")
    add_bool_arg(parser, "ts", True, "tile-and-scale mode")
    add_bool_arg(parser, "debug_mode", False, "debug visualization mode")
    opt = parser.parse_args(argv)

    import jax

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.data.loader import DataLoader
    from mit_driverless_cv_traininginfra.data.yolo_dataset import ImageLabelDataset
    from mit_driverless_cv_traininginfra.models.darknet import (
        init_params,
        load_darknet_weights,
    )
    from mit_driverless_cv_traininginfra.train.yolo_driver import validate_map

    spec = load_network_spec(opt.model_cfg, vanilla_anchor=opt.vanilla_anchor)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    params, state, _ = load_darknet_weights(spec, params, state, opt.weights_path)

    ds = ImageLabelDataset(spec.net.validate_uri, dataset_path=opt.dataset_path,
                           width=spec.net.width, height=spec.net.height,
                           num_images=spec.net.num_validate_images,
                           bw=spec.net.bw, ts=opt.ts, debug_mode=opt.debug_mode)
    loader = DataLoader(ds, 1 if opt.debug_mode else opt.batch_size,
                        shuffle=False, num_workers=opt.num_workers)
    mAP, mR, mP, latency = validate_map(data_loader=loader, spec=spec,
                                        params=params, model_state=state,
                                        mesh=None)
    print(f"seconds/image: {latency:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
