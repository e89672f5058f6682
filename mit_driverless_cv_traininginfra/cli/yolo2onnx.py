"""``yolo2onnx.py`` CLI surface (reference yolo2onnx.py:668-680): convert a
cfg + .weights pair into an ONNX model (raw pre-yolo outputs, onnx_height)."""

from __future__ import annotations

import argparse
import sys

from mit_driverless_cv_traininginfra.utils.logger import add_bool_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="YOLO cfg+weights → ONNX")
    parser.add_argument("--cfg_name", type=str, required=True)
    parser.add_argument("--weights_name", type=str, required=True)
    parser.add_argument("--output", type=str, default=None,
                        help="defaults to <cfg>_<width><onnx_height>.onnx")
    add_bool_arg(parser, "vanilla_anchor", True, "use the vanilla anchor list")
    opt = parser.parse_args(argv)

    import jax

    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.export.yolo2onnx import export_yolo_onnx
    from mit_driverless_cv_traininginfra.models.darknet import (
        init_params,
        load_darknet_weights,
    )

    spec = load_network_spec(opt.cfg_name, vanilla_anchor=opt.vanilla_anchor)
    params, state = init_params(spec, jax.random.PRNGKey(0))
    params, state, _ = load_darknet_weights(spec, params, state, opt.weights_name)
    out = opt.output or spec.net.onnx_name(opt.cfg_name)
    export_yolo_onnx(spec, params, state, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
