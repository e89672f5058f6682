"""``RektNet/pt_to_onnx.py`` CLI surface: convert a ``.pt`` checkpoint into
the onnx_mode (raw heatmaps) ONNX model (reference pt_to_onnx.py:27-38)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="RektNet .pt → ONNX")
    parser.add_argument("--model_path", "--model", dest="model_path", type=str,
                        required=True)
    parser.add_argument("--output", type=str, default=None,
                        help="defaults to <model>.onnx")
    parser.add_argument("--img_size", type=int, default=80)
    parser.add_argument("--num_kpt", type=int, default=7)
    opt = parser.parse_args(argv)

    from mit_driverless_cv_traininginfra.export.pt_to_onnx import (
        export_rektnet_onnx,
    )
    from mit_driverless_cv_traininginfra.models import rektnet

    params, state = rektnet.load_torch_checkpoint(opt.model_path)
    out = opt.output or opt.model_path.rsplit(".", 1)[0] + ".onnx"
    export_rektnet_onnx(params, state, out,
                        input_size=(opt.img_size, opt.img_size),
                        num_kpt=opt.num_kpt)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
