"""Flagship model spec: the full YOLOv3 (Darknet-53 + FPN) network at a
given square resolution, generated by the census-exact cfg factory.

Used by the benchmark (416×416, BASELINE.json's headline frame size) and by
the driver's compile check. Mirrors the reference's resolution-parametric
Darknet cfg (``/root/reference/CVC-YOLOv3/model_cfg/yolo_baseline.cfg``).
"""

from __future__ import annotations

import os
import tempfile


def flagship_spec(size: int = 416, classes: int = 80):
    from mit_driverless_cv_traininginfra.config import load_network_spec
    from mit_driverless_cv_traininginfra.config.cfg_factory import yolov3_cfg

    cfg_text = yolov3_cfg(width=size, height=size, classes=classes)
    with tempfile.NamedTemporaryFile("w", suffix=".cfg", delete=False) as f:
        f.write(cfg_text)
        path = f.name
    try:
        # the spec is fully materialised by the parser — the temp file
        # must not leak one orphan per call into /tmp
        return load_network_spec(path, vanilla_anchor=True)
    finally:
        os.unlink(path)
