"""JAX rebuild of the MIT Driverless CV training infrastructure.

A JAX/XLA re-design (not a port) of
cv-core/MIT-Driverless-CV-TrainingInfra: the CVC-YOLOv3 cone detector and the
RektNet 7-keypoint regressor, unified into one framework with

- functional pytree models compiled by XLA (NHWC convs, bf16),
- fixed-shape, mask-based ops everywhere (batched NMS, target assignment),
- data parallelism over a device mesh via ``jax.sharding`` + ``jit``,
- host-side input pipeline feeding on-device preprocessing,
- legacy interop: Darknet ``.cfg``/``.weights``, the label CSV formats, and
  ONNX export, so datasets and weights from the reference run unchanged.
"""

__version__ = "0.1.0"

from mit_driverless_cv_traininginfra.config.darknet_cfg import (  # noqa: F401
    parse_model_config,
    load_network_spec,
)
