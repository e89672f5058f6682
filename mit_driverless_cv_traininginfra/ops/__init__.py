from mit_driverless_cv_traininginfra.ops.boxes import (  # noqa: F401
    add_class_dimension_to_labels,
    add_padding_on_each_side,
    bbox_iou,
    bbox_iou_pairwise,
    calculate_padding,
    scale_labels,
    xyhw2xyxy_corner,
    xywh2xyxy,
    xyxy2xywh,
)
from mit_driverless_cv_traininginfra.ops.patches import (  # noqa: F401
    filter_and_offset_labels,
    get_patch_bounds,
    get_patch_spacings,
    pre_tile_padding,
)
from mit_driverless_cv_traininginfra.ops.nms import nms, batched_nms  # noqa: F401
from mit_driverless_cv_traininginfra.ops.image import (  # noqa: F401
    letterbox,
    resize_bilinear,
    roi_crop_bilinear,
    roi_crop_bilinear_indexed,
)
