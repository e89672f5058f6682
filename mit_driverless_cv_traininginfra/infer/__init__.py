from mit_driverless_cv_traininginfra.infer.capacity import (  # noqa: F401
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra.infer.pipeline import (  # noqa: F401
    PipelineOut,
    two_stage_pipeline,
    two_stage_pipeline_int8,
)
from mit_driverless_cv_traininginfra.infer.serving import (  # noqa: F401
    TwoStageServer,
)
from mit_driverless_cv_traininginfra.infer.microbatch import (  # noqa: F401
    MicroBatcher,
)
