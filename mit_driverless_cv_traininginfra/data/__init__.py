from mit_driverless_cv_traininginfra.data.device_pool import (  # noqa: F401
    DevicePool,
)
