from mit_driverless_cv_traininginfra.models import rektnet  # noqa: F401
from mit_driverless_cv_traininginfra.models.cross_ratio_loss import (  # noqa: F401
    cross_ratio_loss,
)
