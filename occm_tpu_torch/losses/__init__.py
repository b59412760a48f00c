from occm_tpu_torch.losses.angle import AngleLossState, angle_loss
from occm_tpu_torch.losses.oneclass import (
    compactness_loss,
    descriptiveness_loss,
    group_one_class_loss,
    one_class_loss,
    pairwise_distance,
)

__all__ = [
    "AngleLossState",
    "angle_loss",
    "compactness_loss",
    "descriptiveness_loss",
    "group_one_class_loss",
    "one_class_loss",
    "pairwise_distance",
]
