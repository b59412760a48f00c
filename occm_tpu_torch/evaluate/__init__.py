from occm_tpu_torch.evaluate.eval_scores import (
    calculate_eer_from_labels,
    calculate_eer_merged,
    calculate_tdcf_merged,
    evaluate_scores,
)

__all__ = [
    "calculate_eer_from_labels",
    "calculate_eer_merged",
    "calculate_tdcf_merged",
    "evaluate_scores",
]
