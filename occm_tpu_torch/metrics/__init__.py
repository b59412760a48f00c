from occm_tpu_torch.metrics.eer import (
    compute_det_curve,
    compute_eer,
    calculate_confusion_matrix,
)
from occm_tpu_torch.metrics.tdcf import (
    AsvErrorRates,
    TDCFCostModel,
    asv_error_rates,
    compute_min_tdcf,
    compute_tdcf_curve,
    read_asv_scores,
)

__all__ = [
    "compute_det_curve",
    "compute_eer",
    "calculate_confusion_matrix",
    "AsvErrorRates",
    "TDCFCostModel",
    "asv_error_rates",
    "compute_min_tdcf",
    "compute_tdcf_curve",
    "read_asv_scores",
]
