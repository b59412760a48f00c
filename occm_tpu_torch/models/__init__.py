from occm_tpu_torch.models.aasist import AASISTBackend, AModel
from occm_tpu_torch.models.cnn import (
    CNNNet,
    CNNNetBasic,
    CNNNetComplex,
    CNNNetWithAttention,
    SpatialAttention,
)
from occm_tpu_torch.models.combined import (
    OCCM,
    SSLLCNN,
    SSLResNet34,
    TotalCNNNet,
)
from occm_tpu_torch.models.convert import (
    detect_model_kind,
    load_reference_state_dict,
    state_dict_from_flax,
    xlsr_state_dict_from_flax,
)
from occm_tpu_torch.models.lcnn import LCNN, AngleLinear
from occm_tpu_torch.models.senet import SEResNet, se_resnet12, se_resnet34
from occm_tpu_torch.models.xlsr import SSLModel, XLSREncoder

__all__ = [
    "AASISTBackend",
    "AModel",
    "AngleLinear",
    "CNNNet",
    "CNNNetBasic",
    "CNNNetComplex",
    "CNNNetWithAttention",
    "LCNN",
    "OCCM",
    "SEResNet",
    "SSLLCNN",
    "SSLModel",
    "SSLResNet34",
    "SpatialAttention",
    "TotalCNNNet",
    "XLSREncoder",
    "detect_model_kind",
    "load_reference_state_dict",
    "se_resnet12",
    "se_resnet34",
    "state_dict_from_flax",
    "xlsr_state_dict_from_flax",
]
