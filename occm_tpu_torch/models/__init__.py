from occm_tpu_torch.models.aasist import AASISTBackend, AModel
from occm_tpu_torch.models.convert import (
    load_reference_state_dict,
    state_dict_from_flax,
    xlsr_state_dict_from_flax,
)
from occm_tpu_torch.models.xlsr import SSLModel, XLSREncoder

__all__ = [
    "AASISTBackend",
    "AModel",
    "SSLModel",
    "XLSREncoder",
    "load_reference_state_dict",
    "state_dict_from_flax",
    "xlsr_state_dict_from_flax",
]
