from occm_tpu_torch.audio.frontend import pad as pad_numpy
from occm_tpu_torch.audio.frontend import zero_pad_to_max

__all__ = ["pad_numpy", "zero_pad_to_max"]
