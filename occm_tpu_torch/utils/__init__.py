from occm_tpu_torch.utils.device import resolve_device
from occm_tpu_torch.utils.init_template import random_init_

__all__ = ["resolve_device", "random_init_"]
