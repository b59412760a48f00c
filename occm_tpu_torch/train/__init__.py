from occm_tpu_torch.train.checkpoint import save_checkpoint
from occm_tpu_torch.train.loop import train, train_step
from occm_tpu_torch.train.state import (
    TrainState, create_train_state, make_optimizer)

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "save_checkpoint", "train", "train_step"]
