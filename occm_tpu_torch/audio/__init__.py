from occm_tpu_torch.audio.frontend import pad as pad_numpy

__all__ = ["pad_numpy"]
