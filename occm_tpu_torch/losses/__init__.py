from occm_tpu_torch.losses.oneclass import pairwise_distance

__all__ = ["pairwise_distance"]
