from occm_tpu_torch.data.datasets import PFDataset
from occm_tpu_torch.data.pipeline import MetaBatchPipeline, Prefetcher
from occm_tpu_torch.data.sampler import PFSampler

__all__ = ["MetaBatchPipeline", "PFDataset", "PFSampler", "Prefetcher"]
