from occm_tpu_torch.data.datasets import ASVDataset, PFDataset
from occm_tpu_torch.data.pipeline import (
    MetaBatchPipeline, Prefetcher, chunk_batches)
from occm_tpu_torch.data.sampler import PFSampler

__all__ = ["ASVDataset", "MetaBatchPipeline", "PFDataset", "PFSampler",
           "Prefetcher", "chunk_batches"]
