from occm_tpu_torch.classify.impl_select import select_attention_impl
from occm_tpu_torch.classify.scoring import (
    BucketedEmbedder,
    OneClassScorer,
    make_embed_fn_factory,
)

__all__ = [
    "BucketedEmbedder",
    "OneClassScorer",
    "make_embed_fn_factory",
    "select_attention_impl",
]
