from occm_tpu_torch.classify.impl_select import select_attention_impl

__all__ = ["select_attention_impl"]
