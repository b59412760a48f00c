"""occm_tpu_torch — the PyTorch/CUDA port of occm_tpu for one NVIDIA H100.

The JAX package `occm_tpu` stays the reference; this package imports none
of it. It serves the XLSR-300M + AASIST one-class scorer over HTTP
(`python -m occm_tpu_torch.cli.oc_server`) and trains it
(`python -m occm_tpu_torch.cli.oc_training`, or
`occm_tpu_torch.train.train`). Its hand-written CUDA kernels (csrc/, built
by nvcc at first use) are the attention forward and backward, the
LayerNorm backward and fused Adam.
"""

__version__ = "0.2.0"
