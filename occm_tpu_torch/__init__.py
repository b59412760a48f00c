"""occm_tpu_torch — the PyTorch/CUDA port of occm_tpu for one NVIDIA H100.

The JAX package `occm_tpu` stays the reference; this package imports none
of it. It serves the XLSR-300M + AASIST one-class scorer over HTTP
(`python -m occm_tpu_torch.cli.oc_server`), with the attention of the
transformer running as a hand-written CUDA kernel (csrc/, built by nvcc
at first use). Training comes in a later slice.
"""

__version__ = "0.1.0"
