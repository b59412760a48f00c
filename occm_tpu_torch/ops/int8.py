"""W8A8 int8 projections for scoring and serving (the port's own copy of
`occm_tpu.ops.int8`).

- weights: offline per-output-channel symmetric int8
  (`quantize_weight_int8`; `quantize_state_dict_int8` rewrites a trained
  fp32 state dict into the layout of `XLSRConfig(quant_int8=True)`);
- activations: dynamic per-row symmetric int8 at run time, one abs-max per
  token (`quantize_rows_int8`);
- the product: int8 x int8 -> int32, exact, then rescaled by
  s_x * w_scale and offset by the bias (`int8_matmul`).

The arithmetic is the JAX package's, operation for operation: the weight
side divides by 127, the activation side multiplies by the fp32 constant
1/127; rounding is half to even; the rescale is (acc * s_x) * w_scale,
then + bias, in fp32, then the cast to the output dtype. `w_scale` and
`bias` may be bf16 (the bf16 parameter mirror): torch's promotion of fp32
with bf16 to fp32 is JAX's.

On a CUDA tensor the int32 product is `torch._int_mm` (cuBLASLt's int8
GEMM). The JAX package computes it with `lax.dot_general` outside any
Pallas kernel, so no hand-written kernel of the port stands in for it. It
takes M > 16 rows (fewer are padded with zero rows, which is exact) and
K and N multiples of 8 (other widths raise). On a CPU tensor the wrapper
takes the plain version, `int8_mm_reference`: an fp64 product of the int8
values, exact because |acc| <= 127^2 * K < 2^53 for every K below 5e8,
cast to int32. Training never takes this path (round and clip have no
useful gradient).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

#: calls of `int8_matmul` since the last reset (chip_smoke.py reads and
#: resets it), on any device; the plain version does not count
CALLS = 0

#: torch._int_mm on CUDA takes more than 16 rows: fewer are padded to
#: _PAD_ROWS (a multiple of 8) with zero rows, whose products are dropped
_INT_MM_MIN_ROWS = 17
_PAD_ROWS = 32

#: module names quantised inside the encoder's transformer layers (the
#: XLSR projections; the conv stem, norms, positional conv and every
#: backend layer, whatever its name, stay fp32)
QUANTIZED_MODULES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")

# `<prefix>encoder.layers.<l>.[self_attn.]<module>.weight`: the projections
# of the transformer stack only (AASIST's, SE-ResNet's and the CNN heads'
# own fc1 / fc2 never sit under `encoder.layers`)
_PROJ = re.compile(r"^(?:.*\.)?encoder\.layers\.\d+\.(?:self_attn\.(?:"
                   + "|".join(QUANTIZED_MODULES[:4]) + ")|"
                   + "|".join(QUANTIZED_MODULES[4:]) + r")\.weight$")


def quantize_weight_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 of a Linear weight [out, in]:
    (q int8 [out, in], scale fp32 [out]); the abs-max over the input axis,
    scale = max(amax, 1e-12) / 127, q = round(w / scale) clipped to
    +-127."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8 of x [..., K] (any float dtype): (x_q int8
    [..., K], s_x fp32 [..., 1]) with s_x = max(amax, 1e-12) * (1/127)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return x_q, s_x


def int8_mm_reference(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain version of the int32 product: x_q [M, K] int8, w_q [N, K] int8
    -> [M, N] int32, as an fp64 product of the int8 values (exact: every
    partial sum is an integer below 2^53)."""
    return torch.matmul(x_q.double(), w_q.double().t()).to(torch.int32)


def int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q [M, K] int8 times w_q [N, K] int8 transposed -> [M, N] int32.

    CUDA tensors take `torch._int_mm` with the weight's transpose, which is
    column-major as cuBLASLt wants it (no copy); fewer than 17 rows are
    padded to 32 with zero rows. CPU tensors take `int8_mm_reference`."""
    if x_q.device != w_q.device:
        raise ValueError(f"x_q on {x_q.device}, w_q on {w_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8 operands expected, got {x_q.dtype}, "
                         f"{w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"x_q [M, K] and w_q [N, K] expected, got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}")
    if x_q.device.type == "cpu":
        return int8_mm_reference(x_q, w_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_mm runs on cuda or cpu, not {x_q.device}")
    m, k = x_q.shape
    n = w_q.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"the int8 GEMM takes K and N multiples of 8, got "
                         f"K={k}, N={n}")
    x_q = x_q.contiguous()
    if m < _INT_MM_MIN_ROWS:
        x_q = torch.cat([x_q, x_q.new_zeros(_PAD_ROWS - m, k)])
    return torch._int_mm(x_q, w_q.t())[:m]


def _dequant(acc: torch.Tensor, s_x: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    y = acc.float() * s_x * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _matmul(x, w_q, w_scale, bias, out_dtype, parts, mm):
    lead = x.shape[:-1]
    x_q, s_x = quantize_rows_int8(x.reshape(-1, x.shape[-1]))
    acc = mm(x_q, w_q)
    y = _dequant(acc, s_x, w_scale, bias, out_dtype)
    y = y.reshape(*lead, w_q.shape[0])
    return (y, x_q, acc) if parts else y


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32,
                parts: bool = False):
    """y = dequant(quant(x) @ w_q^T) + bias.

    x [..., K] float; w_q [N, K] int8 (nn.Linear's layout); w_scale [N]
    and bias [N] fp32 or bf16. Returns y [..., N] in out_dtype (fp32 by
    default, as JAX's; the model's projections pass x's dtype); with
    parts, (y, x_q [M, K] int8, acc [M, N] int32) over the
    M = prod(x.shape[:-1]) rows. The int32 product is `int8_mm`'s."""
    global CALLS
    CALLS += 1
    return _matmul(x, w_q, w_scale, bias, out_dtype, parts, int8_mm)


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.float32,
                          parts: bool = False):
    """Plain version of `int8_matmul` on any device, its int32 product by
    `int8_mm_reference`; same arguments and results."""
    return _matmul(x, w_q, w_scale, bias, out_dtype, parts,
                   int8_mm_reference)


def quantize_state_dict_int8(sd: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A trained fp32 state dict -> the `quant_int8=True` layout: each
    transformer projection under `encoder.layers.{l}` (self_attn's
    q/k/v/out_proj, fc1, fc2) has its `weight` replaced by `weight_q` int8
    [out, in] and `scale` fp32 [out]; its bias becomes fp32. Everything
    else, the backends' own fc1 / fc2 included, is left as it is."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if _PROJ.match(key):
            stem = key[: -len("weight")]
            out[stem + "weight_q"], out[stem + "scale"] = \
                quantize_weight_int8(value)
        elif key.endswith(".bias") and _PROJ.match(key[:-4] + "weight"):
            out[key] = value.detach().float()
        else:
            out[key] = value
    return out
