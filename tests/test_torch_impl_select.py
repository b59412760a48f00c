"""attention_impl="auto" never picks a CUDA kernel that cannot take the
model.

The CUDA flash kernels take bf16 with head dim 64. On a CUDA device, auto
resolves to "xla" for a model in another compute dtype or head dim
(`XLSRConfig.tiny()` is fp32 with D = 16), at both places that know the
model: the scorers' and the server's `make_embed_fn_factory`, and
`oc_training`. On the CPU, where "flash" runs the plain version at any
dtype, auto resolves as before, and a pinned impl always passes through.
The device is monkeypatched: no card is needed, and no tensor is made on
it.
"""

import dataclasses
import types

import pytest
import torch

from occm_tpu_torch.classify import impl_select, scoring
from occm_tpu_torch.cli import oc_training
from occm_tpu_torch.config import XLSRConfig

SR = 16000

TINY = XLSRConfig.tiny()  # fp32, d 64, 4 heads: D = 16
FULL = XLSRConfig()       # bf16, d 1024, 16 heads: D = 64
FP32_D64 = dataclasses.replace(FULL, dtype="float32")
BF16_D16 = dataclasses.replace(TINY, dtype="bfloat16")


def _factory_impl(monkeypatch, cfg, device, base_impl="auto",
                  seconds=6):
    """The impl that make_embed_fn_factory gives a bucket of `seconds` for
    a model of `cfg` whose parameters lie on `device`."""
    monkeypatch.setattr(scoring, "model_device",
                        lambda model: torch.device(device))
    monkeypatch.setattr(scoring, "make_score_fn",
                        lambda model, impl: impl)
    model = types.SimpleNamespace(xlsr_cfg=cfg)
    factory = scoring.make_embed_fn_factory(model, base_impl)
    return factory(seconds * SR)


@pytest.mark.parametrize("cfg", [TINY, FP32_D64, BF16_D16],
                         ids=["tiny_fp32_d16", "fp32_d64", "bf16_d16"])
@pytest.mark.parametrize("seconds", [1, 6, 12])
def test_auto_picks_xla_for_a_cuda_model_the_kernel_cannot_take(
        monkeypatch, cfg, seconds):
    assert _factory_impl(monkeypatch, cfg, "cuda", seconds=seconds) == "xla"


@pytest.mark.parametrize("seconds, want", [(0.5, "xla"), (1, "flash"),
                                           (6, "flash"), (12, "flash")])
def test_auto_picks_flash_for_a_cuda_model_in_bf16_with_head_dim_64(
        monkeypatch, seconds, want):
    """The full-width model keeps its route: flash from the crossover up."""
    assert _factory_impl(monkeypatch, FULL, "cuda", seconds=seconds) == want


@pytest.mark.parametrize("cfg", [TINY, FULL], ids=["tiny", "full"])
def test_auto_on_the_cpu_resolves_as_before(monkeypatch, cfg):
    """On the CPU "flash" is the plain version, which takes any dtype: the
    CPU parity tests keep their route."""
    assert _factory_impl(monkeypatch, cfg, "cpu") == "flash"
    assert impl_select.select_attention_impl(6 * SR) == "flash"


@pytest.mark.parametrize("pinned", ["flash", "xla"])
def test_a_pinned_impl_passes_through_on_cuda(monkeypatch, pinned):
    """A pinned "flash" on a model the kernel cannot take still reaches
    the kernel's wrapper, which raises on the card: a selection of the
    model's path, not a fallback on failure."""
    assert _factory_impl(monkeypatch, TINY, "cuda", pinned) == pinned


@pytest.mark.parametrize("cfg, device, want", [
    (TINY, "cuda", False), (FP32_D64, "cuda", False),
    (BF16_D16, "cuda", False), (FULL, "cuda", True), (TINY, "cpu", True),
    (FULL, "cpu", True)])
def test_flash_kernel_takes(cfg, device, want):
    assert impl_select.flash_kernel_takes(cfg, device) is want


@pytest.mark.parametrize("tiny, device, cut, want", [
    (True, "cuda", 96000, "xla"),    # the fault: tiny fp32 D = 16 on a card
    (True, "cpu", 96000, "flash"),
    (False, "cuda", 96000, "flash"),
    (False, "cuda", 8000, "xla"),
])
def test_training_cli_resolves_auto_for_its_model_and_device(tiny, device,
                                                             cut, want):
    argv = ["--train_protocol_file", "p", "--train_dataset_dir", "d",
            "--vocoded_dir", "v", "--cut", str(cut)]
    args = oc_training.build_parser().parse_args(
        argv + (["--xlsr_tiny"] if tiny else []))
    cfg = oc_training.xlsr_config(args, cut, torch.device(device))
    assert cfg.attention_impl == want
    assert cfg.dtype == ("float32" if tiny else "bfloat16")
