"""attention_impl="auto" follows the threshold of the CUDA kernels that
take the model, and never picks a flash kernel that cannot take it.

The wgmma kernels take bf16 with head dim 64 (flash from
AUTO_FLASH_MIN_SAMPLES up) and, in their other instances, bf16 at every
head dim that is a multiple of 8 up to 256 (XLS-R 1B's 80, XLS-R 300M's
widths with 4 heads of 256; flash from the measured
AUTO_WGMMA_OTHER_D_MIN_SAMPLES up, or never where it is None);
the 3xTF32 forward takes fp32 at the head dims of its table
(`XLSRConfig.tiny()` is fp32 with D = 16, `XLSRConfig(dtype="float32")`
D = 64), and auto picks it from the measured AUTO_TF32_MIN_SAMPLES up; the
generic kernels take fp32 at the other head dims, and bf16 at any other
head dim, and auto picks them from the measured
AUTO_GENERIC_MIN_SAMPLES up, or never where it is None; a model with
D > 256, which the panel kernels (bf16 at a multiple of 8) or the generic
kernels' panels take, gets "xla" in every bucket until its own threshold
AUTO_OVER_256_MIN_SAMPLES is measured. This holds at both
places that know the model: the scorers' and the server's
`make_embed_fn_factory`, and `oc_training`. On the CPU, where "flash" runs
the plain version at any dtype, auto resolves as before, and a pinned impl
always passes through. The device is monkeypatched: no card is needed, and
no tensor is made on it.
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
BF16_D12 = dataclasses.replace(TINY, dtype="bfloat16", encoder_embed_dim=48)
XLSR_1B = dataclasses.replace(FULL, encoder_layers=48, encoder_embed_dim=1280,
                              encoder_ffn_dim=5120, out_dim=1280)  # D = 80
XLSR_300M_D256 = dataclasses.replace(FULL, encoder_heads=4)  # D = 256
WIDE_HEAD = dataclasses.replace(TINY, encoder_embed_dim=1040,
                                encoder_heads=4)  # D = 260 > 256


def _auto(floor, seconds) -> str:
    """What auto picks for a bucket of `seconds` under a measured
    threshold, or "xla" in every bucket where it is None."""
    return "flash" if floor is not None and seconds * SR >= floor else "xla"


def _generic_auto(seconds) -> str:
    """What auto picks for a bucket of `seconds` on the generic route."""
    return _auto(impl_select.AUTO_GENERIC_MIN_SAMPLES, seconds)


def _tf32_auto(seconds) -> str:
    """What auto picks for a bucket of `seconds` on the 3xTF32 route."""
    return _auto(impl_select.AUTO_TF32_MIN_SAMPLES, seconds)


def _other_d_auto(seconds) -> str:
    """What auto picks on the wgmma route at a head dim other than 64."""
    return _auto(impl_select.AUTO_WGMMA_OTHER_D_MIN_SAMPLES, seconds)


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


@pytest.mark.parametrize("cfg", [TINY, FP32_D64, BF16_D16, WIDE_HEAD],
                         ids=["tiny_fp32_d16", "fp32_d64", "bf16_d16",
                              "fp32_d260"])
@pytest.mark.parametrize("seconds", [1, 6, 12])
def test_auto_picks_xla_for_a_cuda_model_the_kernel_cannot_take(
        monkeypatch, cfg, seconds):
    """The models the wgmma kernels' D 64 instance does not take: the
    3xTF32 route's fp32 models (D 16 and 64) follow its measured
    threshold, bf16 at the wgmma route's other head dims (16 here) theirs;
    a head dim above 256 gets "xla" in every bucket
    (AUTO_OVER_256_MIN_SAMPLES is None until measured)."""
    want = {WIDE_HEAD: "xla",
            BF16_D16: _other_d_auto(seconds)}.get(cfg, _tf32_auto(seconds))
    assert _factory_impl(monkeypatch, cfg, "cuda", seconds=seconds) == want


@pytest.mark.parametrize("cfg, want", [(XLSR_1B, "other_d"),
                                       (XLSR_300M_D256, "other_d"),
                                       (BF16_D12, "generic")],
                         ids=["xlsr_1b_d80", "xlsr_300m_d256", "bf16_d12"])
@pytest.mark.parametrize("seconds", [1, 2, 6, 12])
def test_auto_follows_the_route_of_a_bf16_head_dim(monkeypatch, cfg, want,
                                                   seconds):
    """bf16 at head dim 80 (XLS-R 1B) and 256 (XLS-R 300M's widths with 4
    heads) takes the wgmma route's instances at head dims other than 64
    and their measured threshold; bf16 at head dim 12, not a multiple of
    8, stays on the generic route and its threshold."""
    expect = (_other_d_auto(seconds) if want == "other_d"
              else _generic_auto(seconds))
    assert _factory_impl(monkeypatch, cfg, "cuda",
                         seconds=seconds) == expect


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
    """A pinned "flash" passes through on every model: the generic
    kernels run the tiny one, and their panels the one with head dim 260
    (a selection of the model's path, not a fallback on failure)."""
    assert _factory_impl(monkeypatch, TINY, "cuda", pinned) == pinned
    assert _factory_impl(monkeypatch, WIDE_HEAD, "cuda", pinned) == pinned


@pytest.mark.parametrize("cfg, device, want", [
    (TINY, "cuda", True), (FP32_D64, "cuda", True),
    (BF16_D16, "cuda", True), (FULL, "cuda", True), (TINY, "cpu", True),
    (FULL, "cpu", True), (WIDE_HEAD, "cuda", True),
    (WIDE_HEAD, "cpu", True)])
def test_flash_kernel_takes(cfg, device, want):
    """A CUDA route takes every model, D > 256 included (fp32 D 260: the
    generic kernels' panels); the CPU's plain version takes any. Auto's
    threshold follows the route (and, on the wgmma route, whether the head
    dim is 64); above head dim 256 it is AUTO_OVER_256_MIN_SAMPLES, None
    until measured, so auto keeps "xla" there."""
    assert impl_select.flash_kernel_takes(cfg, device) is want
    floor = impl_select.auto_flash_min_samples(cfg, device)
    if not want:
        assert floor is None
    elif cfg is WIDE_HEAD and device == "cuda":
        assert floor is impl_select.AUTO_OVER_256_MIN_SAMPLES is None
    elif device == "cpu" or cfg is FULL:
        assert floor == impl_select.AUTO_FLASH_MIN_SAMPLES
    elif cfg is BF16_D16:
        assert floor == impl_select.AUTO_WGMMA_OTHER_D_MIN_SAMPLES
    else:
        assert floor == impl_select.AUTO_TF32_MIN_SAMPLES


@pytest.mark.parametrize("tiny, device, cut, want", [
    (True, "cuda", 96000, "3xtf32"),  # tiny fp32 D = 16: the 3xTF32 route
    (True, "cpu", 96000, "flash"),
    (False, "cuda", 96000, "flash"),
    (False, "cuda", 8000, "xla"),
])
def test_training_cli_resolves_auto_for_its_model_and_device(tiny, device,
                                                             cut, want):
    if want == "3xtf32":
        want = _tf32_auto(cut / SR)
    argv = ["--train_protocol_file", "p", "--train_dataset_dir", "d",
            "--vocoded_dir", "v", "--cut", str(cut)]
    args = oc_training.build_parser().parse_args(
        argv + (["--xlsr_tiny"] if tiny else []))
    cfg = oc_training.xlsr_config(args, cut, torch.device(device))
    assert cfg.attention_impl == want
    assert cfg.dtype == ("float32" if tiny else "bfloat16")
