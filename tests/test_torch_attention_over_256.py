"""The port's flash attention at head dims above 256 against the JAX
package, which takes any head dim.

On a card bf16 at a multiple of 8 takes the panel kernels
(csrc/flash_attn_panel.cu, the "wgmma" route) and everything else the
generic kernels' panels (csrc/flash_attn_generic.cu); on the CPU the same
wrappers run the plain versions, which these tests hold against the Pallas
kernels in interpret mode (the JAX package's own tests run them so):

- the op's forward and gradients at D 260, 264, 320 and 512 in fp32 and
  bf16, on the whole-T route (T 201) and the blocked one (T 600): fp32 at
  the JAX suite's tolerances (tests/test_attention.py: forward atol 2e-5,
  3e-5 blocked; gradients atol 5e-4 / rtol 1e-3), bf16 within the bounds
  tests/test_torch_attention.py gives its bf16 cases (forward 2^-7 of the
  largest |out|, gradients 2^-6 of each one's largest |value|);
- a 2-layer XLSR + AASIST model at D 264 (bf16: the wgmma route) and D 260
  (fp32: the generic route), its Flax variables fabricated from
  jax.eval_shape and loaded through the bridge (`state_dict_from_flax`):
  features, the model's outputs and the encoder's gradients. fp32 at
  tests/test_torch_coverage.py's and tests/test_torch_aasist.py's
  tolerances (the gradients' absolute one taken of each gradient's
  largest |value|: sum(features^2) at width 520 gives gradients of order
  30, where 1e-4 absolute is fp32's summation order); bf16 features and
  gradients within the JAX suite's own bf16 gate
  (tests/test_fast_numerics.py: 2 % relative L2, gradient cosine 0.99),
  and the port's AASIST on the JAX encoder's features at
  tests/test_torch_aasist.py's tolerances (the tiny AASIST, random
  weights, turns the 1 % feature difference of two bf16 encoders into
  10 % of its outputs, so those are held on the same features);
- the route tables, and the wrappers reaching the panel entry points on a
  CUDA tensor (the device test patched, a recording library: this host has
  no card).

The kernels themselves are held against the same plain versions on the card
by chip_smoke.py's phase 24. Torch is pinned to one thread.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu.ops import attention as jax_attention
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.models import (
    AModel, state_dict_from_flax, xlsr_state_dict_from_flax)
from occm_tpu_torch.ops import attention
from test_torch_models import fabricated, perturbed

OVER_256_DIMS = (260, 264, 320, 512)
BF16_OUT_RTOL_OF_MAX = 2.0 ** -7
BF16_GRAD_RTOL_OF_MAX = 2.0 ** -6
CUT = 3200  # the tiny conv stack: 159 frames


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * 0.5
            for _ in range(3)]


# ------------------------------------------------------------------ the op

@pytest.mark.parametrize("T, B, H", [(201, 2, 2), (600, 1, 2)],
                         ids=["whole_T", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", OVER_256_DIMS)
def test_flash_attention_over_256_matches_pallas_kernels(head_dim, dtype, T,
                                                         B, H):
    """Forward and gradients of the port's flash attention against
    jax.vjp of the Pallas kernels in interpret mode."""
    q, k, v = _qkv((B, T, H, head_dim), seed=70 + head_dim)
    g = np.random.default_rng(head_dim + T).normal(
        size=(B, T, H, head_dim)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want, vjp = jax.vjp(
        lambda a, b, c: jax_attention.flash_attention(a, b, c,
                                                      interpret=True),
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g).astype(jdt))

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and out.shape == (B, T, H, head_dim)

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))

    got = [out.detach().float().numpy()] + [x.float().numpy() for x in grads]
    ref = [f32(want)] + [f32(x) for x in want_grads]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        if dtype == "float32":
            if name == "out":
                atol = 2e-5 if T <= 512 else 3e-5
                np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3,
                                           err_msg=name)
        else:
            bound = (BF16_OUT_RTOL_OF_MAX if name == "out"
                     else BF16_GRAD_RTOL_OF_MAX) * np.abs(b).max()
            err = np.abs(a - b).max()
            assert err <= bound, f"{name}: {err} > {bound}"


# --------------------------------------------------------------- the model

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5        # tests/test_torch_coverage.py's
OUT_RTOL, OUT_ATOL = 1e-4, 3e-5        # tests/test_torch_aasist.py's
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4      # tests/test_torch_coverage.py's
BF16_REL_L2, BF16_COSINE = 0.02, 0.99  # tests/test_fast_numerics.py's


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("head_dim, dtype, route", [
    (264, "bfloat16", "wgmma"), (260, "float32", "generic")],
    ids=["d264_bf16_wgmma", "d260_fp32_generic"])
def test_amodel_over_256_matches_jax(head_dim, dtype, route):
    """XLSR (2 layers, 2 heads of `head_dim`, attention_impl="flash",
    the plain FFN: the Pallas FFN wants D % 128 == 0) + the tiny AASIST,
    in eval mode: the encoder's features, the model's embedding and
    logits, and the gradient of sum(features^2) in every encoder
    parameter, against Flax with the Pallas attention kernels in
    interpret mode."""
    width = 2 * head_dim
    fields = dict(encoder_layers=2, encoder_embed_dim=width,
                  encoder_ffn_dim=512, encoder_heads=2, out_dim=width,
                  attention_impl="flash", ffn_impl="xla", dtype=dtype)
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    assert attention.cuda_route(getattr(torch, dtype), head_dim) == route
    x = (np.random.default_rng(head_dim).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)
    jmodel = JAModel(JAASISTConfig.tiny(), xlsr_cfg=jcfg)
    variables = perturbed(fabricated(jmodel, x, train=False), head_dim)
    jencoder = JXLSREncoder(jcfg)

    def loss(params):
        y = jencoder.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(jnp.square(y.astype(jnp.float32))), y

    (_, want_y), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"]["ssl_model"])
    want_emb, want_logits = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                       jnp.asarray(x))
    # jmodel's outputs are AASIST's on want_y, the features it computes

    model = AModel(AASISTConfig.tiny(), cfg).eval()
    model.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    counters = ("LAUNCHES", "OTHER_D_LAUNCHES", "PANEL_LAUNCHES",
                "GENERIC_LAUNCHES", "PANEL_BWD_DQ_LAUNCHES",
                "GENERIC_BWD_DQ_LAUNCHES")
    before = [getattr(attention, n) for n in counters]
    y = model.ssl_model(torch.from_numpy(x))
    (y.float() ** 2).sum().backward()
    with torch.no_grad():
        emb, logits = model(torch.from_numpy(x))
    # the CPU runs the plain versions: no kernel launched
    assert [getattr(attention, n) for n in counters] == before
    assert y.shape == (2, 159, width)
    assert emb.shape == want_emb.shape and logits.shape == want_logits.shape

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    got_y = y.detach().float().numpy()
    want = xlsr_state_dict_from_flax(jgrads, cfg)
    # both train the positional conv's folded kernel: the bridge's
    # weight_v of a gradient tree is that kernel's gradient
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    got = {n: p.grad for n, p in model.ssl_model.model.named_parameters()}
    assert want.keys() == got.keys()
    if dtype == "float32":
        np.testing.assert_allclose(got_y, f32(want_y), rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
        np.testing.assert_allclose(emb.numpy(), f32(want_emb),
                                   rtol=OUT_RTOL, atol=OUT_ATOL)
        np.testing.assert_allclose(logits.numpy(), f32(want_logits),
                                   rtol=OUT_RTOL, atol=OUT_ATOL)
        for n, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(
                got[n].numpy(), w, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * max(1.0, float(np.abs(w).max())), err_msg=n)
        return
    rel = _rel_l2(got_y, f32(want_y))
    assert rel < BF16_REL_L2, f"feature relative L2 {rel}"
    with torch.no_grad():
        emb_j, logits_j = model.backend(
            torch.from_numpy(f32(want_y).copy()).to(y.dtype), None)
    np.testing.assert_allclose(emb_j.float().numpy(), f32(want_emb),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(logits_j.float().numpy(), f32(want_logits),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    a = np.concatenate([got[n].float().numpy().ravel() for n in sorted(want)])
    b = np.concatenate([want[n].float().numpy().ravel()
                        for n in sorted(want)])
    cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cosine > BF16_COSINE, cosine


# -------------------------------------------------------------- the routes

@pytest.mark.parametrize("dtype, head_dim, route", [
    *((torch.bfloat16, d, "wgmma") for d in (264, 320, 512, 520, 1024,
                                              4096)),
    *((torch.bfloat16, d, "generic") for d in (257, 260, 262, 1020)),
    *((torch.float32, d, "generic") for d in (257, 260, 264, 512, 1024)),
    (torch.float16, 512, None), (torch.bfloat16, 0, None)])
def test_routes_above_256(dtype, head_dim, route):
    """Above head dim 256 (WGMMA_MAX_SINGLE_PANEL) bf16 at a multiple of 8
    takes the wgmma route's panel kernels, the other bf16 and every fp32
    head dim the generic kernels' panels, in the forward and the backward
    alike; fp16 and D 0 have no kernel."""
    assert attention.cuda_route(dtype, head_dim) == route
    assert attention.cuda_bwd_route(dtype, head_dim) == route
    assert attention.cuda_kernel_takes(dtype, head_dim) is (route is not None)
    if dtype == torch.bfloat16:
        assert (head_dim in attention.WGMMA_HEAD_DIMS) is (route == "wgmma")


def test_head_dim_tables_have_no_end():
    """The tables the routes read take every head dim from their first
    up: the wgmma route's multiples of 8 (the panel kernels' above 256),
    the generic kernels' from 1."""
    assert all(d in attention.WGMMA_HEAD_DIMS for d in (8, 256, 264, 8192))
    assert not any(d in attention.WGMMA_HEAD_DIMS for d in (0, 4, 260, 1020))
    assert attention.WGMMA_MAX_SINGLE_PANEL == 256
    assert all(d in attention.GENERIC_HEAD_DIMS for d in (1, 256, 257, 9999))
    assert 0 not in attention.GENERIC_HEAD_DIMS


# ----------------------------------------------------- a recording library

def _recording(monkeypatch):
    """Every tensor reports cuda:0, the plain versions raise if reached,
    and the library records each entry point's arguments (and returns 0):
    a wrapper that routes a CUDA tensor to a kernel reaches the library,
    never the plain version."""
    from occm_tpu_torch.ops import _build

    calls = {}

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls[name] = args
                return 0
            return launch

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    cpu_empty = torch.empty
    monkeypatch.setattr(attention, "flash_attention_reference", plain)
    monkeypatch.setattr(attention, "flash_attention_bwd_reference", plain)
    monkeypatch.setattr(_build, "load", Lib)
    monkeypatch.setattr(_build, "raw_stream", lambda device: 7)
    monkeypatch.setattr(_build, "on_device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        cpu_empty(*a, **kw))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    return calls


@pytest.mark.parametrize("head_dim", [264, 512, 1024])
def test_bf16_wrappers_reach_the_panel_kernels(monkeypatch, head_dim):
    """bf16 at D 264, 512 and 1024 on a CUDA tensor: the forward launches
    `occm_flash_attn_panel_fwd` and the backward `occm_flash_attn_panel_
    bwd_dq` then `_dkv`, each with the strided [B, T, H, D] views' pointers
    and (sb, st, sh), the head dim and 1/sqrt(D), and no fold argument or
    scratch tensor (the panel kernels fold the scale into every q panel
    they stream); the launches count on PANEL_* and on nothing else."""
    calls = _recording(monkeypatch)
    B, T, H = 2, 9, 3
    qkv = torch.zeros((B, T, 3, H, head_dim), dtype=torch.bfloat16)
    q, k, v = (x.detach().requires_grad_() for x in qkv.unbind(2))
    views = (T * 3 * H * head_dim, 3 * H * head_dim, head_dim)
    counters = ("LAUNCHES", "OTHER_D_LAUNCHES", "PANEL_LAUNCHES",
                "GENERIC_LAUNCHES", "BWD_DQ_LAUNCHES",
                "OTHER_D_BWD_DQ_LAUNCHES", "PANEL_BWD_DQ_LAUNCHES",
                "PANEL_BWD_DKV_LAUNCHES", "GENERIC_BWD_DQ_LAUNCHES")
    before = {n: getattr(attention, n) for n in counters}
    out = attention.flash_attention(q, k, v)
    (out.float() * 2).sum().backward()
    assert set(calls) == {"occm_flash_attn_panel_fwd",
                          "occm_flash_attn_panel_bwd_dq",
                          "occm_flash_attn_panel_bwd_dkv"}
    fwd = calls["occm_flash_attn_panel_fwd"]
    assert fwd[:3] == tuple(x.data_ptr() for x in (q, k, v))
    assert fwd[5:10] == (B, H, T, T, head_dim)
    assert fwd[10:19] == views * 3
    assert fwd[19:] == (1.0 / math.sqrt(head_dim), 7)
    dq, dkv = (calls["occm_flash_attn_panel_bwd_dq"],
               calls["occm_flash_attn_panel_bwd_dkv"])
    assert dq[:3] == dkv[:3] == fwd[:3]
    assert dq[8:13] == dkv[8:13] == (B, H, T, T, head_dim)
    assert dq[13:22] == dkv[13:22] == views * 3
    assert dq[-2:] == dkv[-2:] == fwd[-2:]
    assert dq[4] == dkv[3] and dq[6] == dkv[5]  # dO and delta handed on
    after = {n: getattr(attention, n) - b for n, b in before.items()}
    assert after == {n: int(n.startswith("PANEL_")) for n in counters}
    for x in (q, k, v):
        assert x.grad.shape == (B, T, H, head_dim) and x.grad.is_contiguous()


@pytest.mark.parametrize("dtype, head_dim", [
    (torch.float32, 264), (torch.float32, 512), (torch.bfloat16, 260)])
def test_generic_wrappers_take_head_dims_above_256(monkeypatch, dtype,
                                                   head_dim):
    """fp32 (and bf16 off the multiples of 8) above 256: the generic entry
    points get the head dim as it is (their kernels split the output into
    panels of 256 columns) and count on GENERIC_*."""
    calls = _recording(monkeypatch)
    B, T, H = 2, 9, 3
    q, k, v = (torch.zeros((B, T, H, head_dim), dtype=dtype)
               .requires_grad_() for _ in range(3))
    before = (attention.GENERIC_LAUNCHES, attention.GENERIC_BWD_DQ_LAUNCHES,
              attention.GENERIC_BWD_DKV_LAUNCHES, attention.PANEL_LAUNCHES)
    out = attention.flash_attention(q, k, v)
    out.float().sum().backward()
    assert set(calls) == {"occm_flash_attn_generic_fwd",
                          "occm_flash_attn_generic_bwd_dq",
                          "occm_flash_attn_generic_bwd_dkv"}
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert calls["occm_flash_attn_generic_fwd"][5:11] == (
        code, B, H, T, T, head_dim)
    for name in ("occm_flash_attn_generic_bwd_dq",
                 "occm_flash_attn_generic_bwd_dkv"):
        assert calls[name][8:14] == (code, B, H, T, T, head_dim)
    assert (attention.GENERIC_LAUNCHES, attention.GENERIC_BWD_DQ_LAUNCHES,
            attention.GENERIC_BWD_DKV_LAUNCHES,
            attention.PANEL_LAUNCHES) == tuple(
                b + n for b, n in zip(before, (1, 1, 1, 0)))
