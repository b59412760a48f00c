"""The port's XLSR encoder in fp32 through both kernels' routes that the
wgmma kernels do not take: attention_impl="flash" (fp32, at head dims 64
and 16: the generic CUDA kernels on a card) and ffn_impl="pallas" (the fp32
fused FFN kernel on a card), against the Flax encoder with the same fields;
and in bf16 at head dim 80 (the wgmma kernels' instance for round_up(D, 16)
= 80 on a card, XLS-R 1B's head dim) with flash attention.

Two layers, embed 256, FFN 512, 4 heads (D 64) and 16 heads (D 16): the
JAX package then runs its Pallas FFN kernel (D % 128 == 0, F % 512 == 0)
and its Pallas attention kernels, both in interpret mode; the port runs
their plain versions, as on every CPU tensor. Flax variables are
fabricated on the host and perturbed (tests/test_torch_models.py) and carry
over through `xlsr_state_dict_from_flax`. Tolerances of
tests/test_torch_layouts.py (the JAX suite's for these layers): features at
rtol 1e-4 / atol 1e-5, every parameter's gradient of sum(features^2) at
rtol 1e-3 / atol 1e-4. In bf16 the JAX suite's own bf16 gate
(tests/test_fast_numerics.py): features within 2 % relative L2, the
gradient's cosine above 0.99 (bf16 rounds every activation, and the two
packages round at different places: the whole-T Pallas kernel normalises
P before its bf16 cast, the port after; measured here: 1.22 % and
0.99999). Torch is pinned to one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu_torch.config import XLSRConfig
from occm_tpu_torch.models import XLSREncoder, xlsr_state_dict_from_flax
from occm_tpu_torch.ops import attention, ffn
from test_torch_models import fabricated, perturbed

CUT = 3200  # tiny conv stack: 159 frames
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
WIDTHS = dict(encoder_layers=2, encoder_embed_dim=256, encoder_ffn_dim=512,
              attention_impl="flash", ffn_impl="pallas", dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("heads", [4, 16], ids=["d64", "d16"])
def test_fp32_encoder_with_flash_and_pallas_ffn_matches_flax(heads):
    fields = dict(WIDTHS, encoder_heads=heads)
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    assert cfg.encoder_embed_dim // heads == {4: 64, 16: 16}[heads]
    assert attention.cuda_route(torch.float32, 256 // heads) == "3xtf32"
    x = (np.random.default_rng(heads).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)
    variables = perturbed(fabricated(JXLSREncoder(jcfg), x), heads)
    jmodel = JXLSREncoder(jcfg)

    def loss(params):
        y = jmodel.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(y ** 2), y

    (_, want_y), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    model = XLSREncoder(cfg).eval()
    model.load_state_dict(xlsr_state_dict_from_flax(variables["params"], cfg),
                          strict=True)
    before = (ffn.LAUNCHES, ffn.F32_LAUNCHES, attention.GENERIC_LAUNCHES,
              attention.TF32_FWD_LAUNCHES)
    y = model(torch.from_numpy(x))
    (y ** 2).sum().backward()
    # the CPU runs the plain versions: no kernel launched
    assert (ffn.LAUNCHES, ffn.F32_LAUNCHES, attention.GENERIC_LAUNCHES,
            attention.TF32_FWD_LAUNCHES) == before
    assert y.dtype == torch.float32 and y.shape == (2, 159, 256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    got = {n: p.grad for n, p in model.named_parameters()}
    want = xlsr_state_dict_from_flax(jgrads, cfg)
    # both train the positional conv's folded kernel: the bridge's
    # weight_v of a gradient tree is that kernel's gradient
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    assert want.keys() == got.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)


def test_bf16_encoder_at_head_dim_80_with_flash_matches_flax():
    """bf16, 2 layers, embed 160, 2 heads of 80, attention_impl="flash"
    (FFN xla: the Pallas FFN wants D % 128 == 0): features and the
    gradient of sum(features^2) against Flax with the Pallas attention
    kernels in interpret mode."""
    fields = dict(encoder_layers=2, encoder_embed_dim=160,
                  encoder_ffn_dim=640, encoder_heads=2,
                  attention_impl="flash", ffn_impl="xla", dtype="bfloat16")
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), **fields)
    cfg = dataclasses.replace(XLSRConfig.tiny(), **fields)
    assert attention.cuda_route(torch.bfloat16, 80) == "wgmma"
    x = (np.random.default_rng(80).normal(size=(2, CUT)) * 0.1).astype(
        np.float32)
    variables = perturbed(fabricated(JXLSREncoder(jcfg), x), 80)
    jmodel = JXLSREncoder(jcfg)

    def loss(params):
        y = jmodel.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(jnp.square(y.astype(jnp.float32))), y

    (_, want_y), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model = XLSREncoder(cfg).eval()
    model.load_state_dict(xlsr_state_dict_from_flax(variables["params"], cfg),
                          strict=True)
    before = (attention.LAUNCHES, attention.OTHER_D_LAUNCHES,
              attention.GENERIC_LAUNCHES)
    y = model(torch.from_numpy(x))
    (y.float() ** 2).sum().backward()
    assert (attention.LAUNCHES, attention.OTHER_D_LAUNCHES,
            attention.GENERIC_LAUNCHES) == before
    assert y.shape == (2, 159, 160)
    got_y = y.detach().float().numpy()
    want_y = np.asarray(jnp.asarray(want_y).astype(jnp.float32))
    rel = np.linalg.norm(got_y - want_y) / np.linalg.norm(want_y)
    assert rel < 0.02, f"feature relative L2 {rel}"
    want = xlsr_state_dict_from_flax(jgrads, cfg)
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    got = {n: p.grad for n, p in model.named_parameters()}
    assert want.keys() == got.keys()
    a = np.concatenate([got[n].float().numpy().ravel() for n in sorted(want)])
    b = np.concatenate([want[n].float().numpy().ravel() for n in sorted(want)])
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.99, f"gradient cosine {cos}"
