"""The port's XLSR encoder in fp32 through both kernels' routes that the
wgmma kernels do not take: attention_impl="flash" (fp32, at head dims 64
and 16: the generic CUDA kernels on a card) and ffn_impl="pallas" (the fp32
fused FFN kernel on a card), against the Flax encoder with the same fields.

Two layers, embed 256, FFN 512, 4 heads (D 64) and 16 heads (D 16): the
JAX package then runs its Pallas FFN kernel (D % 128 == 0, F % 512 == 0)
and its Pallas attention kernels, both in interpret mode; the port runs
their plain versions, as on every CPU tensor. Flax variables are
fabricated on the host and perturbed (tests/test_torch_models.py) and carry
over through `xlsr_state_dict_from_flax`. Tolerances of
tests/test_torch_layouts.py (the JAX suite's for these layers): features at
rtol 1e-4 / atol 1e-5, every parameter's gradient of sum(features^2) at
rtol 1e-3 / atol 1e-4. Torch is pinned to one thread.
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
    assert attention.cuda_route(torch.float32, 256 // heads) == "generic"
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
    before = (ffn.LAUNCHES, ffn.F32_LAUNCHES, attention.GENERIC_LAUNCHES)
    y = model(torch.from_numpy(x))
    (y ** 2).sum().backward()
    # the CPU runs the plain versions: no kernel launched
    assert (ffn.LAUNCHES, ffn.F32_LAUNCHES,
            attention.GENERIC_LAUNCHES) == before
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
