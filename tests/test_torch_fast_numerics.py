"""The bf16 parameter mirror and `--fast_numerics` in the port, against the
JAX package on the CPU at tiny dims.

The mirror (`XLSRConfig.bf16_param_mirror`) casts every fp32 parameter of
the transformer stack to bf16 once per forward, LayerNorm scales and
biases included, as JAX's `nn.map_variables` does. Its parameters here
are perturbed off the bf16 grid, as in any trained checkpoint, so a
mirror that rounds too little (or too much) shows.

Tolerances:
- the mirror in fp32 compute: forward atol 1e-5; gradients atol 5e-4 /
  rtol 1e-3 (the JAX suite's, tests/test_attention.py), except that a
  stack parameter's gradient is a bf16 value in both packages (the
  cotangent of a bf16 leaf), which two sums that agree to 1e-6 round to
  the same value or to neighbours one bf16 ulp apart: at most 2^-7 of
  the value;
- bf16 compute (the fast-numerics config): the bounds of the JAX suite's
  own fast-numerics gate (tests/test_fast_numerics.py), features within
  2 % relative L2 and gradient cosine above 0.99; bf16 rounds every
  activation, and two implementations flip different roundings (measured
  here: 1.2 % and 0.99999, as far apart as JAX's bf16 run is from its
  fp32 one).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.models import AModel as JAModel
from occm_tpu.models.convert_backend import export_amodel_state_dict
from occm_tpu.models.xlsr import XLSREncoder as JXLSREncoder
from occm_tpu.serve import ScoringService as JScoringService
from occm_tpu.serve import make_score_fn as jmake_score_fn
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.models import (
    AModel, XLSREncoder, load_reference_state_dict, xlsr_state_dict_from_flax)
from occm_tpu_torch.serve import ScoringService, make_score_fn
from test_torch_models import fabricated, perturbed
from test_torch_train import _cli_args, write_fixture

CUT = 3200
#: the fields --fast_numerics sets in the JAX package's CLIs
#: (occm_tpu/cli/oc_training.py:255-260; the scoring CLIs leave remat out)
FAST = dict(norm_dtype="bfloat16", gelu_approximate=True,
            conv_gelu_approximate=True, bf16_param_mirror=True)
TRAIN_FAST = dict(FAST, remat_policy="attn_out_inner")
STACK = "encoder.layers."


def _wave(seed=5, batch=2, n=CUT):
    return (np.random.default_rng(seed).normal(size=(batch, n))
            * 0.1).astype(np.float32)


def _grads(jcfg, cfg, x, seed=1):
    """(port, JAX) features and gradients of the sum of squared features,
    from the same perturbed parameters."""
    variables = perturbed(fabricated(JXLSREncoder(jcfg), x), seed)
    jmodel = JXLSREncoder(jcfg)

    def loss(params):
        y = jmodel.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(jnp.square(y.astype(jnp.float32))), y

    (_, want_y), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    want = {k: v.numpy() for k, v in
            xlsr_state_dict_from_flax(jgrads, cfg).items()}
    # both train the positional conv's folded kernel
    want["encoder.pos_conv.0.weight"] = want.pop("encoder.pos_conv.0.weight_v")
    want.pop("encoder.pos_conv.0.weight_g")
    model = XLSREncoder(cfg).train()
    model.load_state_dict(xlsr_state_dict_from_flax(variables["params"], cfg),
                          strict=True)
    y = model(torch.from_numpy(x))
    (y ** 2).sum().backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    return (y.detach().numpy(), got), (np.asarray(want_y, np.float32), want)


def test_mirror_rounds_the_stack_as_jax_does():
    """fp32 compute and norms with the mirror: JAX rounds every stack
    parameter to bf16 (its LayerNorms' too) and nothing else; so must the
    port, forward and gradients."""
    jcfg = dataclasses.replace(JXLSRConfig.tiny(), bf16_param_mirror=True)
    cfg = dataclasses.replace(XLSRConfig.tiny(), bf16_param_mirror=True)
    (y, got), (want_y, want) = _grads(jcfg, cfg, _wave())
    np.testing.assert_allclose(y, want_y, atol=1e-5, rtol=0)
    for n, w in want.items():
        ulp = 2.0 ** -7 if n.startswith(STACK) else 1e-3
        np.testing.assert_allclose(got[n], w, atol=5e-4, rtol=ulp, err_msg=n)
        if n.startswith(STACK):  # a bf16 value, as JAX's cotangent
            assert np.array_equal(got[n], got[n].astype(jnp.bfloat16)
                                  .astype(np.float32)), n


def _fast_close(got_y, want_y, got, want):
    rel = np.linalg.norm(got_y - want_y) / np.linalg.norm(want_y)
    assert rel < 0.02, f"feature relative L2 {rel}"
    vec = lambda g: np.concatenate([g[k].ravel() for k in sorted(want)])
    a, b = vec(got), vec(want)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.99, f"gradient cosine {cos}"


def test_fast_numerics_encoder_matches_jax():
    """The training CLI's fast config on a bf16 encoder with remat on (so
    attn_out_inner acts): forward and every gradient against JAX."""
    fields = dict(TRAIN_FAST, dtype="bfloat16", remat=True)
    (y, got), (want_y, want) = _grads(
        dataclasses.replace(JXLSRConfig.tiny(), **fields),
        dataclasses.replace(XLSRConfig.tiny(), **fields), _wave())
    _fast_close(y, want_y, got, want)


def test_oc_training_fast_numerics(tmp_path, monkeypatch):
    """`oc_training --fast_numerics` builds the JAX CLI's five fields and
    takes finite steps (tiny: remat off, as in JAX)."""
    from occm_tpu_torch.cli import oc_training

    protocol, train_dir, voc_dir = write_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    losses = []
    state = oc_training.main(
        _cli_args(protocol, train_dir, voc_dir, str(tmp_path / "ck"),
                  "--fast_numerics"),
        on_step=lambda step, m: losses.append(float(m["loss"])))
    cfg = state.model.ssl_model.model.cfg
    assert {k: getattr(cfg, k) for k in TRAIN_FAST} == TRAIN_FAST
    assert cfg.attention_impl == "xla" and len(losses) == state.step == 6
    assert all(np.isfinite(losses))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(JAX's fast-numerics score fn, the .pt the port's CLIs load): a JAX
    AModel's perturbed variables (LayerNorms off the bf16 grid), exported
    in the reference naming."""
    jmodel = JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny())
    variables = perturbed(fabricated(jmodel, _wave(batch=2)), seed=3)
    path = tmp_path_factory.mktemp("fast") / "amodel.pt"
    exported = export_amodel_state_dict(variables, JXLSRConfig.tiny())
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
               path)
    jfast = JAModel(JAASISTConfig(), xlsr_cfg=dataclasses.replace(
        JXLSRConfig.tiny(), **FAST))
    return jmake_score_fn(jfast, variables["params"],
                          variables["batch_stats"]), path


def _hand_mirrored(path):
    """The port's model with the mirror off, from the checkpoint with the
    stack's parameters rounded to bf16 by hand: the mirror's definition."""
    state = load_reference_state_dict(str(path))
    state = {k: (v.to(torch.bfloat16).float()
                 if k.startswith("ssl_model.model." + STACK) else v)
             for k, v in state.items()}
    model = AModel(AASISTConfig(), dataclasses.replace(
        XLSRConfig.tiny(), **dict(FAST, bf16_param_mirror=False)))
    model.load_state_dict(state, strict=True)
    return model


def test_oc_server_fast_numerics_scores_as_jax(checkpoint, tmp_path):
    """`oc_server --fast_numerics` serves JAX's fast-numerics scores, and
    exactly the scores of the stack rounded by hand."""
    from occm_tpu_torch.cli import oc_server

    jfn, path = checkpoint
    reference = np.random.default_rng(4).normal(size=160).astype(np.float32)
    np.save(tmp_path / "reference_embedding.npy", reference)
    np.save(tmp_path / "threshold.npy", np.float32(12.0))
    started = threading.Event()
    started.stop = threading.Event()
    t = threading.Thread(target=oc_server.main, args=([
        "--pretrained-sslaasist", str(path), "--artifacts_dir",
        str(tmp_path), "--host", "127.0.0.1", "--port", "0", "--xlsr_tiny",
        "--fast_numerics", "--batch_size", "2", "--buckets", str(CUT),
        "--device", "cpu", "--no_warmup"], started), daemon=True)
    t.start()
    assert started.wait(timeout=120), "server failed to start"
    waves = [w for w in _wave(seed=6, n=2900)]
    try:
        got, _ = started.service.score(waves)
    finally:
        started.stop.set()
        t.join(timeout=30)
    jsvc = JScoringService(jfn, reference, threshold=12.0, buckets=(CUT,),
                           batch=2)
    want, _ = jsvc.score(waves)
    np.testing.assert_allclose(got, want, rtol=0.02)
    hand = ScoringService(score_fn=make_score_fn(_hand_mirrored(path)),
                          reference_embedding=reference, threshold=12.0,
                          buckets=(CUT,), batch=2, device="cpu")
    np.testing.assert_array_equal(got, hand.score(waves)[0])


def test_embed_fast_numerics_matches_jax(checkpoint, tmp_path):
    """`embed --fast_numerics` writes JAX's fast-numerics embeddings and
    logits, and exactly those of the stack rounded by hand."""
    from occm_tpu_torch.cli import embed
    from occm_tpu_torch.io.wav import read_wav, write_wav

    jfn, path = checkpoint
    waves = _wave(seed=8, n=CUT)
    utts = []
    for i, w in enumerate(waves):
        utts.append(f"LA_E_{i}")
        write_wav(str(tmp_path / f"{utts[-1]}.wav"), w, 16000)
    (tmp_path / "eval.txt").write_text("\n".join(utts) + "\n")
    out = tmp_path / "emb.npz"
    embed.main(["--protocol_file", str(tmp_path / "eval.txt"), "--eval",
                "--dataset_dir", str(tmp_path), "--pretrained-sslaasist",
                str(path), "--xlsr_tiny", "--fast_numerics", "--device",
                "cpu", "--bucket_step", str(CUT), "--batch_size", "2",
                "--out", str(out)])
    got = np.load(out)
    # the waves as the files hold them (16-bit PCM)
    x = np.stack([read_wav(str(tmp_path / f"{u}.wav"))[0] for u in utts])
    with torch.no_grad():
        hand = _hand_mirrored(path).eval()(torch.from_numpy(x))
    emb, logits = [np.asarray(a) for a in jfn(jnp.asarray(x))]
    for g, h, w in ((got["embeddings"], hand[0], emb),
                    (got["logits"], hand[1], logits)):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 0.02, rel
        np.testing.assert_array_equal(g, h.numpy())
