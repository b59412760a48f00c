"""The port's offline scoring (`occm_tpu_torch.classify.scoring`) against
the JAX `BucketedEmbedder` / `OneClassScorer` on the same waves and weights.

A tiny AModel (full AASIST backend, tiny XLSR) is initialised by Flax, every
parameter and BatchNorm statistic perturbed, and carried into the port with
`state_dict_from_flax`. Both sides run fp32 at tiny width and differ only
in summation order: the threshold, distances and logits agree within 1e-4
relative, the tolerance of tests/test_torch_serve.py; embeddings element by
element within 1e-4 of their largest magnitude (`_close`), since an element
near zero carries the rounding of the whole vector.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from occm_tpu.classify import BucketedEmbedder as JBucketedEmbedder
from occm_tpu.classify import OneClassScorer as JOneClassScorer
from occm_tpu.config import AASISTConfig as JAASISTConfig
from occm_tpu.config import XLSRConfig as JXLSRConfig
from occm_tpu.data import ASVDataset as JASVDataset
from occm_tpu.io.scorefiles import read_comma_scores
from occm_tpu.models import AModel as JAModel
from occm_tpu.serve import make_score_fn_v
from occm_tpu_torch.classify import (
    BucketedEmbedder, OneClassScorer, make_embed_fn_factory)
from occm_tpu_torch.config import AASISTConfig, XLSRConfig
from occm_tpu_torch.data import ASVDataset
from occm_tpu_torch.io.wav import load_audio, write_wav
from occm_tpu_torch.models import AModel, state_dict_from_flax

SR = 16000
STEP = 1600  # bucket step: the waves below fill several buckets
RTOL = 1e-4
LENGTHS = [2500, 3200, 1000, 2900, 7000, 4000, 1500, 3300, 4700]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """JAX model + variables, the port's model on the same weights, and an
    ASVspoof-shaped tree: a 5-column train protocol (bonafide and spoof
    rows) and a bare eval list over WAVs of the lengths above."""
    jmodel = JAModel(JAASISTConfig(), xlsr_cfg=JXLSRConfig.tiny())
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: jmodel.init(
        {"params": key, "dropout": key}, x))(jnp.zeros((2, 3200)))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    model = AModel(AASISTConfig(), XLSRConfig.tiny())
    model.load_state_dict(state_dict_from_flax(variables, XLSRConfig.tiny()),
                          strict=True)

    root = tmp_path_factory.mktemp("scoring_tree")
    lines, utts = [], []
    for i, n in enumerate(LENGTHS):
        utt = f"LA_T_{i:04d}"
        write_wav(str(root / f"{utt}.wav"),
                  (0.3 * rng.normal(size=n)).astype(np.float32), SR)
        label = "spoof" if i in (1, 5) else "bonafide"
        lines.append(f"LA_{i:04d} {utt} - {'A01' if i in (1, 5) else '-'} "
                     f"{label}")
        utts.append(utt)
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "eval.txt").write_text("\n".join(utts) + "\n")
    return dict(jmodel=jmodel, variables=variables, model=model, root=root)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _jax_embedder(sides, batch=2, seen=None):
    def factory(blen):
        if seen is not None:
            seen.append(blen)
        return make_score_fn_v(sides["jmodel"])

    return JBucketedEmbedder(embed_fn_factory=factory, bucket_step=STEP,
                             batch_size=batch, variables=sides["variables"])


def _port_embedder(sides, batch=2, seen=None, impl="xla"):
    base = make_embed_fn_factory(sides["model"], impl)

    def factory(blen):
        if seen is not None:
            seen.append(blen)
        fn = base(blen)

        def counted(x):
            assert x.shape == (batch, blen)  # batches padded to full rows
            return fn(x)

        return counted

    return BucketedEmbedder(embed_fn_factory=factory, bucket_step=STEP,
                            batch_size=batch, device="cpu")


def _waves(sides):
    return [load_audio(str(sides["root"] / f"LA_T_{i:04d}.wav"))[0]
            for i in range(len(LENGTHS))]


def test_buckets_order_and_embeddings_match_jax(sides):
    """Same buckets in the same order, outputs in input order, equal
    embeddings and logits."""
    waves = _waves(sides)
    jseen, seen = [], []
    want_e, want_l = _jax_embedder(sides, seen=jseen).embed_all(waves)
    got_e, got_l = _port_embedder(sides, seen=seen).embed_all(waves)
    assert seen == jseen == sorted({-(-n // STEP) * STEP for n in LENGTHS})
    assert got_e.shape == want_e.shape == (len(LENGTHS), 160)
    assert got_l.shape == want_l.shape == (len(LENGTHS), 2)
    _close(got_e, want_e)
    _close(got_l, want_l)


def test_embed_paths_equals_embed_all(sides):
    paths = [str(sides["root"] / f"LA_T_{i:04d}.wav")
             for i in range(len(LENGTHS))]
    emb = _port_embedder(sides, batch=3)
    a = emb.embed_all(_waves(sides))
    b = emb.embed_paths(paths)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _score_both(sides, tmp_path, mode):
    root = sides["root"]
    out = {}
    for name, embedder, scorer_cls, ds_cls in (
            ("jax", _jax_embedder(sides), JOneClassScorer, JASVDataset),
            ("port", _port_embedder(sides), OneClassScorer, ASVDataset)):
        d = tmp_path / name
        d.mkdir()
        scorer = scorer_cls(embedder, cache_dir=str(d))
        train = ds_cls(str(root / "train.txt"), str(root))
        evals = ds_cls(str(root / "eval.txt"), str(root), eval=True)
        score_file = str(d / "scores.txt")
        if mode == "1c":
            ref, thr = scorer.create_reference_embedding(train)
            scorer.score_eval_set_1c(evals, ref, thr, score_file=score_file)
            out[name] = (ref, thr, score_file, d)
        else:
            scorer.score_eval_set_2c(evals, score_file=score_file)
            out[name] = score_file
    return out


def test_one_class_scores_match_jax(sides, tmp_path):
    """Reference embedding (mean over the bonafide train rows: the two
    spoof rows are filtered out), threshold, distances.txt and the 1c score
    lines, "{distance}, {prediction} \\n"."""
    out = _score_both(sides, tmp_path, "1c")
    (jref, jthr, jfile, jdir), (ref, thr, pfile, pdir) = \
        out["jax"], out["port"]
    assert ref.shape == jref.shape == (160,)
    _close(ref, jref)
    # a distance carries the embeddings' error, 1e-4 of their norm
    atol = RTOL * np.linalg.norm(jref)
    assert thr == pytest.approx(jthr, rel=RTOL, abs=atol)
    np.testing.assert_allclose(
        np.loadtxt(pdir / "distances.txt"), np.loadtxt(jdir / "distances.txt"),
        rtol=RTOL, atol=atol)
    assert len(np.loadtxt(pdir / "distances.txt")) == len(LENGTHS) - 2
    jlines = open(jfile).read().splitlines(keepends=True)
    lines = open(pfile).read().splitlines(keepends=True)
    assert len(lines) == len(jlines) == len(LENGTHS)
    np.testing.assert_allclose(read_comma_scores(pfile),
                               read_comma_scores(jfile), rtol=RTOL, atol=atol)
    for a, b in zip(lines, jlines):
        d, pred = a.split(", ")
        assert pred in ("0 \n", "1 \n") and a == f"{float(d)}, {pred}"
        if abs(float(d) - thr) > atol:  # not within tolerance of it
            assert pred == b.split(", ")[1]


def test_two_class_logits_match_jax(sides, tmp_path):
    out = _score_both(sides, tmp_path, "2c")
    got = np.loadtxt(out["port"])
    want = np.loadtxt(out["jax"])
    assert got.shape == (len(LENGTHS),)
    _close(got, want)


def test_reference_cache_is_loaded_and_nothing_embedded(sides, tmp_path):
    root = sides["root"]
    train = ASVDataset(str(root / "train.txt"), str(root))
    first = OneClassScorer(_port_embedder(sides), cache_dir=str(tmp_path))
    ref, thr = first.create_reference_embedding(train)

    def refuse(blen):
        raise AssertionError("the cached reference was embedded again")

    second = OneClassScorer(
        BucketedEmbedder(embed_fn_factory=refuse, bucket_step=STEP,
                         device="cpu"), cache_dir=str(tmp_path))
    ref2, thr2 = second.create_reference_embedding(train)
    np.testing.assert_array_equal(ref2, ref)
    assert thr2 == np.float32(thr)
    assert len(np.loadtxt(tmp_path / "distances.txt")) == len(LENGTHS) - 2


def test_mesh_and_argument_errors_raise():
    with pytest.raises(NotImplementedError, match="queue A item 15"):
        BucketedEmbedder(lambda x: (x, x), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        BucketedEmbedder(device="cpu")


def test_bucket_lengths_and_max_len_crop():
    emb = BucketedEmbedder(lambda x: (x, x), bucket_step=STEP, device="cpu")
    assert [emb._bucket_len(n) for n in (1, STEP, STEP + 1)] == \
        [STEP, STEP, 2 * STEP]
    cropped = BucketedEmbedder(lambda x: (x[:, :4], x[:, :2]),
                               bucket_step=STEP, max_len=STEP, batch_size=2,
                               device="cpu")
    w = np.arange(5000, dtype=np.float32)
    e, _ = cropped.embed_all([w, w[:10]])
    np.testing.assert_array_equal(e[0], w[:4])  # cropped to max_len
    np.testing.assert_array_equal(e[1], np.tile(w[:10], 2)[:4])
