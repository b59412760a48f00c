"""Data-parallel scoring, embedding and serving in the port
(`occm_tpu_torch.parallel.replicas`: `BucketedEmbedder(mesh=)`,
`ScoringService(mesh=)`, `make_dp_mesh`), the counterparts of
tests/test_scoring_dp.py. The mesh is a list of CPU devices standing in
for the JAX tests' virtual CPU devices: every batch is split into one row
block per device, each block runs on its own replica, and the outputs
come back in order. Held to the single-device result within 1e-6, and to
the JAX package's data-parallel embedder on the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occm_tpu.classify import BucketedEmbedder as JBucketedEmbedder
from occm_tpu.classify import make_dp_mesh as j_make_dp_mesh
from occm_tpu_torch.classify import (
    BucketedEmbedder, make_dp_mesh, make_embed_fn_factory)
from occm_tpu_torch.parallel.replicas import DPMesh, replicate
from occm_tpu_torch.serve import ScoringService, make_score_fn

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _TinyEmbed(torch.nn.Module):
    """tests/test_scoring_dp.py's _TinyEmbed: 100-sample frames through a
    Dense(32) on tanh, their mean, Dense(16) on tanh, Dense(2)."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.h = torch.nn.Linear(100, 32)
        self.emb = torch.nn.Linear(32, 16)
        self.head = torch.nn.Linear(16, 2)
        for p in self.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.3

    def forward(self, x, attention_impl=None):
        b, t = x.shape
        frames = x.reshape(b, t // 100, 100)
        h = self.h(torch.tanh(frames))
        emb = self.emb(torch.tanh(h.mean(dim=1)))
        return emb, self.head(emb)


def _embed_fn(model=None):
    return make_score_fn(model or _TinyEmbed())


def _waves(n=13, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=rng.integers(300, 1500)).astype(np.float32)
            for _ in range(n)]


def test_make_dp_mesh_sizes():
    assert make_dp_mesh(device_type="cpu").devices == (CPU,)
    with pytest.raises(ValueError, match="only 1 present"):
        make_dp_mesh(2, device_type="cpu")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} present"):
        make_dp_mesh(n + 1)


def test_embedder_dp_matches_single_device():
    fn = _embed_fn()
    waves = _waves()
    single = BucketedEmbedder(fn, bucket_step=800, batch_size=8,
                              device="cpu")
    dp = BucketedEmbedder(fn, bucket_step=800, batch_size=8,
                          mesh=[CPU] * 4)
    e1, l1 = single.embed_all(waves)
    e2, l2 = dp.embed_all(waves)
    np.testing.assert_allclose(e1, e2, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l1, l2, rtol=1e-6, atol=1e-6)


def test_embedder_dp_rounds_batch_up():
    emb = BucketedEmbedder(_embed_fn(), bucket_step=800, batch_size=5,
                           mesh=["cpu"] * 4)
    assert emb.batch_size == 8  # next multiple of 4 >= 5
    e, lg = emb.embed_all(_waves(3, seed=1))
    assert e.shape[0] == 3 and lg.shape[0] == 3


def test_embedder_rejects_multi_axis_mesh():
    class TwoAxes:
        axis_names = ("a", "b")

    for mesh in (TwoAxes(), [[CPU, CPU], [CPU, CPU]], object()):
        with pytest.raises(ValueError, match="one axis"):
            BucketedEmbedder(_embed_fn(), mesh=mesh)


def test_replicas_run_one_block_each():
    """One replica per mesh device, each called on its own block of every
    batch: a rank-tagged fn shows the order of the gathered rows."""
    mesh = DPMesh((CPU,) * 4)
    calls = []

    def tagged(i):
        def fn(x):
            calls.append((i, x.shape[0]))
            return x[:, :1] * 0 + i, x[:, :2]
        return fn

    emb = BucketedEmbedder([tagged(i) for i in range(4)], bucket_step=800,
                           batch_size=8, mesh=mesh)
    e, _ = emb.embed_all([np.ones(800, np.float32)] * 8)
    assert calls == [(i, 2) for i in range(4)]
    assert e[:, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    model = _TinyEmbed()
    assert replicate(model, mesh) == [model] * 4  # already on each device


def test_embed_fn_factory_replicates_the_model(tmp_path):
    """make_embed_fn_factory(mesh=) gives one score fn per device, each on
    a replica of the model (here one CPU device: the model itself)."""
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel

    torch.manual_seed(0)
    model = AModel(AASISTConfig.tiny(), XLSRConfig.tiny()).eval()
    fns = make_embed_fn_factory(model, "xla", mesh=[CPU])(3200)
    assert isinstance(fns, list) and len(fns) == 1
    waves = _waves(5, seed=3)
    waves = [np.resize(w, 3000) for w in waves]
    single = BucketedEmbedder(embed_fn_factory=make_embed_fn_factory(
        model, "xla"), bucket_step=3200, batch_size=4, device="cpu")
    dp = BucketedEmbedder(embed_fn_factory=make_embed_fn_factory(
        model, "xla", mesh=[CPU]), bucket_step=3200, batch_size=3,
        mesh=[CPU])
    e1, l1 = single.embed_all(waves)
    e2, l2 = dp.embed_all(waves)
    np.testing.assert_allclose(e1, e2, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l1, l2, rtol=1e-6, atol=1e-6)


def test_scoring_service_dp_matches_single_device():
    fn = _embed_fn()
    reference = np.linspace(-1, 1, 16).astype(np.float32)
    waves = _waves(9, seed=2)
    single = ScoringService(fn, reference, threshold=0.5,
                            buckets=(800, 1600), batch=8, device="cpu")
    dp = ScoringService(fn, reference, threshold=0.5, buckets=(800, 1600),
                        batch=8, mesh=[CPU] * 8)
    s1, p1 = single.score(waves)
    s2, p2 = dp.score(waves)
    np.testing.assert_allclose(s1, s2, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(p1, p2)


def test_scoring_service_dp_rounds_batch_up():
    svc = ScoringService(_embed_fn(), np.zeros(16, np.float32),
                         threshold=0.5, buckets=(800,), batch=3,
                         mesh=[CPU] * 8)
    assert svc.batch == 8
    svc.warmup()


def test_dp_embedder_matches_the_jax_dp_embedder():
    """The same weights through JAX's embedder on a ("dp",) mesh of 8
    virtual CPU devices and the port's on 4 CPU replicas."""
    import flax.linen as nn

    class JTiny(nn.Module):
        @nn.compact
        def __call__(self, x):
            b, t = x.shape
            frames = x.reshape(b, t // 100, 100)
            h = nn.Dense(32, name="h")(jnp.tanh(frames))
            emb = nn.Dense(16, name="emb")(jnp.tanh(h.mean(axis=1)))
            return emb, nn.Dense(2, name="head")(emb)

    model = _TinyEmbed()
    params = {n: {"kernel": jnp.asarray(getattr(model, n).weight.detach()
                                        .numpy().T),
                  "bias": jnp.asarray(getattr(model, n).bias.detach()
                                      .numpy())}
              for n in ("h", "emb", "head")}
    jfn = jax.jit(lambda x: JTiny().apply({"params": params}, x))
    waves = _waves(11, seed=4)
    want_e, want_l = JBucketedEmbedder(
        jfn, bucket_step=800, batch_size=8,
        mesh=j_make_dp_mesh(8)).embed_all(waves)
    got_e, got_l = BucketedEmbedder(
        _embed_fn(model), bucket_step=800, batch_size=8,
        mesh=[CPU] * 4).embed_all(waves)
    np.testing.assert_allclose(got_e, np.asarray(want_e), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_l, np.asarray(want_l), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ CLIs

from test_torch_classifier_cli import _args, tree  # noqa: E402,F401


def test_classifier_cli_data_parallel_scores_as_one_device(tree, tmp_path,
                                                           monkeypatch):
    """oc_classifier --data_parallel -1 --device cpu (the CPU is one
    device) writes the plain run's scores; --data_parallel 2 there raises
    as JAX's make_dp_mesh does."""
    from occm_tpu_torch.cli import oc_classifier

    monkeypatch.chdir(tmp_path)
    for mode in ("1c2", "2c2"):
        oc_classifier.main(_args(tree, mode, tmp_path / f"{mode}.txt"))
        oc_classifier.main(_args(tree, mode, tmp_path / f"{mode}_dp.txt",
                                 "--data_parallel", "-1"))
        assert (tmp_path / f"{mode}.txt").read_text() == \
            (tmp_path / f"{mode}_dp.txt").read_text()
    with pytest.raises(ValueError, match="only 1 present"):
        oc_classifier.main(_args(tree, "2c2", tmp_path / "x.txt",
                                 "--data_parallel", "2"))


def test_embed_cli_data_parallel_embeds_as_one_device(tree, tmp_path):
    from occm_tpu_torch.cli import embed

    base = ["--pretrained-sslaasist", str(tree / "aasist_vocoded_1.pt"),
            "--protocol_file", str(tree / "eval.txt"), "--eval",
            "--dataset_dir", str(tree / "eval"), "--bucket_step", "3200",
            "--batch_size", "3", "--xlsr_tiny", "--device", "cpu"]
    embed.main(base + ["--out", str(tmp_path / "a.npz")])
    embed.main(base + ["--out", str(tmp_path / "b.npz"),
                       "--data_parallel", "-1"])
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    for k in ("embeddings", "logits"):
        np.testing.assert_array_equal(a[k], b[k])


def test_server_cli_data_parallel_scores_as_one_device(tmp_path):
    import threading

    from occm_tpu_torch.cli import oc_server

    np.save(tmp_path / "reference_embedding.npy",
            np.linspace(-1, 1, 160).astype(np.float32))
    np.save(tmp_path / "threshold.npy", np.float32(3.0))
    waves = [w.astype(np.float32) for w in _waves(5, seed=5)]
    scores = {}
    for extra in ([], ["--data_parallel", "-1"]):
        started = threading.Event()
        started.stop = threading.Event()
        t = threading.Thread(target=oc_server.main, args=([
            "--artifacts_dir", str(tmp_path), "--host", "127.0.0.1",
            "--port", "0", "--xlsr_tiny", "--allow_random_init",
            "--batch_size", "3", "--buckets", "3200", "--device", "cpu",
            "--no_warmup", *extra], started), daemon=True)
        t.start()
        assert started.wait(timeout=120), "server failed to start"
        try:
            scores[bool(extra)] = started.service.score(waves)
        finally:
            started.stop.set()
            t.join(timeout=30)
    np.testing.assert_array_equal(scores[True][0], scores[False][0])
    np.testing.assert_array_equal(scores[True][1], scores[False][1])
