"""One rank of the port's multi-rank CPU checks (tests/test_torch_parallel_train.py,
tests/test_torch_pipeline.py).

    python tests/torch_mp_worker.py RANK WORLD PORT SPEC.json

joins a Gloo process group of WORLD ranks on 127.0.0.1:PORT (torch pinned
to one thread), then runs the spec's cases in order, each on its own mesh.
A case builds the tiny AModel from a state dict file, places its train
state on the mesh, and takes one train step on its rows of a global batch
(or steps, or runs `train()` over a sharded pipeline, or runs the
encoder's forward, or compares the remat policies), then rank 0 saves the
gathered state, the losses, the per-rank bytes and the placement table.
The configs come from `configs()`, which the tests also build the
single-process and JAX references from.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from occm_tpu_torch.config import (  # noqa: E402
    AASISTConfig, MeshConfig, RawBoostConfig, TrainConfig, XLSRConfig)

CUT = 3200
LR = 1e-3


def configs(kind: str, xlsr=None, **train):
    """(xlsr, aasist, train) configs of a case kind: "jax" (plain
    attention and FFN, no dropout: what the JAX step is held to), "kernels"
    (flash attention, the fused FFN and LayerNorm kernels' routes, residual
    dropout, AASIST's dropouts, RawBoost), "dropout" (plain attention and
    FFN with every XLSR dropout site on), "remat" ("kernels" with each
    layer recomputed under attn_out_inner), "all" ("dropout" with
    layerdrop, AASIST's dropouts and RawBoost). `xlsr`: XLSRConfig fields
    to replace (the pipeline's and sequence parallelism's)."""
    x = dataclasses.replace(XLSRConfig.tiny(), encoder_embed_dim=128)
    a = AASISTConfig.tiny()
    rb = RawBoostConfig(algo=0)
    if kind == "jax":
        a = dataclasses.replace(a, dropout=0.0, pool_dropout=0.0,
                                head_dropout=0.0)
    elif kind in ("kernels", "remat"):
        x = dataclasses.replace(x, attention_impl="flash", ffn_impl="pallas",
                                ln_impl="pallas", dropout=0.1)
        if kind == "remat":
            x = dataclasses.replace(x, remat=True,
                                    remat_policy="attn_out_inner")
        rb = RawBoostConfig(algo=5)
    elif kind in ("dropout", "all"):
        x = dataclasses.replace(x, dropout=0.1, attention_dropout=0.1,
                                activation_dropout=0.1, dropout_input=0.1)
        if kind == "all":
            x = dataclasses.replace(x, layerdrop=0.3)
            rb = RawBoostConfig(algo=5)
    else:
        raise ValueError(kind)
    if xlsr:
        x = dataclasses.replace(x, **xlsr)
    t = TrainConfig(**{**dict(optimizer="fused_adam", lr=LR, cut=CUT,
                              compactness_weight=0.1,
                              descriptiveness_weight=0.9, rawboost=rb),
                       **train})
    return x, a, t


def build_state(init_path, kind, xlsr=None, **train):
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train import create_train_state

    x, a, t = configs(kind, xlsr, **train)
    model = AModel(a, x)
    model.load_state_dict(torch.load(init_path, weights_only=True),
                          strict=True)
    return create_train_state(model, t), t


def gathered(state):
    """The state whole (a collective), on the CPU."""
    from occm_tpu_torch.parallel.sharding import (
        full_optimizer_state, full_parameters)

    with full_parameters(state):
        sd = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    opt = full_optimizer_state(state)
    return sd, {"count": opt["count"],
                "mu": {k: v.clone() for k, v in opt["mu"].items()},
                "nu": {k: v.clone() for k, v in opt["nu"].items()}}


class _Pipeline:
    """A sharded pipeline stand-in: this rank's batches of one epoch."""

    def __init__(self, batches, shard_index, shard_count):
        self.batches = batches
        self.shard_index = shard_index
        self.shard_count = shard_count

    def epoch(self, epoch):
        return iter(self.batches)


def _train_loop(case, rank, mesh, data):
    """train() over a pipeline sharded over dp=2 (this rank's batches, a
    ragged tail among them), writing loss.txt and an epoch checkpoint."""
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train.checkpoint import save_checkpoint
    from occm_tpu_torch.train.loop import train
    from occm_tpu_torch.utils.logging import MetricsLogger

    x, a, t = configs(case["kind"], groups_per_step=2, log_every=1,
                      checkpoint_dir=case["ckpt_dir"],
                      loss_txt=os.path.join(case["ckpt_dir"],
                                            f"loss_{rank}.txt"))
    model = AModel(a, x)
    model.load_state_dict(torch.load(case["init"], weights_only=True),
                          strict=True)
    batches = [(data[f"x{s}_{rank}"], data[f"l{s}_{rank}"])
               for s in range(case["steps"])]
    losses = []
    state = train(model, _Pipeline(batches, rank, 2), t, num_epochs=1,
                  device="cpu", mesh=mesh,
                  logger=MetricsLogger(t.loss_txt, None),
                  checkpoint_fn=lambda s, e: save_checkpoint(
                      s, t.checkpoint_dir, t.checkpoint_prefix, e),
                  on_step=lambda step, m: losses.append(float(m["loss"])))
    return state, {"losses": losses}


def _refuse_graph(case, mesh):
    """train() asked for k = 2 steps per dispatch on a card over Gloo: the
    ValueError's message, raised before anything touches the card (so a
    CPU host passes for one here)."""
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train.loop import train

    x, a, t = configs("jax", steps_per_dispatch=2)
    available = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        train(AModel(a, x), _Pipeline([], 0, 1), t, num_epochs=1,
              device="cuda", mesh=mesh)
    except ValueError as e:
        return str(e)
    finally:
        torch.cuda.is_available = available
    return None


def _remat_policies(case, mesh):
    """tp=2 with sequence parallelism: the encoder's features and its
    gathered parameter gradient (of sum(features^2)) under every remat
    policy, each against no remat (rank 0 returns how many differ)."""
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.models.remat import NAMED
    from occm_tpu_torch.parallel import compute_mesh
    from occm_tpu_torch.parallel.sharding import (
        place_state_on_mesh, reduce_gradients)
    from occm_tpu_torch.train import create_train_state

    wave = torch.from_numpy(np.load(case["batch"])["x"])
    out = {}
    for policy in (None,) + tuple(NAMED):
        remat = dict(remat=policy is not None,
                     remat_policy=policy or "nothing")
        x, a, t = configs("dropout", dict(case["xlsr"], **remat))
        model = AModel(a, x)
        model.load_state_dict(torch.load(case["init"], weights_only=True))
        state = create_train_state(model, t)
        place_state_on_mesh(state, mesh)
        enc = model.ssl_model.model.train()
        gen = torch.Generator().manual_seed(5)
        with compute_mesh(mesh):
            feats = enc(wave, generator=gen)
            (feats ** 2).sum().backward()
        reduce_gradients(state, [])  # the tp_sum leaves' sums
        grads = [p.grad.clone() for _, p in state.named_params()
                 if p.grad is not None]
        out[policy] = (feats.detach().clone(), grads)
    base_f, base_g = out[None]
    return {str(policy): [bool(torch.equal(f, base_f)),
                          all(torch.equal(g, h) for g, h in zip(gs, base_g))]
            for policy, (f, gs) in out.items() if policy is not None}


def _forward(case, mesh):
    """The XLSR encoder's eval-mode features on the mesh (its layers on
    this rank's shards), as a list."""
    from occm_tpu_torch.parallel import compute_mesh
    from occm_tpu_torch.parallel.sharding import place_state_on_mesh

    state, _ = build_state(case["init"], case["kind"], case.get("xlsr"))
    place_state_on_mesh(state, mesh)
    wave = torch.from_numpy(np.load(case["batch"])["x"][:case["rows"]])
    with compute_mesh(mesh), torch.no_grad():
        return state.model.ssl_model.eval()(wave).tolist()


def _train_api(case, model, t, mesh, data, losses):
    """train() of `model` on the mesh over an unsharded pipeline of the
    case's batches (every rank given the global batch, as the CLI's
    pipeline on a mesh without data axes); returns the trained state and
    its last step's metrics."""
    from occm_tpu_torch.train.loop import train

    labels = data["labels"]
    batches = [(data["x"] if i == 0 else data[f"x{i}"], labels)
               for i in range(case.get("steps", 1))]
    metrics = []
    new = train(model, _Pipeline(batches, 0, 1), t, num_epochs=1,
                device="cpu", mesh=mesh,
                on_step=lambda step, m: (losses.append(float(m["loss"])),
                                         metrics.append(m)))
    return new, metrics[-1]


def run_case(case, rank, out_dir):
    import torch.distributed as dist

    from occm_tpu_torch.parallel import make_mesh
    from occm_tpu_torch.parallel.sharding import (
        held_bytes, place_state_on_mesh, placement_table, shard_batch,
        stage_table)
    from occm_tpu_torch.train import train_step
    from occm_tpu_torch.train.checkpoint import restore_checkpoint

    mesh = make_mesh(MeshConfig(**case["mesh"]))
    result = {}
    if case.get("refuse_graph"):
        result["error"] = _refuse_graph(case, mesh)
        state = None
    elif case.get("train_loop"):
        state, result = _train_loop(case, rank, mesh, np.load(case["batch"]))
    elif case.get("remat_policies"):
        result["remat"] = _remat_policies(case, mesh)
        state = None
    elif case.get("forward"):
        try:
            result["feats"] = _forward(case, mesh)
        except ValueError as e:
            if not case.get("expect_error"):
                raise
            result["error"] = str(e)
        state = None
    else:
        data = np.load(case["batch"])
        state, t = build_state(case["init"], case["kind"], case.get("xlsr"),
                               **case.get("train", {}))
        replicated = bool(case.get("replicated"))
        result["all_losses"] = []
        steps = case.get("steps", 1)
        if case.get("train_api"):
            # train() builds and places its own state from the model
            state, m = _train_api(case, state.model, t, mesh, data,
                                  result["all_losses"])
            steps = 0
        else:
            place_state_on_mesh(state, mesh)
        if case.get("restore_dir"):
            # a one-process checkpoint into the placed state
            restore_checkpoint(state, case["restore_dir"], "aasist_vocoded",
                               0)
        result["bytes_before"] = held_bytes(state)
        for i in range(steps):
            x = torch.from_numpy(data["x"] if i == 0 else data[f"x{i}"])
            labels = torch.from_numpy(data["labels"]).long()
            if not replicated:
                x, labels = shard_batch((x, labels), mesh, t.grad_accum)
            m = train_step(state, x, labels, t, replicated=replicated)
            result["all_losses"].append(float(m["loss"]))
        result["losses"] = [float(m["loss"]), float(m["closs"]),
                            float(m["dloss"])]
        result["bytes_after"] = held_bytes(state)
        if case.get("save_dir"):
            from occm_tpu_torch.train.checkpoint import save_checkpoint

            save_checkpoint(state, case["save_dir"], "aasist_vocoded", 0)
        opt = state.optimizer_state()
        result["moment_shapes"] = {n: list(mu.shape)
                                   for n, mu in opt["mu"].items()}
        result["param_shapes"] = {n: list(p.shape)
                                  for n, p in state.named_params()}
    if state is not None:
        result["placements"] = {n: list(v) for n, v in
                                placement_table(state.placements).items()}
        result["stages"] = stage_table(state.placements)
        sd, opt = gathered(state)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, result)
    if rank == 0:
        payload = {"ranks": ranks}
        if state is not None:
            payload.update(state_dict=sd, opt=opt, step=state.step,
                           rng=state.generator.get_state())
        torch.save(payload, os.path.join(out_dir, case["name"] + ".pt"))


def main():
    rank, world, port, spec_path = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    from occm_tpu_torch.parallel import multihost

    multihost.initialize("cpu", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=world, rank=rank)
    with open(spec_path) as f:
        spec = json.load(f)
    for case in spec["cases"]:
        run_case(case, rank, spec["out_dir"])
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
