"""Multi-GPU parallelism over torch.distributed (port of
`occm_tpu.parallel`): the (dp, pp, fsdp, tp) mesh over ranks
(`mesh.py`), the placement of parameters, optimizer state and batches
(`sharding.py`), process-group initialisation (`multihost.py`) and the
collectives with their autograd forms and the pipeline's point-to-point
messages (`collectives.py`)."""

from occm_tpu_torch.parallel.mesh import (
    batch_sharding,
    compute_mesh,
    current_mesh,
    data_axes,
    data_parallel_size,
    data_shard_for_process,
    data_spec,
    make_mesh,
    pp_group,
    pp_peer,
    pp_stage,
    replicated,
)
from occm_tpu_torch.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    place_state_on_mesh,
    shard_batch,
    train_state_shardings,
)

__all__ = [
    "make_mesh",
    "compute_mesh",
    "current_mesh",
    "batch_sharding",
    "data_axes",
    "data_parallel_size",
    "data_shard_for_process",
    "data_spec",
    "replicated",
    "pp_group",
    "pp_peer",
    "pp_stage",
    "opt_state_shardings",
    "param_shardings",
    "train_state_shardings",
    "place_state_on_mesh",
    "shard_batch",
]
