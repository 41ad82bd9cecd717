"""Distribution of the PyTorch/CUDA port over ``torch.distributed``:
the (data, model) process mesh and the attention's tensor parallelism."""

from sketch2img_torch.parallel.tp import tp_param_specs, shard_params_tp
from sketch2img_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated,
    shard_params,
    fetch_global,
    shard_batch,
    shard_batch_array,
    initialize_distributed,
    sync_global_devices,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_params",
    "fetch_global",
    "shard_batch",
    "shard_batch_array",
    "initialize_distributed",
    "sync_global_devices",
    "tp_param_specs",
    "shard_params_tp",
]
