"""Process mesh and data sharding over ``torch.distributed`` — counterpart of
``sketch2img_tpu/parallel/mesh.py``.

One process per GPU, launched by ``torchrun`` (or given its rank, world size
and rendezvous explicitly). ``make_mesh`` lays the world out as a
(data, model) grid with the model axis inner: rank = data_index *
model_size + model_index, so the ranks of one model group are neighbours
(one host's NVLink when a job spans hosts). Each rank holds its own copy of
the weights (``shard_params`` broadcasts rank 0's) and its rows of a batch
(``shard_batch_array``); ``fetch_global`` gathers a batch back over the data
axis, so every rank returns the same full batch. The collectives run on the
mesh's process groups: NCCL for CUDA tensors, gloo for CPU ones.

Without a process group (one process, no ``torchrun`` environment) the mesh
has one rank and every function here is an identity, as JAX's are on one
device.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from sketch2img_torch.utils.device import set_deterministic

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(device: Union[str, torch.device] = "cuda", *,
                           backend: Optional[str] = None, init_method: Optional[str] = None,
                           rank: Optional[int] = None, world_size: Optional[int] = None) -> bool:
    """Join the default process group; call once per process before any
    collective. Rank and world size come from the arguments or from the
    environment ``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT). ``backend`` defaults to NCCL for
    ``device="cuda"`` (the process then takes GPU LOCAL_RANK) and gloo for
    ``"cpu"``. A no-op, returning False, when a group is already up or when a
    single process has no such environment. -> True if it joined one."""
    if dist.is_initialized():
        return False
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    dev = torch.device(device)
    set_deterministic(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0 if rank is None else rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None else world_size)
    return True


def sync_global_devices(tag: str = "barrier") -> None:
    """Barrier across every process (no-op in one process). ``tag`` names it
    in the JAX package and is unused here."""
    del tag
    if dist.is_initialized():
        dist.barrier()


def world() -> tuple:
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """The (data, model) grid of the world's ranks. ``shape`` maps each axis
    to its size; ``data_index`` / ``model_index`` are this rank's
    coordinates; ``data_group`` holds the ranks that share this rank's model
    index (its batch rows differ, its weights match), ``model_group`` those
    that share its data index (its rows match, its attention heads differ).
    Both groups are None without a process group."""

    def __init__(self, data_size: int, model_size: int, rank: int, data_group, model_group):
        self.shape = {DATA_AXIS: data_size, MODEL_AXIS: model_size}
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model_size)
        self.data_group = data_group
        self.model_group = model_group

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank})")


def make_mesh(model_parallel: int = 1) -> Mesh:
    """(data, model) mesh over every rank of the default group (one rank
    without a group), the model axis inner. Every rank must call it, in the
    same order as its other group creations."""
    rank, n = world()
    if n % model_parallel:
        raise ValueError(f"world size {n} does not divide by model_parallel={model_parallel}")
    dp = n // model_parallel
    data_group = model_group = None
    if dist.is_initialized():
        # every rank creates every group, in one order
        for m in range(model_parallel):
            g = dist.new_group([d * model_parallel + m for d in range(dp)])
            if rank % model_parallel == m:
                data_group = g
        for d in range(dp):
            g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
            if rank // model_parallel == d:
                model_group = g
    return Mesh(dp, model_parallel, rank, data_group, model_group)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` rows: its data index's
    contiguous block (the leading axis split over ``data``; replicated over
    ``model``)."""
    dp = mesh.shape[DATA_AXIS]
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide the mesh's data axis ({dp})")
    n = batch // dp
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def replicated(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``x`` with rank 0's value on every rank (an in-place broadcast over
    the world; the identity in one process)."""
    del mesh  # the world holds every replica
    if dist.is_initialized():
        _broadcast(x)
    return x


def shard_params(mesh: Optional[Mesh], params):
    """Replicate weights: every parameter and buffer of a module (or every
    tensor of a dict) gets rank 0's value. -> ``params``."""
    tensors = (list(params.state_dict().values()) if isinstance(params, torch.nn.Module)
               else list(params.values()))
    with torch.no_grad():
        for t in tensors:
            replicated(mesh, t)
    return params


def shard_batch_array(mesh: Optional[Mesh], x):
    """This rank's rows of one tensor's (or list's) leading axis
    (``batch_sharding``); every rank passes the same full batch. The
    identity without a mesh."""
    if mesh is None:
        return x
    return x[batch_sharding(mesh, len(x))]


def shard_batch(mesh: Optional[Mesh], batch):
    """``shard_batch_array`` over every tensor or array of a dict, list or
    tuple."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return shard_batch_array(mesh, batch)


def fetch_global(mesh: Optional[Mesh], x):
    """The full batch from each rank's rows: an all-gather over the data
    group, the rows in data-index order, so every rank returns the same
    tensor. The identity without a mesh or in one process. Unlike the JAX
    package's (which returns a numpy array), the result stays a tensor on
    ``x``'s device: the port's callbacks take tensors."""
    if mesh is None or mesh.data_group is None:
        return x
    return all_gather_rows(x, mesh.data_group)


def _gloo_on_cuda(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each), concatenated on the leading
    axis in group-rank order. gloo gathers CUDA tensors through the host."""
    if _gloo_on_cuda(x, group):
        return all_gather_rows(x.cpu(), group).to(x.device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group`` (no-op without a process
    group). -> ``x``. gloo reduces a 16-bit float tensor in fp32 (it may
    not take bf16), then rounds once."""
    if not dist.is_initialized():
        return x
    if x.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(group) == "gloo":
        wide = x.float()
        dist.all_reduce(wide, op=op, group=group)
        return x.copy_(wide)
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``x`` over ``group``, differentiable: each rank's
    gradient is the sum of every rank's gradient of the sum (right for a
    per-rank term such as a shard's batch statistics, whose sum every rank's
    loss reads). The identity without a process group."""
    if not dist.is_initialized():
        return x
    return _AllReduceSum.apply(x, group)


def average_gradients(params, group, size: int) -> None:
    """Replace every ``.grad`` of ``params`` by its mean over ``group`` (of
    ``size`` ranks): one all-reduce of the flattened gradients, as GSPMD's
    implicit one over a replicated parameter's data shards."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or not dist.is_initialized():
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group)
    flat /= size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _broadcast(x: torch.Tensor) -> None:
    src = x if x.is_contiguous() else x.contiguous()
    if src.dtype in (torch.bfloat16, torch.float16) and dist.get_backend() == "gloo":
        src = src.float()  # lossless both ways
    dist.broadcast(src, 0)
    if src is not x:
        x.copy_(src)


def broadcast_object(obj: Any = None, group=None) -> Any:
    """Rank 0's ``obj`` on every rank of ``group`` (pickled). The identity
    in one process."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]
