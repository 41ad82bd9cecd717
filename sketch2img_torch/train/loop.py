"""The training loop both trainers share (``apps/train_lgp.py``,
``apps/train_attn_inject.py``): data, resume positioning, checkpoints,
signal handling and step timing, around a trainer's own step.

Resume: a checkpoint holds the step, the trainables, the optimizer and the
step generator (``train/checkpoint.py``); the loader is deterministic and
epoch-seeded, so ``set_epoch`` and ``skip_batches`` put the stream where
the interrupted run stopped, and a resumed run takes the batches, the draws
and the updates of the uninterrupted one (a random crop draws from the
dataset's own generator, which restarts: with ``center_crop: false`` the
crops after a resume differ, as in the JAX package).

Data parallel (``mesh``, a ``parallel.make_mesh()`` mesh over the ranks of a
``torchrun`` job): ``batch_size`` stays the global batch of one step, as on
one JAX host; each rank loads ``batch_size / ranks`` rows (the loader's
per-process shard; under ARB its rows of the bucket batch) and the step
reduces over the data group. Rank 0 alone logs, checkpoints, samples and
exports, with a barrier after each, where the JAX app gates on
``process_index() == 0``; every rank reads a resume. A stop signal on any
rank stops every rank at the same step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from sketch2img_torch.core.config import Config
from sketch2img_torch.data.dataset import ImageStore
from sketch2img_torch.data.loader import Loader
from sketch2img_torch.train.checkpoint import restore_train_state, save_train_state
from sketch2img_torch.train.signals import GracefulShutdown
from sketch2img_torch.utils.device import resolve_device, set_deterministic


@dataclasses.dataclass
class TrainResult:
    """What a training call did: the last step, the loss and the host-clock
    seconds of each step it ran (each ends in a device sync: the loss is
    read), the files it wrote, whether a signal stopped it, and the trained
    modules and optimizer (``modules``, by name)."""

    step: int
    losses: List[float]
    step_seconds: List[float]
    checkpoint: Optional[str] = None
    exports: List[str] = dataclasses.field(default_factory=list)
    interrupted: bool = False
    modules: Dict[str, Any] = dataclasses.field(default_factory=dict)


#: linear LR warm-up of both trainers (the reference trainers' 150 steps)
WARMUP_STEPS = 150


def as_config(config) -> Config:
    return config if isinstance(config, Config) else Config(config)


def components_device(components, device) -> torch.device:
    """``device`` resolved (a CUDA request without a GPU raises), and the
    components required to be on it; on the card cuDNN made deterministic,
    so that a step from the same state and draws gives the same update."""
    dev = resolve_device(device)
    set_deterministic(dev)
    if components.device != dev:
        raise ValueError(f"the components are on {components.device}, not on {dev}")
    return dev


def distributed_mesh():
    """The trainers' mesh: the process group of a ``torchrun`` job on the
    card (none for one process), a data axis over every rank."""
    from sketch2img_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed("cuda")
    return make_mesh()


def is_lead(mesh) -> bool:
    """Does this rank log, checkpoint, sample and export (rank 0)?"""
    return mesh is None or mesh.rank == 0


class Data:
    """The dataset and its batch stream: ``BucketBatcher`` over aspect-ratio
    buckets when ``arb.enabled`` (and the trainer allows it), else
    ``Loader``; ``position`` is whichever takes ``set_epoch`` and
    ``skip_batches``. Under ``mesh`` each rank streams its shard of every
    global batch (``batch_size`` must divide by the data axis)."""

    def __init__(self, cfg: Config, tokenizer, *, allow_arb: bool = True, mesh=None):
        self.index, self.count = (0, 1) if mesh is None else (mesh.data_index,
                                                              mesh.shape["data"])
        if cfg.batch_size % self.count:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide by the "
                             f"{self.count} data-parallel ranks")
        self.dataset = ds = ImageStore(size=cfg.resolution, seed=cfg.seed,
                                       rank=0 if mesh is None else mesh.rank,
                                       tokenizer=tokenizer, **cfg.dataset)
        self.arb = allow_arb and bool(cfg.get_path("arb.enabled", False))
        if self.arb:
            from sketch2img_torch.data.arb import BucketBatcher

            assignments = ds.enable_arb(dict(cfg.get_path("arb", {})))
            self.position = BucketBatcher(assignments, cfg.batch_size, seed=cfg.seed)
        else:
            self.position = Loader(ds, cfg.batch_size // self.count, seed=cfg.seed,
                                   pad_to=ds.max_length, process_index=self.index,
                                   process_count=self.count)

    def __len__(self) -> int:
        return len(self.position)

    def __iter__(self):
        if not self.arb:
            yield from self.position
            return
        ds = self.dataset
        for bucket, idxs in self.position:
            idxs = idxs[self.index::self.count]  # this rank's rows, as the loader's
            yield ds.collate_fn([ds.get_bucketed(i, bucket) for i in idxs], pad_to=ds.max_length)


def batch_to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Collated numpy batch -> tensors on ``device``: ids as int64, pixels
    NHWC -> NCHW; cached moments and sketches are NCHW already."""
    out = {}
    for k, v in batch.items():
        x = torch.from_numpy(np.ascontiguousarray(v))
        if k == "input_ids":
            x = x.long()
        elif k == "pixels":
            x = x.permute(0, 3, 1, 2)
        out[k] = x.to(device, non_blocking=True).contiguous()
    return out


def numpy_nchw_fn(fn: Callable[[torch.Tensor], torch.Tensor], device) -> Callable:
    """A cache function for ``ImageStore.cache_latents``: (1, H, W, 3)
    numpy pixels -> ``fn`` on the NCHW tensor on ``device`` -> numpy."""
    def wrapped(px: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(px)).permute(0, 3, 1, 2).to(device)
        with torch.no_grad():
            return fn(x.contiguous()).float().cpu().numpy()
    return wrapped


def run(cfg: Config, data: Data, *, step: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
        state: Callable[[int], Dict[str, Any]], load_state: Callable[[Dict[str, Any]], int],
        device, ckpt_dir: str, resume: Optional[str] = None, max_steps: Optional[int] = None,
        max_train_steps: int, on_step: Optional[Callable[[int], None]] = None,
        on_epoch: Optional[Callable[[int], List[str]]] = None,
        on_end: Optional[Callable[[], List[str]]] = None,
        monitor: Optional[Callable[[int, float, float], None]] = None,
        mesh=None, log: Callable[[str], None] = print) -> TrainResult:
    """Run ``step`` over the batches until ``max_train_steps`` (or
    ``max_steps``) steps are done. ``state(step)`` is the checkpoint dict,
    ``load_state(dict)`` restores one and returns its step; ``on_step``
    after each step, ``on_epoch(epoch)`` at the end of each epoch whose
    batches all ran and ``on_end()`` after the last step return the files
    they wrote; ``monitor(step, loss, images_per_second)`` after each step.
    A checkpoint is saved every ``checkpoint_every`` steps, on SIGTERM/SIGINT
    (then the run stops) and at the end. Under ``mesh`` the hooks, the log
    and the checkpoints run on rank 0 alone (module docstring)."""
    from sketch2img_torch.parallel.mesh import sync_global_devices

    lead = is_lead(mesh)

    def lead_only(fn, *args):
        out = fn(*args) if lead else None
        if mesh is not None:
            sync_global_devices()
        return out

    def save(at):
        return lead_only(lambda: save_train_state(ckpt_dir, at, state(at)))
    limit = max_train_steps if max_steps is None else min(max_train_steps, int(max_steps))
    global_step, start_epoch = 0, 0
    if resume:
        global_step = load_state(restore_train_state(resume))
        log(f"resumed at step {global_step} from {resume}")
        start_epoch = global_step // len(data)
        data.position.set_epoch(start_epoch)
        data.position.skip_batches(global_step % len(data))
    ckpt_every = int(cfg.get_path("checkpoint_every", 500))
    log_every = int(cfg.get_path("log_every", 50))
    if not lead:
        log = _quiet
    result = TrainResult(step=global_step, losses=[], step_seconds=[])
    with GracefulShutdown() as stop:
        for epoch in range(start_epoch, cfg.train_epochs):
            if global_step >= limit:
                break
            t_prev = time.perf_counter()
            for batch in data:
                loss = float(step(batch_to_device(batch, device)))  # reading it syncs
                global_step += 1
                t_now = time.perf_counter()
                result.losses.append(loss)
                result.step_seconds.append(t_now - t_prev)
                t_prev = t_now
                result.step = global_step
                if global_step % log_every == 0 or global_step == 1:
                    log(f"epoch {epoch + 1}/{cfg.train_epochs} step {global_step}/{limit}"
                        f" loss {loss:.5f} {cfg.batch_size / result.step_seconds[-1]:.2f} img/s")
                if monitor is not None and lead:
                    monitor(global_step, loss, cfg.batch_size / result.step_seconds[-1])
                if global_step % ckpt_every == 0:
                    result.checkpoint = save(global_step)
                if on_step is not None:
                    lead_only(on_step, global_step)
                if _stop_requested(stop, mesh, device):
                    log(f"signal {stop.signum}: saving state at step {global_step} to {ckpt_dir}")
                    result.checkpoint = save(global_step)
                    result.interrupted = True
                    return result
                if global_step >= limit:
                    break
            # an epoch that ``max_steps`` cut short is neither sampled nor exported
            if on_epoch is not None and global_step == (epoch + 1) * len(data):
                result.exports += lead_only(on_epoch, epoch) or []
    if on_end is not None:
        result.exports += lead_only(on_end) or []
    result.checkpoint = save(global_step)
    return result


def _quiet(msg: str) -> None:
    del msg


def _stop_requested(stop, mesh, device) -> bool:
    """Did a signal reach this rank, or under ``mesh`` any rank (one small
    all-reduce a step, so every rank stops after the same step)?"""
    if mesh is None or mesh.data_group is None:
        return stop.requested
    from sketch2img_torch.parallel.mesh import all_reduce_

    flag = torch.tensor([float(stop.requested)], device=device)
    return bool(all_reduce_(flag, None, torch.distributed.ReduceOp.MAX).item())
