"""Optimizers and LR schedules — counterpart of ``sketch2img_tpu/train/optim.py``.

The optimizer is chosen by name, as in ``train.yaml``'s ``optimizer.name``:
``adamw`` (and the reference's class path ``bitsandbytes.optim.AdamW8bit``,
which the JAX package maps to plain AdamW) is ``torch.optim.AdamW`` with
every parameter decayed; ``adamw8bit`` keeps both Adam moments as int8 in
the JAX package's quadratic signed code, one fp32 absmax per block of 2048
elements (``quantize_blockwise``).

A schedule is read once per step, at the step count the JAX package reads
it: optax's ``adamw`` at the count *before* the update (so a warm-up's
first step has LR 0), the JAX package's ``adamw8bit`` at the count *after*
it. Each optimizer keeps its count in its parameter group (``count``), so
it is in ``state_dict()`` and a restored optimizer resumes the schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple, Union

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


def make_lr_schedule(name: str, base_lr: float, num_warmup_steps: int,
                     num_training_steps: int, num_cycles: int = 1) -> Schedule:
    """Linear warm-up from 0, then constant ("constant_with_warmup") or the
    JAX package's cosine with hard restarts ("cosine_with_restarts"), whose
    second segment sees ``step - num_warmup_steps`` (optax.join_schedules)."""
    warm = max(1, num_warmup_steps)

    def warmup(step: int) -> float:
        return base_lr * min(max(step, 0), warm) / warm

    if name == "constant_with_warmup":
        def after(step: int) -> float:
            return base_lr
    elif name == "cosine_with_restarts":
        span = max(1, num_training_steps - num_warmup_steps)

        def after(step: int) -> float:
            progress = min(max(step / span, 0.0), 1.0)
            if progress >= 1.0:
                return 0.0
            frac = math.fmod(num_cycles * progress, 1.0)
            return base_lr * max(0.0, 0.5 * (1.0 + math.cos(2.0 * math.pi * frac)))
    else:
        raise ValueError(f"unknown lr schedule: {name}")

    def schedule(step: int) -> float:
        step = int(step)
        return warmup(step) if step < num_warmup_steps else after(step - num_warmup_steps)

    return schedule


class _Scheduled:
    """Sets each group's ``lr`` from ``schedule`` before an update, read at
    the group's count before (``read_after=False``) or after the increment."""

    read_after = False

    def _init_schedule(self, schedule: LearningRate) -> None:
        self.schedule = schedule
        for g in self.param_groups:
            g.setdefault("count", 0)

    def _advance(self) -> None:
        for g in self.param_groups:
            read = g["count"] + 1 if self.read_after else g["count"]
            if callable(self.schedule):
                g["lr"] = float(self.schedule(read))
            g["count"] += 1


class AdamW(_Scheduled, torch.optim.AdamW):
    """``torch.optim.AdamW`` (decoupled weight decay on every parameter,
    optax.adamw's update) with a schedule read as optax reads it."""

    def __init__(self, params, learning_rate: LearningRate, weight_decay: float = 1e-2,
                 eps: float = 1e-8, b1: float = 0.9, b2: float = 0.999):
        lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
        super().__init__(params, lr=float(lr0), betas=(b1, b2), eps=eps,
                         weight_decay=weight_decay)
        self._init_schedule(learning_rate)

    @torch.no_grad()
    def step(self, closure=None):
        self._advance()
        return super().step(closure)


def quantize_blockwise(x: torch.Tensor, block_size: int = 2048
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (int8 codes (n_blocks, block_size), fp32 absmax (n_blocks, 1)):
    code = round(sign(x) sqrt(|x| / absmax) 127), the flat tensor zero-padded
    to whole blocks (the JAX package's ``_blockwise_quantize``)."""
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block_size))
    blocks = flat.view(-1, block_size)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    m = torch.sqrt(blocks.abs() / safe)
    q = torch.clamp(torch.round(torch.sign(blocks) * m * 127.0), -127, 127)
    return q.to(torch.int8), absmax


def dequantize_blockwise(q: torch.Tensor, absmax: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``quantize_blockwise``: sign(q) (|q| / 127)^2 absmax."""
    qf = q.float()
    m = (qf.abs() / 127.0) ** 2
    flat = (torch.sign(qf) * m * absmax).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


class AdamW8bit(_Scheduled, torch.optim.Optimizer):
    """AdamW with both moments stored as int8 blocks (``quantize_blockwise``):
    each step dequantises, runs fp32 AdamW, and requantises — the JAX
    package's ``_quantized_adamw``, term for term, with its schedule read at
    the count after the increment. Every parameter is decayed."""

    read_after = True

    def __init__(self, params, learning_rate: LearningRate, weight_decay: float = 1e-2,
                 eps: float = 1e-8, b1: float = 0.9, b2: float = 0.999,
                 block_size: int = 2048):
        lr0 = learning_rate(1) if callable(learning_rate) else learning_rate
        super().__init__(params, dict(lr=float(lr0), weight_decay=weight_decay, eps=eps,
                                      b1=b1, b2=b2, block_size=block_size))
        self._init_schedule(learning_rate)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._advance()
        for g in self.param_groups:
            count, lr, bs = g["count"], g["lr"], g["block_size"]
            b1, b2, eps, wd = g["b1"], g["b2"], g["eps"], g["weight_decay"]
            # the bias corrections in fp32, as the JAX package computes them:
            # where a moment dequantises to ~0 the update divides by ~eps,
            # so their rounding shows in the parameters
            c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
            for p in g["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    zq, zs = quantize_blockwise(torch.zeros_like(p, dtype=torch.float32), bs)
                    st.update(mu_q=zq, mu_scale=zs, nu_q=zq.clone(), nu_scale=zs.clone())
                g32 = p.grad.float()
                mu = dequantize_blockwise(st["mu_q"], st["mu_scale"], p.shape)
                nu = dequantize_blockwise(st["nu_q"], st["nu_scale"], p.shape)
                mu = b1 * mu + (1 - b1) * g32
                nu = b2 * nu + (1 - b2) * g32 * g32
                upd = mu / c1 / (torch.sqrt(nu / c2) + eps)
                p.add_((-lr * (upd + wd * p.float())).to(p.dtype))
                st["mu_q"], st["mu_scale"] = quantize_blockwise(mu, bs)
                st["nu_q"], st["nu_scale"] = quantize_blockwise(nu, bs)
        return loss


_REGISTRY: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "adamw": AdamW,
    "bitsandbytes.optim.AdamW8bit": AdamW,  # the reference's config string
    "adamw8bit": AdamW8bit,
}


def make_optimizer(name: str, params: Iterable, learning_rate: LearningRate,
                   **kwargs) -> torch.optim.Optimizer:
    """The optimizer registered under ``name`` (case-insensitive after an
    exact match) over ``params``; ``kwargs`` are ``weight_decay``, ``eps``,
    ``b1``, ``b2`` (and ``block_size`` for adamw8bit)."""
    key = name if name in _REGISTRY else name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](params, learning_rate, **kwargs)
