"""Sketch-guided sampling — counterpart of
``sketch2img_tpu/pipelines/sketch_guided.py``.

Each of the first ``num_guided_steps`` steps runs the uncond UNet forward
without gradient, the cond forward with the nine taps, the LGP head, and the
gradient of the LGP's MSE against the sketch latent with respect to the
latent (a backward pass through the whole UNet, cond half only). The latent
is then nudged by alpha * (-grad) with the per-image step size
alpha = sqrt(2) * ||x - x_prev|| / max(||grad||, 1e-20) * beta. The
remaining steps are plain CFG steps at batch 2B.

``remat=True`` runs the cond forward with the UNet's blocks recomputed in
the backward (``UNetConfig.remat``): the same eps and gradient, less memory.
Every image's update depends on its own loss term alone (the per-image
alpha is invariant to the loss's scale), so a data-parallel shard of the
batch takes the update the whole batch would give it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from sketch2img_torch.core.schedulers import (
    DiffusionSchedule,
    get_noise_level,
    make_sampler_step,
)
from sketch2img_torch.models.lgp import lgp_fused_apply
from sketch2img_torch.pipelines.text2img import cfg_combine, emit_callback


def num_guided_steps(num_steps: int) -> int:
    """i <= 0.5 * num_steps, inclusive."""
    return int(math.floor(0.5 * num_steps)) + 1


def _per_image_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v.float() ** 2, dim=(1, 2, 3), keepdim=True))


def guided_step(unet, lgp, schedule: DiffusionSchedule, sampler_step, i: int, t: int,
                x: torch.Tensor, x0_prev: torch.Tensor, noise0: torch.Tensor,
                context_uncond: torch.Tensor, context_cond: torch.Tensor,
                sketch_latent: torch.Tensor, guidance_scale: float, beta: float = 1.6,
                remat: bool = False):
    """One guided step. Returns (x_next, x0)."""
    b, _, h, w = x.shape
    tt = torch.full((b,), t, dtype=torch.long, device=x.device)
    with torch.no_grad():
        eps_u = unet(x, tt, context_uncond)
    with torch.enable_grad():
        xc = x.detach().requires_grad_(True)
        eps_t, taps = unet(xc, tt, context_cond, capture_taps=True, remat=remat)
        out = lgp_fused_apply(lgp, taps, get_noise_level(schedule, noise0, tt), h, w)
        loss = torch.mean((sketch_latent.float() - out.float()) ** 2)
        (g,) = torch.autograd.grad(loss, xc)

    eps = cfg_combine(torch.cat([eps_u, eps_t.detach()]), guidance_scale)
    x_prev, x0 = sampler_step(i, x, eps, x0_prev)
    cond_grad = -g
    num = math.sqrt(2.0) * _per_image_norm(x - x_prev)
    alpha = num / torch.clamp(_per_image_norm(cond_grad), min=1e-20) * beta
    return x_prev + (alpha * cond_grad.float()).to(x_prev.dtype), x0


def plain_step(unet, sampler_step, i: int, t: int, x: torch.Tensor, x0_prev: torch.Tensor,
               context_uncond: torch.Tensor, context_cond: torch.Tensor,
               guidance_scale: float):
    """One CFG step at batch 2B. Returns (x_next, x0)."""
    tt = torch.full((2 * x.shape[0],), t, dtype=torch.long, device=x.device)
    with torch.no_grad():
        eps = cfg_combine(unet(torch.cat([x, x]), tt,
                               torch.cat([context_uncond, context_cond])), guidance_scale)
    return sampler_step(i, x, eps, x0_prev)


def sample_sketch_guided(unet, lgp, schedule: DiffusionSchedule, num_steps: int,
                         latents0: torch.Tensor, context_uncond: torch.Tensor,
                         context_cond: torch.Tensor, sketch_latent: torch.Tensor,
                         guidance_scale: float, *, beta: float = 1.6, solver: str = "dpm++",
                         callback: Optional[Callable] = None,
                         callback_steps: int = 1, remat: bool = False) -> torch.Tensor:
    """(B, 4, h, w) initial noise -> final latents. ``latents0`` is also the
    noise the LGP's noise-level feature is computed from; ``sketch_latent``
    is the VAE-encoded sketch x0.18215, (B, 4, h, w)."""
    ts, sampler_step = make_sampler_step(solver, schedule, num_steps)
    n_guided = num_guided_steps(num_steps)
    x, x0_prev = latents0, torch.zeros_like(latents0)
    for i, t in enumerate(ts):
        if i < n_guided:
            x, x0_prev = guided_step(unet, lgp, schedule, sampler_step, i, int(t), x, x0_prev,
                                     latents0, context_uncond, context_cond, sketch_latent,
                                     guidance_scale, beta, remat)
        else:
            x, x0_prev = plain_step(unet, sampler_step, i, int(t), x, x0_prev,
                                    context_uncond, context_cond, guidance_scale)
        emit_callback(callback, callback_steps, i, int(t), x)
    return x
