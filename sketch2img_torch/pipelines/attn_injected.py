"""Attention-injection conditioned sampling (the CLIP-variant demo path) —
counterpart of ``sketch2img_tpu/pipelines/attn_injected.py``.

The UNet is built with ``UNetConfig(injection="clip")``; the CFG pair's
injection state is [zeros; CLIP hidden] and the injection strength is the
UI slider, a scalar or one value per image. Every step runs one UNet forward
at batch 2B through DPM-Solver++ or DDIM.
"""

from __future__ import annotations

from typing import Union

import torch

from sketch2img_torch.core.schedulers import DiffusionSchedule, make_sampler_step
from sketch2img_torch.models.unet import num_transformer_blocks
from sketch2img_torch.pipelines.text2img import cfg_combine


def cfg_injection_state(clip_hidden: torch.Tensor) -> torch.Tensor:
    """[zeros_like(h); h] over the CFG batch: (B, S, D) -> (2B, S, D)."""
    return torch.cat([torch.zeros_like(clip_hidden), clip_hidden], dim=0)


def pair_scale(injection_scale: Union[float, torch.Tensor], batch: int,
               device) -> torch.Tensor:
    """A scalar or (B,) strengths -> (2B, 1, 1) fp32, tiled over the CFG pair."""
    sc = torch.as_tensor(injection_scale, dtype=torch.float32, device=device)
    sc = sc.expand(batch) if sc.dim() == 0 else sc
    if sc.shape != (batch,):
        raise ValueError(f"injection scale of shape {tuple(sc.shape)} for a batch of {batch}")
    return torch.cat([sc, sc])[:, None, None]


@torch.no_grad()
def sample_attn_injected(unet, schedule: DiffusionSchedule, num_steps: int,
                         latents0: torch.Tensor, context_pair: torch.Tensor,
                         injection_state: torch.Tensor,
                         injection_scale: Union[float, torch.Tensor],
                         guidance_scale: float, *, solver: str = "dpm++") -> torch.Tensor:
    """Denoise (B, 4, h, w) initial noise. ``context_pair``: (2B, n, 768)
    [uncond; cond]; ``injection_state``: (2B, S, D), shared by every
    TransformerBlock; ``injection_scale``: a float or (B,) strengths."""
    ts, sampler_step = make_sampler_step(solver, schedule, num_steps)
    b = latents0.shape[0]
    states = [injection_state] * num_transformer_blocks(unet.config)
    scale = pair_scale(injection_scale, b, latents0.device)
    x, x0_prev = latents0, torch.zeros_like(latents0)
    for i, t in enumerate(ts):
        tt = torch.full((2 * b,), int(t), dtype=torch.long, device=x.device)
        eps_pair = unet(torch.cat([x, x]), tt, context_pair, injection_states=states,
                        injection_scale=scale)
        x, x0_prev = sampler_step(i, x, cfg_combine(eps_pair, guidance_scale), x0_prev)
    return x
