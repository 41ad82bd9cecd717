"""Shared Stable-Diffusion building blocks — counterpart of
``sketch2img_tpu/models/layers.py``, in NCHW with diffusers parameter names.

GroupNorm and LayerNorm compute their statistics in fp32 whatever the
parameter dtype and return the input dtype. Every GroupNorm, and the SiLU
that follows it where there is one, goes through ``ops.groupnorm`` (the
fused GroupNorm+SiLU kernel on a CUDA tensor, its plain version on a CPU
one), so its input must be contiguous NCHW. The TPU-specific conv lowerings
of the JAX package (``ops/conv2d.py``, ``ops/subpixel.py``, ``Conv1x1``) are
plain ``nn.Conv2d`` here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sketch2img_torch.ops import groupnorm as gn
from sketch2img_torch.ops.attention import multi_head_attention


def timestep_embedding(timesteps: torch.Tensor, dim: int, *, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, SD1.x convention. (B,) -> (B, dim) fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics; output in the input dtype.
    ``silu=True`` applies SiLU in fp32 before the cast (one fused pass). A
    channels-last input (a 1x1 conv over permuted tokens may return one) is
    copied to contiguous NCHW first, the layout the kernel takes."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return gn.group_norm_silu(x.contiguous(), self.weight, self.bias, self.num_groups,
                                  self.eps, silu)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv3x3 [-> + time_emb] -> GN -> SiLU -> conv3x3 -> + skip
    (diffusers ResnetBlock2D; eps 1e-5 in the UNet, 1e-6 in the VAE; 1x1
    ``conv_shortcut`` when the channel count changes)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int] = None,
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """conv3x3 stride 2: symmetric pad 1 in the UNet, (0, 1) in the VAE encoder."""

    def __init__(self, channels: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x, then conv3x3 (diffusers Upsample2D with use_conv=True)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    """q from hidden states, k/v from ``context`` (or the hidden states):
    ``to_q``/``to_k``/``to_v`` without bias, ``to_out.0`` with bias.

    ``tp_size`` > 1 (set by ``parallel.shard_params_tp``, which slices the
    projections to this rank's heads): the inputs pass ``copy_to_model``,
    ``to_out`` runs its product without the bias, the partial sums are
    all-reduced over the model group (``reduce_from_model``) and the bias
    is added once."""

    tp_size = 1

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, kv_len: Optional[int] = None) -> torch.Tensor:
        if self.tp_size > 1:
            from sketch2img_torch.ops.attention import tensor_parallel_group
            from sketch2img_torch.parallel.tp import copy_to_model, reduce_from_model

            group = tensor_parallel_group(self.tp_size)
            x = copy_to_model(x, group)
            if context is not None:
                context = copy_to_model(context, group)
        ctx = x if context is None else context
        out = multi_head_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads,
                                   mask=mask, kv_len=kv_len)
        if self.tp_size > 1:
            proj = self.to_out[0]
            return reduce_from_model(F.linear(out, proj.weight), group) + proj.bias
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """proj -> x * gelu(gate): exact erf gelu for fp32 weights, the tanh
    approximation under bf16 (PARITY.md deviation 6 of the JAX package)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        approx = "tanh" if self.proj.weight.dtype == torch.bfloat16 else "none"
        return h * F.gelu(gate, approximate=approx)


class GEGLUFeedForward(nn.Module):
    """Transformer feed-forward with diffusers names ``net.0.proj`` / ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))
