"""AutoencoderKL, the SD1.x VAE — counterpart of ``sketch2img_tpu/models/vae.py``.

NCHW with diffusers parameter names (``encoder.down_blocks.{i}.resnets``,
``encoder.mid_block.attentions.0.query``, ``quant_conv``...). The mid
attention keeps the ``query/key/value/proj_attn`` names of the SD1.x
checkpoints; ``runtime.SDComponents.from_diffusers_dir`` renames the newer
``to_q/to_k/to_v/to_out.0`` layout on load. Scaling (x0.18215) lives with
the callers, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from sketch2img_torch.models.layers import Downsample, GroupNorm, ResnetBlock, Upsample
from sketch2img_torch.ops.attention import multi_head_attention

SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2


SD15_VAE_CONFIG = VAEConfig()


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(32, channels, eps=1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = multi_head_attention(self.query(y), self.key(y), self.value(y), num_heads=1)
        y = self.proj_attn(y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, None, eps=1e-6),
                                      ResnetBlock(ch, ch, None, eps=1e-6)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Block(nn.Module):
    """Resnets plus an optional resampler (``downsamplers`` / ``upsamplers``)."""

    def __init__(self, in_ch: int, out_ch: int, n: int, resample: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, None, eps=1e-6) for j in range(n)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample(out_ch, asymmetric=True)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [_Block(chs[max(i - 1, 0)], ch, cfg.layers_per_block,
                    "down" if i < len(chs) - 1 else "") for i, ch in enumerate(chs)])
        self.mid_block = _MidBlock(chs[-1])
        self.conv_norm_out = GroupNorm(32, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            [_Block(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                    "up" if i < len(rev) - 1 else "") for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """``encode`` -> (mean, logvar) of a diagonal Gaussian; ``decode`` from
    UNSCALED latents. Inputs are cast to the parameters' dtype; outputs are
    fp32."""

    def __init__(self, config: VAEConfig = SD15_VAE_CONFIG):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4, H/8, W/8)."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype))).float()
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, 4, h, w) unscaled latents -> (B, 3, 8h, 8w) in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z.to(self.dtype))).float()


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """latent_dist.sample() * 0.18215."""
    return (mean + torch.exp(0.5 * logvar) * noise) * SCALING_FACTOR
