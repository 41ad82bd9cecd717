"""UNet2DConditionModel with activation taps — counterpart of
``sketch2img_tpu/models/unet.py``.

Module tree and parameter names follow diffusers (``down_blocks.{i}.resnets``,
``...attentions.{j}.transformer_blocks.0.attn1.to_q``, ``mid_block``,
``up_blocks``, ``conv_norm_out``), so a diffusers SD1.x UNet state dict loads
with ``load_state_dict(strict=True)``. Layout is NCHW. ``capture_taps=True``
returns the nine tapped activations (fp32) in ``TAP_NAMES`` order, the LGP's
channel-concat order.

Rematerialisation (``UNetConfig.remat``, or ``forward(..., remat=True)``; the
JAX package's ``nn.remat``): while autograd records, every ResnetBlock and
SpatialTransformer runs under ``torch.utils.checkpoint`` (non-reentrant), so
the backward keeps only the blocks' inputs and runs each block's forward
again before its gradient — the kernels inside it (GroupNorm, the flash
forward) launch a second time. The taps are taken between blocks, outside
the recomputed regions, so recomputation never records a tap twice.

Attention injection (``UNetConfig.injection`` "clip" or "sketch", the
reference's SatMixin): each TransformerBlock gets an injection block between
its self- and cross-attention, fed one state per block through
``forward(..., injection_states=[...], injection_scale=s)`` in
``named_modules`` order (down, mid, up). The injection blocks live in
``unet.sat``, whose state dict is the reference's ``sketch_attn_model.pt``
layout (``sketch_attn_down_blocks_0_attentions_0_transformer_blocks_0.
sketch_norm.weight``...), so that file loads with
``unet.sat.load_state_dict(sd, strict=True)``; the rest of the state dict
is the diffusers UNet's. ``down_residuals`` is the reference's
SketchEncoder: the down half only, returning each block's residuals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sketch2img_torch.models.layers import (
    CrossAttention,
    Downsample,
    GEGLUFeedForward,
    GroupNorm,
    LayerNorm,
    ResnetBlock,
    Upsample,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attn: Tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    cross_attention_dim: int = 768
    freq_shift: float = 0.0
    # "none" | "sketch" (residual-KV) | "clip" (CLIP-token concat self-attn)
    injection: str = "none"
    injection_context_dim: int = 1024  # CLIP ViT-L/14 hidden (clip variant)
    # recompute the resnet/transformer activations in the backward
    remat: bool = False


SD15_CONFIG = UNetConfig()

# Channel-concat order of the LGP input (mid_res_0 runs before mid_attn but
# is concatenated after it: list order, not execution order).
TAP_NAMES = (
    "down_0", "down_1", "down_2",
    "mid_attn", "mid_res_0", "mid_res_1",
    "up_0", "up_1", "up_2",
)


class InjectionBlock(nn.Module):
    """One SatMixin block: ``sketch_norm`` (LayerNorm), ``sketch_attn``
    (diffusers CrossAttention), ``sketch_conv`` (a 1x1 Conv1d, applied as a
    channel Linear) and, for the clip variant, ``sketch_proj`` (CLIP hidden
    -> block width). ``forward`` returns x + scale * injection."""

    def __init__(self, dim: int, heads: int, variant: str, context_dim: int):
        super().__init__()
        if variant == "clip":
            self.sketch_proj = nn.Linear(context_dim, dim)
        self.sketch_norm = LayerNorm(dim)
        self.sketch_attn = CrossAttention(dim, heads, dim // heads)
        self.sketch_conv = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor, state: torch.Tensor, scale) -> torch.Tensor:
        state = state.to(x.dtype)
        if hasattr(self, "sketch_proj"):
            # self-attention over [hidden; projected CLIP tokens], keeping the
            # N hidden rows: only those rows are queried (rows are independent),
            # the two parts are normalised separately (LayerNorm is per row),
            # and the CLIP part is zero-padded to a multiple of 128 with
            # ``kv_len`` masking the pad (sketch2img_tpu/models/unet.py:115-141)
            proj = self.sketch_proj(state)
            hx = self.sketch_norm(x)
            hp = self.sketch_norm(proj)
            true_len = x.shape[1] + proj.shape[1]
            hp = F.pad(hp, (0, 0, 0, -proj.shape[1] % 128))
            s = self.sketch_attn(hx, context=torch.cat([hx, hp], dim=1), kv_len=true_len)
        else:  # keys and values from the sketch UNet's residual tokens
            s = self.sketch_attn(self.sketch_norm(x), context=state)
        s = F.linear(s, self.sketch_conv.weight[:, :, 0], self.sketch_conv.bias)
        return x + torch.as_tensor(scale, dtype=s.dtype, device=s.device) * s


class TransformerBlock(nn.Module):
    """BasicTransformerBlock: LN -> self-attn -> [injection] -> LN ->
    cross-attn -> LN -> FF. ``inj``: (InjectionBlock, state, scale) or None."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim // heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim // heads, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, inj=None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if inj is not None:
            block, state, scale = inj
            x = block(x, state, scale)
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN (eps 1e-6) -> 1x1 proj_in -> blocks -> 1x1 proj_out -> + x.
    ``inj`` goes to the first block (the one SatMixin names)."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(channels, heads, context_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor, inj=None) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for d, block in enumerate(self.transformer_blocks):
            h = block(h, context, inj if d == 0 else None)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, layers: int, cross: bool,
                 heads: int, context_dim: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, temb_ch) for j in range(layers)])
        if cross:
            self.attentions = nn.ModuleList(
                [SpatialTransformer(out_ch, heads, context_dim) for _ in range(layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample(out_ch)])


class _UpBlock(nn.Module):
    def __init__(self, prev_ch: int, out_ch: int, skip_chs: List[int], temb_ch: int,
                 cross: bool, heads: int, context_dim: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock((prev_ch if j == 0 else out_ch) + s, out_ch, temb_ch)
             for j, s in enumerate(skip_chs)])
        if cross:
            self.attentions = nn.ModuleList(
                [SpatialTransformer(out_ch, heads, context_dim) for _ in skip_chs])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])


class _MidBlock(nn.Module):
    def __init__(self, ch: int, temb_ch: int, heads: int, context_dim: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, temb_ch), ResnetBlock(ch, ch, temb_ch)])
        self.attentions = nn.ModuleList([SpatialTransformer(ch, heads, context_dim)])


class UNet2DCondition(nn.Module):
    """SD1.x conditional UNet: ``forward(sample, timesteps, context)`` -> eps
    (fp32, NCHW), or (eps, taps) with ``capture_taps=True``."""

    def __init__(self, config: UNetConfig = SD15_CONFIG):
        super().__init__()
        if config.injection not in ("none", "clip", "sketch"):
            raise ValueError(f"unknown injection variant {config.injection!r}")
        self.config = cfg = config
        c0 = cfg.block_out_channels[0]
        temb_ch = c0 * 4
        n = len(cfg.block_out_channels)
        heads, ctx_dim, layers = cfg.num_heads, cfg.cross_attention_dim, cfg.layers_per_block

        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = nn.ModuleDict({
            "linear_1": nn.Linear(c0, temb_ch),
            "linear_2": nn.Linear(temb_ch, temb_ch),
        })
        self.down_blocks = nn.ModuleList()
        skips = [c0]  # channels pushed on the residual stack, in order
        ch = c0
        for i, oc in enumerate(cfg.block_out_channels):
            self.down_blocks.append(_DownBlock(ch, oc, temb_ch, layers, cfg.cross_attn[i],
                                               heads, ctx_dim, add_downsample=i < n - 1))
            skips += [oc] * (layers + (1 if i < n - 1 else 0))
            ch = oc
        self.mid_block = _MidBlock(ch, temb_ch, heads, ctx_dim)
        self.up_blocks = nn.ModuleList()
        for i, oc in enumerate(reversed(cfg.block_out_channels)):
            popped = [skips.pop() for _ in range(layers + 1)]
            self.up_blocks.append(_UpBlock(ch, oc, popped, temb_ch,
                                           tuple(reversed(cfg.cross_attn))[i], heads, ctx_dim,
                                           add_upsample=i < n - 1))
            ch = oc
        self.conv_norm_out = GroupNorm(32, c0, eps=1e-5)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)
        if cfg.injection != "none":
            self.sat = make_sat(cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def _stem(self, sample, timesteps, context):
        dt = self.dtype
        temb = timestep_embedding(timesteps, self.config.block_out_channels[0],
                                  downscale_freq_shift=self.config.freq_shift).to(dt)
        temb = self.time_embedding["linear_2"](F.silu(self.time_embedding["linear_1"](temb)))
        return self.conv_in(sample.to(dt)), temb, context.to(dt)

    def _injections(self, states: Optional[Sequence[torch.Tensor]], scale):
        """One (InjectionBlock, state, scale) or None per TransformerBlock,
        in injection_states order."""
        n = num_transformer_blocks(self.config)
        if states is None or self.config.injection == "none":
            return iter([None] * n)
        if len(states) != n:
            raise ValueError(f"got {len(states)} injection states for {n} transformer blocks")
        blocks = [getattr(self.sat, sat_name(p)) for p, _ in injection_sites(self.config)]
        return iter([(blk, st, scale) for blk, st in zip(blocks, states)])

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                *, capture_taps: bool = False,
                injection_states: Optional[Sequence[torch.Tensor]] = None,
                injection_scale=1.0, remat: Optional[bool] = None):
        """``injection_states``: one (B, S, C) tensor per TransformerBlock
        (the clip variant shares one CLIP state across all); None runs no
        injection. ``injection_scale``: a float or a (B, 1, 1) tensor.
        ``remat``: recompute the blocks in the backward (None: the config's
        ``remat``); it acts only while autograd records."""
        h, temb, context = self._stem(sample, timesteps, context)
        inj = self._injections(injection_states, injection_scale)
        taps: Dict[str, torch.Tensor] = {}
        remat = self.config.remat if remat is None else remat
        if remat and torch.is_grad_enabled():
            def run(block, *args):
                return checkpoint(block, *args, use_reentrant=False)
        else:
            def run(block, *args):
                return block(*args)

        stack = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = run(resnet, h, temb)
                if hasattr(blk, "attentions"):
                    h = run(blk.attentions[j], h, context, next(inj))
                stack.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                stack.append(h)
            if capture_taps and i < 3:
                taps[f"down_{i}"] = h.float()

        mid = self.mid_block
        h = run(mid.resnets[0], h, temb)
        if capture_taps:
            taps["mid_res_0"] = h.float()
        h = run(mid.attentions[0], h, context, next(inj))
        if capture_taps:
            taps["mid_attn"] = h.float()
        h = run(mid.resnets[1], h, temb)
        if capture_taps:
            taps["mid_res_1"] = h.float()

        for i, blk in enumerate(self.up_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = run(resnet, torch.cat([h, stack.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = run(blk.attentions[j], h, context, next(inj))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
            if capture_taps and i < 3:
                taps[f"up_{i}"] = h.float()

        eps = self.conv_out(self.conv_norm_out(h, silu=True)).float()
        if capture_taps:
            return eps, taps
        return eps

    def down_residuals(self, sample: torch.Tensor, timesteps: torch.Tensor,
                       context: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        """Down half only (the reference's SketchEncoder): one tuple per down
        block of its resnet(+transformer) outputs and, where there is one,
        the downsampler's output. No injection."""
        h, temb, context = self._stem(sample, timesteps, context)
        out: List[Tuple[torch.Tensor, ...]] = []
        for blk in self.down_blocks:
            res: Tuple[torch.Tensor, ...] = ()
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context)
                res += (h,)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                res += (h,)
            out.append(res)
        return out


def injection_sites(config: UNetConfig) -> List[Tuple[str, int]]:
    """(module path of each TransformerBlock, its width) in ``named_modules``
    order: down blocks, mid, up blocks."""
    L = config.layers_per_block
    sites = []
    for i, (ch, ca) in enumerate(zip(config.block_out_channels, config.cross_attn)):
        if ca:
            sites += [(f"down_blocks.{i}.attentions.{j}.transformer_blocks.0", ch)
                      for j in range(L)]
    sites.append(("mid_block.attentions.0.transformer_blocks.0", config.block_out_channels[-1]))
    rev = zip(reversed(config.block_out_channels), reversed(config.cross_attn))
    for i, (ch, ca) in enumerate(rev):
        if ca:
            sites += [(f"up_blocks.{i}.attentions.{j}.transformer_blocks.0", ch)
                      for j in range(L + 1)]
    return sites


def make_sat(config: UNetConfig) -> nn.Module:
    """The injection blocks of an injected UNet, named as the reference's
    SatMixin names them (its state dict is ``sketch_attn_model.pt``'s)."""
    sat = nn.Module()
    for path, dim in injection_sites(config):
        sat.add_module(sat_name(path), InjectionBlock(dim, config.num_heads, config.injection,
                                                      config.injection_context_dim))
    return sat


def sat_name(path: str) -> str:
    """The reference's SatMixin module name for a TransformerBlock path."""
    return ("sketch_attn." + path).replace(".", "_")


def num_transformer_blocks(config: UNetConfig) -> int:
    """Count of TransformerBlocks in injection_states order."""
    return len(injection_sites(config))


def transformer_block_dims(config: UNetConfig) -> List[int]:
    """Per-TransformerBlock channel widths in injection_states order."""
    return [dim for _, dim in injection_sites(config)]


def concat_taps(taps: Dict[str, torch.Tensor], height: int, width: int) -> torch.Tensor:
    """Bilinear-resize the nine taps to (height, width) and concat channels in
    TAP_NAMES order (9280 channels for SD1.5)."""
    from sketch2img_torch.ops.resize import resize_bilinear

    pieces = []
    for name in TAP_NAMES:
        t = taps[name]
        if t.shape[2] != height or t.shape[3] != width:
            t = resize_bilinear(t, height, width)
        pieces.append(t)
    return torch.cat(pieces, dim=1)


def tap_channels(config: UNetConfig) -> int:
    """Channel count of ``concat_taps`` for a UNet config."""
    c = list(config.block_out_channels)
    rev = c[::-1]
    return c[0] + c[1] + c[2] + 3 * c[-1] + rev[0] + rev[1] + rev[2]
