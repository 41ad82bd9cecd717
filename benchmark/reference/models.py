"""Plain float32 reference of every model the benchmark's cells run: the
SD1.5 UNet (with the nine LGP taps and the CLIP-variant injection blocks),
the VAE, the CLIP text and vision towers, the safety checker, the Latent
Edge Predictor and the anime2sketch generator.

Why it is here: the benchmark decides ``correct`` by holding what the port
produced against these modules, so they must not move when the port does.
They are written from the published architectures (diffusers'
``UNet2DConditionModel`` / ``AutoencoderKL``, transformers' CLIP towers,
diffusers' ``StableDiffusionSafetyChecker``, Mikubill/sketch2img's LGP,
Mukosame/Anime2Sketch's generator) in plain ``torch``: no kernel, no
``sketch2img_torch`` import, attention as matmul-softmax-matmul, every norm
in fp32. Parameter names are the diffusers / transformers / published
checkpoint names, so one state dict loads into the port and here.

Departures from the published models, each also made by the port:
- the UNet's GEGLU uses the exact erf GELU (diffusers' choice); the port
  uses the tanh form under bf16, an error the comparison carries;
- the LGP's train-mode BatchNorm feeds the biased batch variance into its
  running variance (flax's rule, which the JAX package and the port keep).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# Channel-concat order of the LGP input (the published predictor's order).
TAP_NAMES = ("down_0", "down_1", "down_2", "mid_attn", "mid_res_0", "mid_res_1",
             "up_0", "up_1", "up_2")


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Nq, H*d) x (B, Nk, H*d) -> (B, Nq, H*d): softmax(q k^T / sqrt(d)) v."""
    b, nq, c = q.shape
    d = c // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, d).transpose(1, 2)

    logits = split(q) @ split(k).transpose(-1, -2) * d ** -0.5
    if mask is not None:
        logits = logits + mask
    out = torch.softmax(logits, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(b, nq, c)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """SD1.x sinusoidal embedding (flip_sin_to_cos, shift 0): (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                       device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric else x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        return self.to_out[0](attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                        self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


class InjectionBlock(nn.Module):
    """The CLIP-variant injection block of ``sketch_attn_model.pt``: self-
    attention over [hidden; projected CLIP tokens], the hidden rows kept,
    then a 1x1 Conv1d, added at ``scale``."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.sketch_proj = nn.Linear(context_dim, dim)
        self.sketch_norm = nn.LayerNorm(dim)
        self.sketch_attn = CrossAttention(dim, heads)
        self.sketch_conv = nn.Conv1d(dim, dim, 1)

    def forward(self, x, state, scale):
        hx = self.sketch_norm(x)
        hp = self.sketch_norm(self.sketch_proj(state))
        s = self.sketch_attn(hx, context=torch.cat([hx, hp], dim=1))
        s = self.sketch_conv(s.transpose(1, 2)).transpose(1, 2)
        return x + scale * s


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, inj=None):
        x = x + self.attn1(self.norm1(x))
        if inj is not None:
            block, state, scale = inj
            x = block(x, state, scale)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, context_dim: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads, context_dim)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, context, inj=None):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y, context, inj)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class UNet(nn.Module):
    """diffusers ``UNet2DConditionModel`` at the SD1.x layout (CrossAttn down
    x3 + Down, mid, Up + CrossAttn up x3, layers_per_block 2). ``injection``
    adds the CLIP-variant blocks under ``sat``, one per TransformerBlock."""

    def __init__(self, channels: Sequence[int], heads: int, context_dim: int,
                 in_channels: int = 4, injection_dim: Optional[int] = None):
        super().__init__()
        self.channels = tuple(channels)
        c0, n, L = channels[0], len(channels), 2
        cross = [True] * (n - 1) + [False]
        temb = 4 * c0
        self.conv_in = nn.Conv2d(in_channels, c0, 3, padding=1)
        self.time_embedding = nn.ModuleDict({"linear_1": nn.Linear(c0, temb),
                                             "linear_2": nn.Linear(temb, temb)})
        self.down_blocks = nn.ModuleList()
        skips, ch = [c0], c0
        for i, oc in enumerate(channels):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock(ch if j == 0 else oc, oc, temb, 1e-5)
                                         for j in range(L)])
            if cross[i]:
                blk.attentions = nn.ModuleList([SpatialTransformer(oc, heads, context_dim)
                                                for _ in range(L)])
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample(oc)])
            self.down_blocks.append(blk)
            skips += [oc] * (L + (1 if i < n - 1 else 0))
            ch = oc
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock(ch, ch, temb, 1e-5)
                                                for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([SpatialTransformer(ch, heads, context_dim)])
        self.up_blocks = nn.ModuleList()
        for i, oc in enumerate(reversed(channels)):
            popped = [skips.pop() for _ in range(L + 1)]
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock((ch if j == 0 else oc) + s, oc, temb, 1e-5)
                                         for j, s in enumerate(popped)])
            if cross[::-1][i]:
                blk.attentions = nn.ModuleList([SpatialTransformer(oc, heads, context_dim)
                                                for _ in popped])
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(oc)])
            self.up_blocks.append(blk)
            ch = oc
        self.conv_norm_out = nn.GroupNorm(32, c0, eps=1e-5)
        self.conv_out = nn.Conv2d(c0, 4, 3, padding=1)
        if injection_dim is not None:
            self.sat = nn.Module()
            for path, dim in self.transformer_sites():
                name = ("sketch_attn." + path).replace(".", "_")
                self.sat.add_module(name, InjectionBlock(dim, heads, injection_dim))

    def transformer_sites(self) -> List[Tuple[str, int]]:
        """(path, width) of every TransformerBlock: down, mid, up."""
        sites = []
        for i, blk in enumerate(self.down_blocks):
            if hasattr(blk, "attentions"):
                sites += [(f"down_blocks.{i}.attentions.{j}.transformer_blocks.0",
                           self.channels[i]) for j in range(len(blk.attentions))]
        sites.append(("mid_block.attentions.0.transformer_blocks.0", self.channels[-1]))
        for i, blk in enumerate(self.up_blocks):
            if hasattr(blk, "attentions"):
                sites += [(f"up_blocks.{i}.attentions.{j}.transformer_blocks.0",
                           self.channels[::-1][i]) for j in range(len(blk.attentions))]
        return sites

    def forward(self, x, t, context, *, taps: bool = False, injection=None, scale=None):
        """-> eps, or (eps, {tap: fp32 map}) with ``taps``. ``injection``: one
        (B, S, D) CLIP state shared by every block, at ``scale`` (B, 1, 1)."""
        temb = timestep_embedding(t, self.channels[0])
        temb = self.time_embedding["linear_2"](F.silu(self.time_embedding["linear_1"](temb)))
        blocks = iter([None] * 16)
        if injection is not None:
            blocks = iter([(getattr(self.sat, ("sketch_attn." + p).replace(".", "_")),
                            injection, scale) for p, _ in self.transformer_sites()])
        out: Dict[str, torch.Tensor] = {}
        h = self.conv_in(x)
        stack = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context, next(blocks))
                stack.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                stack.append(h)
            if i < 3:
                out[f"down_{i}"] = h
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        out["mid_res_0"] = h
        h = mid.attentions[0](h, context, next(blocks))
        out["mid_attn"] = h
        h = mid.resnets[1](h, temb)
        out["mid_res_1"] = h
        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, stack.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context, next(blocks))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
            if i < 3:
                out[f"up_{i}"] = h
        eps = self.conv_out(F.silu(self.conv_norm_out(h)))
        return (eps, out) if taps else eps


def tap_channels(channels: Sequence[int]) -> int:
    c = list(channels)
    return c[0] + c[1] + c[2] + 3 * c[-1] + c[-1] + c[-2] + c[-3]


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


class VAEAttention(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_attn(attention(self.query(y), self.key(y), self.value(y), 1))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _vae_mid(ch: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, None, 1e-6) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(ch)])
    return mid


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class VAE(nn.Module):
    """diffusers ``AutoencoderKL`` (SD1.x names, mid attention as
    query/key/value/proj_attn). ``encode`` -> (mean, logvar clamped to
    [-30, 20]); ``decode`` takes unscaled latents."""

    def __init__(self, channels: Sequence[int], layers: int = 2, latent: int = 4):
        super().__init__()
        chs, rev = list(channels), list(reversed(channels))
        enc = self.encoder = nn.Module()
        enc.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock(chs[max(i - 1, 0)] if j == 0 else ch, ch,
                                                     None, 1e-6) for j in range(layers)])
            if i < len(chs) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, asymmetric=True)])
            enc.down_blocks.append(blk)
        enc.mid_block = _vae_mid(chs[-1])
        enc.conv_norm_out = nn.GroupNorm(32, chs[-1], eps=1e-6)
        enc.conv_out = nn.Conv2d(chs[-1], 2 * latent, 3, padding=1)
        dec = self.decoder = nn.Module()
        dec.conv_in = nn.Conv2d(latent, rev[0], 3, padding=1)
        dec.mid_block = _vae_mid(rev[0])
        dec.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([ResnetBlock(rev[max(i - 1, 0)] if j == 0 else ch, ch,
                                                     None, 1e-6) for j in range(layers + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=1e-6)
        dec.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * latent, 2 * latent, 1)
        self.post_quant_conv = nn.Conv2d(latent, latent, 1)

    def encode(self, x):
        enc = self.encoder
        h = enc.conv_in(x)
        for blk in enc.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = enc.conv_out(F.silu(enc.conv_norm_out(_run_mid(enc.mid_block, h))))
        mean, logvar = self.quant_conv(h).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        dec = self.decoder
        h = _run_mid(dec.mid_block, dec.conv_in(self.post_quant_conv(z)))
        for blk in dec.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return dec.conv_out(F.silu(dec.conv_norm_out(h)))


# ---------------------------------------------------------------------------
# CLIP towers and the safety checker
# ---------------------------------------------------------------------------


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, heads: int, inner: int):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(dim)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(dim, dim))
        self.layer_norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, inner)
        self.mlp.fc2 = nn.Linear(inner, dim)

    def forward(self, x, mask=None):
        a = self.self_attn
        h = self.layer_norm1(x)
        x = x + a.out_proj(attention(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads, mask))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """transformers ``CLIPTextModel``: ids (B, n) -> final_layer_norm(last
    hidden state), causal."""

    def __init__(self, vocab: int, dim: int, layers: int, heads: int, inner: int,
                 max_length: int):
        super().__init__()
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(vocab, dim)
        tm.embeddings.position_embedding = nn.Embedding(max_length, dim)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPLayer(dim, heads, inner) for _ in range(layers)])
        tm.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, ids):
        tm, n = self.text_model, ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:n]
        mask = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


class CLIPVision(nn.Module):
    """transformers ``CLIPVisionModel``: pixels -> last_hidden_state (before
    post_layernorm)."""

    def __init__(self, image: int, patch: int, dim: int, layers: int, heads: int, inner: int):
        super().__init__()
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(dim))
        vm.embeddings.patch_embedding = nn.Conv2d(3, dim, patch, stride=patch, bias=False)
        vm.embeddings.position_embedding = nn.Embedding((image // patch) ** 2 + 1, dim)
        vm.pre_layrnorm = nn.LayerNorm(dim)
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList([CLIPLayer(dim, heads, inner) for _ in range(layers)])
        vm.post_layernorm = nn.LayerNorm(dim)

    def forward(self, pixels):
        vm = self.vision_model
        e = vm.embeddings
        p = e.patch_embedding(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([e.class_embedding.expand(p.shape[0], 1, -1), p], dim=1)
        x = vm.pre_layrnorm(x + e.position_embedding.weight[:x.shape[1]])
        for layer in vm.encoder.layers:
            x = layer(x)
        return x


class SafetyChecker(nn.Module):
    """diffusers ``StableDiffusionSafetyChecker``: pooled ViT embedding,
    cosine against the concept embeddings less their thresholds."""

    def __init__(self, vision: CLIPVision, proj: int, concepts: int, special: int):
        super().__init__()
        self.vision_model = vision
        dim = vision.vision_model.pre_layrnorm.normalized_shape[0]
        self.visual_projection = nn.Linear(dim, proj, bias=False)
        self.concept_embeds = nn.Parameter(torch.zeros(concepts, proj))
        self.special_care_embeds = nn.Parameter(torch.zeros(special, proj))
        self.concept_embeds_weights = nn.Parameter(torch.zeros(concepts))
        self.special_care_embeds_weights = nn.Parameter(torch.zeros(special))

    def flags(self, pixels):
        """CLIP pixels -> (B,) bool NSFW flags."""
        vm = self.vision_model.vision_model
        emb = self.visual_projection(vm.post_layernorm(self.vision_model(pixels)[:, 0]))

        def cos(a, b):
            return F.normalize(a, dim=-1) @ F.normalize(b, dim=-1).T

        special = (cos(emb, self.special_care_embeds) - self.special_care_embeds_weights > 0)
        care = special.any(dim=-1, keepdim=True).float() * 0.01
        return (cos(emb, self.concept_embeds) - self.concept_embeds_weights + care > 0).any(-1)


# ---------------------------------------------------------------------------
# LGP and anime2sketch
# ---------------------------------------------------------------------------


class FlaxBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d whose train mode feeds the biased batch variance into the
    running variance (flax's ``BatchNorm``); eval mode is BatchNorm1d's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = ((x - mean) ** 2).mean(dim=0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class LGP(nn.Module):
    """The published ``edge_predictor.pt``: per pixel, [taps; noise level;
    9 octaves of sin(2 pi t 2^-l)] -> 512 -> 256 -> 128 -> 64 -> 4, ReLU then
    BatchNorm between the Linears."""

    def __init__(self, input_dim: int, widths: Sequence[int] = (512, 256, 128, 64),
                 output_dim: int = 4, octaves: int = 9):
        super().__init__()
        self.octaves = octaves
        mods, w_in = [], input_dim
        for w in widths:
            mods += [nn.Linear(w_in, w), nn.ReLU(), FlaxBatchNorm(w)]
            w_in = w
        mods.append(nn.Linear(w_in, output_dim))
        self.layers = nn.Sequential(*mods)

    def forward(self, taps: torch.Tensor, noise_level: torch.Tensor) -> torch.Tensor:
        """taps (B, C, H, W) already at the latent size, noise_level (B, 4, H, W)."""
        pos = torch.cat([torch.sin(2 * math.pi * noise_level * 2.0 ** -l)
                         for l in range(self.octaves)], dim=1)
        feats = torch.cat([taps, noise_level, pos], dim=1)
        b, c, h, w = feats.shape
        out = self.layers(feats.permute(0, 2, 3, 1).reshape(b * h * w, c))
        return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def concat_taps(taps: Dict[str, torch.Tensor], h: int, w: int) -> torch.Tensor:
    """The nine taps bilinearly resized (half-pixel, no antialias) to h x w,
    concatenated in ``TAP_NAMES`` order."""
    return torch.cat([t if t.shape[2:] == (h, w) else
                      F.interpolate(t, size=(h, w), mode="bilinear", align_corners=False)
                      for t in (taps[n] for n in TAP_NAMES)], dim=1)


class SkipBlock(nn.Module):
    def __init__(self, outer: int, inner: int, input_nc: Optional[int] = None,
                 sub: Optional[nn.Module] = None, outermost=False, innermost=False):
        super().__init__()
        self.outermost = outermost
        down = nn.Conv2d(input_nc or outer, inner, 4, 2, 1)
        if outermost:
            layers = [down, sub, nn.ReLU(), nn.ConvTranspose2d(inner * 2, outer, 4, 2, 1),
                      nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                      nn.ConvTranspose2d(inner, outer, 4, 2, 1), nn.InstanceNorm2d(outer)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nn.InstanceNorm2d(inner), sub, nn.ReLU(),
                      nn.ConvTranspose2d(inner * 2, outer, 4, 2, 1), nn.InstanceNorm2d(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x) if self.outermost else torch.cat([x, self.model(x)], dim=1)


class Anime2Sketch(nn.Module):
    """The pix2pix U-Net generator of ``netG.pth``: 3 -> 1 channels."""

    def __init__(self, num_downs: int = 8, ngf: int = 64):
        super().__init__()
        blk = SkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            blk = SkipBlock(ngf * 8, ngf * 8, sub=blk)
        blk = SkipBlock(ngf * 4, ngf * 8, sub=blk)
        blk = SkipBlock(ngf * 2, ngf * 4, sub=blk)
        blk = SkipBlock(ngf, ngf * 2, sub=blk)
        self.model = SkipBlock(1, ngf, input_nc=3, sub=blk, outermost=True)

    def forward(self, x):
        return self.model(x)
