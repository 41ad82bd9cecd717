"""Latent Edge Predictor (LGP) — counterpart of ``sketch2img_tpu/models/lgp.py``.

A per-pixel MLP (9320 -> 512 -> 256 -> 128 -> 64 -> 4, ReLU + BatchNorm1d
between layers) over the concatenated UNet taps, the noise-level map and a
9-octave sinusoidal encoding of it. ``layers`` is the ``nn.Sequential`` of
the published ``edge_predictor.pt`` (Linear at 0, 3, 6, 9, 12; BatchNorm1d
at 2, 5, 8, 11), so that file loads with ``load_state_dict(strict=True)``.
In eval mode BatchNorm runs on its running statistics; in train mode (the
LGP trainer) it normalises with the batch statistics and updates the
running ones as flax does (``BatchNorm``). The LGP stays fp32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

_WIDTHS = (512, 256, 128, 64)


def _pos_encoding(t: torch.Tensor, num_layers: int) -> torch.Tensor:
    """[sin(2 pi t 2^-l)]_l concatenated on the channel axis (dim 1)."""
    return torch.cat([torch.sin(2.0 * math.pi * t * (2.0 ** -l)) for l in range(num_layers)],
                     dim=1)


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train mode follows flax's ``BatchNorm`` (the
    JAX package's LGP, ``sketch2img_tpu/models/lgp.py``): normalise with the
    biased batch variance and feed that same biased variance into
    ``running_var`` (``nn.BatchNorm1d`` feeds the unbiased one), momentum
    0.1 here = 0.9 there. Statistics in fp32, in two passes (flax takes
    E[x^2] - E[x]^2; the two agree to fp32 rounding). Eval mode and the
    state dict are ``nn.BatchNorm1d``'s.

    ``process_group`` (set by ``sync_batch_stats``): the data-parallel
    group whose ranks each hold a shard of the batch. Both passes' sums are
    then all-reduced over it (differentiably), so the statistics, and the
    running ones, are the whole batch's, as JAX's jitted step computes them
    over the sharded batch."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from sketch2img_torch.parallel.mesh import all_reduce_sum

        xf = x.float()
        n = xf.shape[0]
        s1 = xf.sum(dim=0)
        if self.process_group is not None:
            s1 = all_reduce_sum(s1, self.process_group)
            n *= torch.distributed.get_world_size(self.process_group)
        mean = s1 / n
        s2 = ((xf - mean) ** 2).sum(dim=0)
        if self.process_group is not None:
            s2 = all_reduce_sum(s2, self.process_group)
        var = s2 / n
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def sync_batch_stats(module: nn.Module, group) -> nn.Module:
    """Take every train-mode ``BatchNorm`` of ``module`` over the whole batch
    of the data-parallel ``group`` (None: the local batch). -> ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return module


class LatentEdgePredictor(nn.Module):
    def __init__(self, input_dim: int = 9320, output_dim: int = 4, num_layers: int = 9):
        super().__init__()
        self.num_layers = num_layers  # octaves of the positional encoding, not MLP depth
        mods = []
        width_in = input_dim
        for w in _WIDTHS:
            mods += [nn.Linear(width_in, w), nn.ReLU(), BatchNorm(w)]
            width_in = w
        mods.append(nn.Linear(width_in, output_dim))
        self.layers = nn.Sequential(*mods)
        for m in self.layers:
            if isinstance(m, nn.Linear):  # reference init: kaiming uniform, zero bias
                nn.init.kaiming_uniform_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) concatenated taps, t: (B, 4, H, W) noise level ->
        (B, output_dim, H, W). The map is per pixel, so NCHW is flattened
        channels-last and restored."""
        feats = torch.cat([x, t, _pos_encoding(t, self.num_layers)], dim=1)
        b, c, h, w = feats.shape
        dt = self.layers[0].weight.dtype
        out = self.layers(feats.permute(0, 2, 3, 1).reshape(b * h * w, c).to(dt))
        return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _bn_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    y = (x.float() - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)
    return (y * bn.weight.float() + bn.bias.float()).to(x.dtype)


def lgp_fused_apply(lgp: LatentEdgePredictor, taps: Dict[str, torch.Tensor],
                    noise_level: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Eval-mode LGP with the first Linear applied to each tap at its native
    resolution before the bilinear resize — resize is linear over space and
    the Linear mixes only channels, so this equals ``lgp(concat_taps(...))``
    without building the (B, 9280, H, W) concat.

    taps: NCHW fp32 maps keyed by ``TAP_NAMES``; noise_level: (B, 4, H, W).
    Returns (B, output_dim, H, W)."""
    from sketch2img_torch.models.unet import TAP_NAMES
    from sketch2img_torch.ops.resize import resize_bilinear

    lin = [m for m in lgp.layers if isinstance(m, nn.Linear)]
    bns = [m for m in lgp.layers if isinstance(m, nn.BatchNorm1d)]
    dt = lin[0].weight.dtype
    w1 = lin[0].weight  # (512, input_dim)

    acc = None
    offset = 0
    for name in TAP_NAMES:
        t = taps[name].to(dt)
        c = t.shape[1]
        proj = torch.einsum("bchw,oc->bohw", t, w1[:, offset:offset + c])
        offset += c
        if proj.shape[2] != height or proj.shape[3] != width:
            proj = resize_bilinear(proj, height, width)
        acc = proj if acc is None else acc + proj

    nl = noise_level.to(dt)
    pos = _pos_encoding(nl, lgp.num_layers)
    acc = acc + torch.einsum("bchw,oc->bohw", nl, w1[:, offset:offset + nl.shape[1]])
    offset += nl.shape[1]
    acc = acc + torch.einsum("bchw,oc->bohw", pos, w1[:, offset:offset + pos.shape[1]])
    h = acc.permute(0, 2, 3, 1) + lin[0].bias  # (B, H, W, 512)
    for i in range(1, len(lin)):
        h = lin[i](_bn_eval(bns[i - 1], torch.relu(h)))
    return h.permute(0, 3, 1, 2)
