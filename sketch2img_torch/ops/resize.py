"""Resizes — counterpart of ``sketch2img_tpu/ops/resize.py`` and of the
JAX package's ``jax.image.resize`` calls.

``resize_bilinear``: half-pixel bilinear interpolation without antialiasing
(``align_corners=False, antialias=False``), the convention the JAX package
matches with ``jax.image.resize(method="linear", antialias=False)``. Its
backward (the guided step differentiates the LGP head through it) is the
adjoint as two products with the 1-D interpolation matrices: PyTorch's own
CUDA backward adds with atomics, in an order that varies from run to run.

``resize_bicubic``: ``jax.image.resize(method="cubic")``, which is Keys
cubic with a = -0.5 and a kernel widened by the scale when shrinking
(antialiased). PyTorch's antialiased bicubic is that filter, up and down;
its plain bicubic (a = -0.75, no antialias) is not.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x: (B, C, H, W) NCHW -> (B, C, height, width)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Bilinear.apply(x, height, width)
    return _bilinear(x, height, width)


def _bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=False)


@functools.lru_cache(maxsize=None)
def _linear_weights(n_in: int, n_out: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """(n_out, n_in) matrix of half-pixel linear interpolation from n_in to
    n_out samples: row i holds the two weights PyTorch's bilinear mode gives
    output i (source position (i + 0.5) n_in / n_out - 0.5, clamped at 0;
    the upper neighbour clamped to the last sample). Kept per device, so a
    guided step copies nothing to the card."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5).clamp(min=0)
    lo = src.floor().long().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = src - lo
    rows = torch.arange(n_out)
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m.index_put_((rows, lo), 1 - frac, accumulate=True)
    m.index_put_((rows, hi), frac, accumulate=True)
    return m.to(device=device, dtype=dtype)


class _Bilinear(torch.autograd.Function):
    """``F.interpolate``'s bilinear forward; the backward sums each input
    sample's share in a fixed order: dx = Mhᵀ · dy · Mw."""

    @staticmethod
    def forward(ctx, x, height, width):
        ctx.in_hw = x.shape[2], x.shape[3]
        return _bilinear(x, height, width)

    @staticmethod
    def backward(ctx, dy):
        (h, w), dev = ctx.in_hw, dy.device
        mh = _linear_weights(h, dy.shape[2], dev, dy.dtype)
        mw = _linear_weights(w, dy.shape[3], dev, dy.dtype)
        return torch.matmul(mh.t(), torch.matmul(dy, mw)), None, None


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x: (B, C, H, W) NCHW -> (B, C, height, width), Keys a = -0.5,
    antialiased when shrinking (``jax.image.resize(..., "cubic")``)."""
    return F.interpolate(x, size=(height, width), mode="bicubic", antialias=True,
                         align_corners=False)
