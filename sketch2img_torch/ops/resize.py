"""Resizes — counterpart of ``sketch2img_tpu/ops/resize.py`` and of the
JAX package's ``jax.image.resize`` calls.

``resize_bilinear``: half-pixel bilinear interpolation without antialiasing
(``align_corners=False, antialias=False``), the convention the JAX package
matches with ``jax.image.resize(method="linear", antialias=False)``.

``resize_bicubic``: ``jax.image.resize(method="cubic")``, which is Keys
cubic with a = -0.5 and a kernel widened by the scale when shrinking
(antialiased). PyTorch's antialiased bicubic is that filter, up and down;
its plain bicubic (a = -0.75, no antialias) is not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x: (B, C, H, W) NCHW -> (B, C, height, width)."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x: (B, C, H, W) NCHW -> (B, C, height, width), Keys a = -0.5,
    antialiased when shrinking (``jax.image.resize(..., "cubic")``)."""
    return F.interpolate(x, size=(height, width), mode="bicubic", antialias=True,
                         align_corners=False)
