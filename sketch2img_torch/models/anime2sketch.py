"""anime2sketch — the pix2pix U-Net generator that makes training sketches
from images on the fly; counterpart of ``sketch2img_tpu/models/anime2sketch.py``.

An 8-down recursive skip-connection U-Net, 3 -> 1 channels, ngf 64:
``Conv2d(k4, s2, p1)``, ``InstanceNorm2d`` without affine (eps 1e-5),
LeakyReLU 0.2 going down and ReLU going up, ``ConvTranspose2d(k4, s2, p1)``,
Tanh at the output. The module tree is the reference's (``model.model.0``
the outermost down conv, ``model.model.1.model.1`` the next level's...), so
the published ``netG.pth`` loads with ``load_state_dict(strict=True)``
(``load_netg``). The JAX package's phase-decomposed conv-transpose
(``ops/subpixel.py``) is a TPU lowering; here it is ``nn.ConvTranspose2d``.

The reference's activations are in place, so each skip connection carries
LeakyReLU(x) instead of x; the ReLU that follows the concatenation makes
the two equal (ReLU(LeakyReLU(x)) = ReLU(x)), and this module, like the
JAX package's, concatenates x itself.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn


class UnetSkipBlock(nn.Module):
    """One level: [down, submodule, up], its input concatenated to its
    output unless it is the outermost level."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        downconv = nn.Conv2d(input_nc or outer_nc, inner_nc, 4, 2, 1)
        if outermost:
            layers = [downconv, submodule, nn.ReLU(),
                      nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1), nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), downconv, nn.ReLU(),
                      nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1), nn.InstanceNorm2d(outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), downconv, nn.InstanceNorm2d(inner_nc), submodule,
                      nn.ReLU(), nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1),
                      nn.InstanceNorm2d(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], dim=1)


class UnetGenerator(nn.Module):
    """x (B, 3, H, W) in [-1, 1], H and W divisible by 2**num_downs ->
    (B, 1, H, W) in [-1, 1]. Built innermost-out; at least 5 levels."""

    def __init__(self, input_nc: int = 3, output_nc: int = 1, num_downs: int = 8,
                 ngf: int = 64):
        super().__init__()
        if num_downs < 5:
            raise ValueError(f"the generator has at least 5 levels, got num_downs={num_downs}")
        self.num_downs = num_downs
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 4, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 2, ngf * 4, submodule=block)
        block = UnetSkipBlock(ngf, ngf * 2, submodule=block)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc=input_nc, submodule=block,
                                   outermost=True)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.model[0].weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.dtype))


def create_anime2sketch(num_downs: int = 8, ngf: int = 64,
                        compute_dtype: torch.dtype = torch.float32) -> UnetGenerator:
    """The published generator's options (3 -> 1 channels, 8 downs, ngf 64),
    its weights (and so its arithmetic) in ``compute_dtype``."""
    return UnetGenerator(3, 1, num_downs, ngf).to(compute_dtype)


def binarize_sketch(raw: torch.Tensor) -> torch.Tensor:
    """The generator's output in [-1, 1] -> 1 - output, thresholded at 0.5
    to {0, 1} (dark strokes 0)."""
    return torch.where(1.0 - raw < 0.5, 0.0, 1.0)


def strip_module_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A DataParallel-saved state dict (``module.``-prefixed keys) -> plain keys."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return dict(sd)


def load_netg(path: str, num_downs: int = 8, ngf: int = 64,
              device: Union[str, torch.device] = "cuda") -> UnetGenerator:
    """The published ``netG.pth``, loaded strictly into a frozen fp32
    generator on ``device`` (at the published size, held to its manifest
    first, with or without DataParallel's ``module.``)."""
    from sketch2img_torch.core.manifest import check_state_dict
    from sketch2img_torch.utils.device import resolve_device, set_deterministic

    dev = resolve_device(device)
    set_deterministic(dev)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    if (num_downs, ngf) == (8, 64):
        check_state_dict("netG", sd, what=path, strip_prefix="module.")
    gan = create_anime2sketch(num_downs, ngf)
    gan.load_state_dict(strip_module_prefix(sd), strict=True)
    return gan.to(dev).eval().requires_grad_(False)
