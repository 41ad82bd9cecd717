"""State dicts the trainers publish, in the reference's ``.pt`` layouts —
counterpart of the part of ``sketch2img_tpu/core/export.py`` the trainers
use.

The port's modules already hold these layouts, so each exporter is close to
the identity: ``edge_predictor.pt`` is the LGP's ``state_dict()``
(``nn.Sequential`` names, BatchNorm running statistics and
``num_batches_tracked``), ``sketch_attn_model.pt`` is ``unet.sat``'s
(the SatMixin names) and ``sketch_encoder_model.pt`` the CLIP tower's
(transformers ``CLIPVisionModel`` names). They are written as fp32 CPU
tensors with ``torch.save``, which is what the JAX package's loaders
(``load_torch_state`` and its converters) and the reference stack read.
"""

from __future__ import annotations

from typing import Dict

import torch

StateDict = Dict[str, torch.Tensor]


def _export(module: torch.nn.Module) -> StateDict:
    return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().clone()
            for k, v in module.state_dict().items()}


def lgp_state(lgp: torch.nn.Module) -> StateDict:
    """``edge_predictor.pt``: the LGP's state dict."""
    return _export(lgp)


def sat_state(unet: torch.nn.Module) -> StateDict:
    """``sketch_attn_model.pt``: the injection blocks' state dict."""
    return _export(unet.sat)


def clip_vision_state(clip: torch.nn.Module) -> StateDict:
    """``sketch_encoder_model.pt``: the CLIP vision tower's state dict."""
    return _export(clip)


def save_torch_state(path: str, state: StateDict) -> None:
    """Write a ``torch.save`` file the reference stack loads as it is."""
    torch.save(state, path)


def load_torch_state(path: str) -> StateDict:
    """Read a ``.pt`` state dict (a ``{"state_dict": ...}`` wrapper too)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd
