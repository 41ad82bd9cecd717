"""CLIP-based NSFW safety checker — counterpart of
``sketch2img_tpu/models/safety_checker.py``, on the port's
``CLIPVisionEncoder``.

Parameter names are diffusers' ``StableDiffusionSafetyChecker``
(``vision_model.vision_model.*``, ``visual_projection.weight``,
``concept_embeds``, ``concept_embeds_weights``, ``special_care_embeds``,
``special_care_embeds_weights``), so the SD1.5 ``safety_checker/`` weights
load with ``load_state_dict(strict=True)``.

Checker math (the shipped CompVis checker's forward semantics):
  image_embeds   = post_layernorm(h[:, 0]) @ W_proj^T
  special_scores = cos(image_embeds, special_embeds) - special_thresholds
  special_care   = any(special_scores > 0)       # lowers all thresholds
  concept_scores = cos(image_embeds, concept_embeds) - thresholds
                   + 0.01 * special_care
  nsfw           = any(concept_scores > 0)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sketch2img_torch.models.clip_vision import (
    VIT_L14_CONFIG,
    CLIPVisionConfig,
    CLIPVisionEncoder,
)

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, height, width), Keys cubic with a = -0.5 and a
    kernel widened by the scale when shrinking: ``jax.image.resize(...,
    "bicubic")`` (antialiased by default). PyTorch's antialiased bicubic is
    that filter; its plain bicubic (a = -0.75, no antialias) is not."""
    return F.interpolate(x, size=(height, width), mode="bicubic", antialias=True,
                         align_corners=False)


def clip_normalize(pixels01: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> CLIP mean/std-normalised pixels."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=pixels01.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=pixels01.device).view(1, 3, 1, 1)
    return (pixels01 - mean) / std


def preprocess(images01: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """Decoded images (B, 3, H, W) in [0, 1] -> CLIP pixel values: bicubic
    resize of the shortest edge to ``image_size``, centre crop, normalise."""
    h, w = images01.shape[2:]
    if h <= w:
        nh, nw = image_size, max(int(round(w * image_size / h)), image_size)
    else:
        nh, nw = max(int(round(h * image_size / w)), image_size), image_size
    x = resize_bicubic(images01.float(), nh, nw)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size]
    return clip_normalize(x.clamp(0.0, 1.0))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.normalize(a, dim=-1) @ F.normalize(b, dim=-1).T


class SafetyChecker(nn.Module):
    """The diffusers ``StableDiffusionSafetyChecker`` module tree."""

    def __init__(self, vision_config: CLIPVisionConfig = VIT_L14_CONFIG,
                 projection_dim: int = 768, num_concepts: int = 17, num_special: int = 3):
        super().__init__()
        self.vision_model = CLIPVisionEncoder(vision_config)
        self.visual_projection = nn.Linear(vision_config.hidden_size, projection_dim, bias=False)
        self.concept_embeds = nn.Parameter(torch.randn(num_concepts, projection_dim),
                                           requires_grad=False)
        self.special_care_embeds = nn.Parameter(torch.randn(num_special, projection_dim),
                                                requires_grad=False)
        self.concept_embeds_weights = nn.Parameter(torch.full((num_concepts,), 0.5),
                                                   requires_grad=False)
        self.special_care_embeds_weights = nn.Parameter(torch.full((num_special,), 0.5),
                                                        requires_grad=False)

    @torch.no_grad()
    def check_images(self, images01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, H, W) in [0, 1] -> (the images with flagged ones blacked
        out, (B,) bool NSFW flags). The tower runs in its parameters' dtype,
        the pooled embedding and the scores in fp32."""
        vm = self.vision_model
        pixels = preprocess(images01, vm.config.image_size)
        cls = vm(pixels)[:, 0, :].float()
        post = vm.vision_model.post_layernorm
        pooled = F.layer_norm(cls, post.normalized_shape, post.weight.float(),
                              post.bias.float(), post.eps)
        embeds = pooled @ self.visual_projection.weight.float().T
        special = (_cosine(embeds, self.special_care_embeds.float())
                   - self.special_care_embeds_weights.float())
        special_care = (special > 0).any(dim=-1)
        concept = (_cosine(embeds, self.concept_embeds.float())
                   - self.concept_embeds_weights.float() + 0.01 * special_care[:, None].float())
        nsfw = (concept > 0).any(dim=-1)
        blacked = torch.where(nsfw[:, None, None, None], torch.zeros_like(images01), images01)
        return blacked, nsfw
