"""CLIP vision encoder (ViT-L/14) — counterpart of
``sketch2img_tpu/models/clip_vision.py``: the sketch encoder of the
attention-injection variant and the tower of the safety checker.

Parameter names follow transformers' ``CLIPVisionModel`` (``vision_model.
embeddings.patch_embedding``, ``vision_model.pre_layrnorm`` in its own
spelling, ``vision_model.encoder.layers.{i}.self_attn.q_proj``...), so a
``sketch_encoder_model.pt`` loads with ``load_state_dict(strict=True)``.
``forward`` returns HF's ``last_hidden_state``: the encoder output BEFORE
``post_layernorm``, which only the safety checker's pooled embedding reads.
The patch conv has no bias; the MLP is quick-GELU, x * sigmoid(1.702 x).
Attention is 16 heads of d=64 over 257 tokens, no mask: a flash site.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from sketch2img_torch.models.clip_text import CLIPLayer
from sketch2img_torch.models.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


VIT_L14_CONFIG = CLIPVisionConfig()


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(0.02 * torch.randn(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(c.num_tokens, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(c) for _ in range(c.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.pre_layrnorm = LayerNorm(c.hidden_size)
        self.encoder = _Encoder(c)
        self.post_layernorm = LayerNorm(c.hidden_size)


class CLIPVisionEncoder(nn.Module):
    """pixel_values (B, 3, H, W), CLIP-normalised -> last_hidden_state
    (B, 1 + (H/p)(W/p), hidden), before ``post_layernorm``."""

    def __init__(self, config: CLIPVisionConfig = VIT_L14_CONFIG):
        super().__init__()
        self.config = config
        self.vision_model = _VisionModel(config)

    @property
    def dtype(self) -> torch.dtype:
        return self.vision_model.embeddings.patch_embedding.weight.dtype

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixel_values.to(self.dtype))  # (B, D, h, w)
        b, d = patches.shape[:2]
        patches = patches.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(patches.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding.weight[None, : x.shape[1]].to(x.dtype)
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, None)
        return x
