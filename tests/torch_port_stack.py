"""Tiny shared-weight model pairs for the PyTorch port's parity tests.

Each function makes the port's module (seeded PyTorch init, fp32, CPU, with
its norm affines and BatchNorm statistics perturbed so that they matter)
and the JAX package's module with parameters converted from the same state
dict by the JAX package's own torch -> Flax converters. Inputs are made with
numpy and handed to both sides.
"""

import numpy as np
import torch

from sketch2img_tpu.core.convert import (
    convert_torch_clip_text,
    convert_torch_lgp,
    convert_torch_unet,
    convert_torch_vae,
)
from sketch2img_tpu.core.export import convert_torch_sat
from sketch2img_tpu.models import clip_text as jclip
from sketch2img_tpu.models import clip_vision as jvision
from sketch2img_tpu.models import lgp as jlgp
from sketch2img_tpu.models import unet as junet
from sketch2img_tpu.models import vae as jvae
from sketch2img_torch.models import clip_text as tclip
from sketch2img_torch.models import clip_vision as tvision
from sketch2img_torch.models import lgp as tlgp
from sketch2img_torch.models import unet as tunet
from sketch2img_torch.models import vae as tvae

# three levels (the taps need down_0..2 and up_0..2), one resnet per level;
# at a 16x16 latent the first level's self-attention (N=256, d=16) is a
# flash site, the 8x8 and 4x4 levels take the plain path
UNET_KW = dict(block_out_channels=(32, 32, 64), cross_attn=(True, True, False),
               layers_per_block=1, num_heads=2, cross_attention_dim=24)
VAE_KW = dict(block_out_channels=(32, 64), layers_per_block=1)
CLIP_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4)
# the ViT at its real 224/14 geometry (257 tokens), two narrow layers
VISION_KW = dict(image_size=224, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64)


def nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _perturb(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm, torch.nn.BatchNorm1d)):
                m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=gen))
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.9, 1.1, generator=gen)
    return module.eval().requires_grad_(False)


def unet_pair(seed=0, **overrides):
    kw = dict(UNET_KW, **overrides)
    torch.manual_seed(seed)
    port = _perturb(tunet.UNet2DCondition(tunet.UNetConfig(**kw)), seed)
    cfg = junet.UNetConfig(**kw)
    return port, junet.UNet2DCondition(cfg), convert_torch_unet(port.state_dict(), cfg)


def lgp_pair(seed=0):
    torch.manual_seed(seed)
    in_dim = tunet.tap_channels(tunet.UNetConfig(**UNET_KW)) + 4 + 36
    port = _perturb(tlgp.LatentEdgePredictor(input_dim=in_dim), seed)
    params, stats = convert_torch_lgp(port.state_dict())
    return port, jlgp.LatentEdgePredictor(input_dim=in_dim), {"params": params,
                                                             "batch_stats": stats}


def vae_pair(seed=0):
    torch.manual_seed(seed)
    port = _perturb(tvae.AutoencoderKL(tvae.VAEConfig(**VAE_KW)), seed)
    cfg = jvae.VAEConfig(**VAE_KW)
    return port, jvae.AutoencoderKL(cfg), convert_torch_vae(port.state_dict(), cfg)


def clip_pair(seed=0):
    torch.manual_seed(seed)
    port = _perturb(tclip.CLIPTextEncoder(tclip.CLIPTextConfig(**CLIP_KW)), seed)
    params = convert_torch_clip_text(port.state_dict(), num_layers=CLIP_KW["num_layers"])
    return port, jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**CLIP_KW)), params


def _merge(base, extra):
    """Nested-dict union (the JAX package's merge_injection_params)."""
    out = dict(base)
    for k, v in extra.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and k in out else v
    return out


def injected_unet_pair(variant, seed=0, context_dim=16):
    """The injected UNet: base weights through convert_torch_unet, the
    injection blocks (``unet.sat``, the sketch_attn_model.pt layout) through
    the JAX package's convert_torch_sat."""
    torch.manual_seed(seed)
    kw = dict(UNET_KW, injection=variant, injection_context_dim=context_dim)
    port = _perturb(tunet.UNet2DCondition(tunet.UNetConfig(**kw)), seed)
    cfg = junet.UNetConfig(**kw)
    base = {k: v for k, v in port.state_dict().items() if not k.startswith("sat.")}
    params = _merge(convert_torch_unet(base, cfg), convert_torch_sat(port.sat.state_dict(), cfg))
    return port, junet.UNet2DCondition(cfg), params


def clip_vision_pair(seed=0):
    torch.manual_seed(seed)
    port = _perturb(tvision.CLIPVisionEncoder(tvision.CLIPVisionConfig(**VISION_KW)), seed)
    params = jvision.convert_torch_clip_vision(port.state_dict(),
                                               num_layers=VISION_KW["num_layers"])
    return port, jvision.CLIPVisionEncoder(jvision.CLIPVisionConfig(**VISION_KW)), params
