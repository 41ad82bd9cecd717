"""Attention-injection training step — counterpart of
``sketch2img_tpu/train/train_attn_inject.py``.

Trains the injection blocks (``unet.sat``: the ``sketch_proj`` /
``sketch_norm`` / ``sketch_attn`` / ``sketch_conv`` modules) and the CLIP
vision tower with the epsilon-prediction MSE; the base UNet, the VAE, the
text encoder and the anime2sketch generator stay frozen. The trainables are
the parameters with ``requires_grad`` (``mark_trainables``); the base
UNet's stay bit-identical.

Precision, as in the JAX package (flax casts fp32 parameters to a module's
``compute_dtype``): the trainables are fp32 master weights, and each step
runs the injected UNet and the ViT on copies cast to the frozen base UNet's
dtype (``torch.func.functional_call``), so the gradients reach the fp32
masters through the casts. The loss is fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from sketch2img_torch.core.schedulers import add_noise
from sketch2img_torch.models.safety_checker import clip_normalize
from sketch2img_torch.models.unet import num_transformer_blocks
from sketch2img_torch.models.vae import sample_latent
from sketch2img_torch.ops.resize import resize_bicubic
from sketch2img_torch.train.train_lgp import (
    Frozen,
    data_shard,
    draw,
    encode_text,
    generate_sketch,
    reduce_step,
)

#: CLIP parameters the loss never reads (``post_layernorm`` feeds only the
#: pooled output): not trained, as the JAX package's tree has none
CLIP_UNUSED = ("vision_model.post_layernorm.",)


def sketch_to_clip_pixels(gan, px: torch.Tensor, *, sketch_fixed_size: int = 512,
                          clip_image_size: int = 224) -> torch.Tensor:
    """px (B, 3, H, W) in [-1, 1] -> CLIP pixels (B, 3, S, S): the
    generator's sketch without binarisation, clipped to [0, 1], bicubic to
    S x S, CLIP mean/std. The train step and the latent cache share it."""
    raw = generate_sketch(gan, px, fixed=sketch_fixed_size, binarize=False)
    sk = resize_bicubic(raw.clamp(0.0, 1.0), clip_image_size, clip_image_size)
    return clip_normalize(sk)


def mark_trainables(unet: nn.Module, clip: nn.Module) -> Dict[str, nn.Parameter]:
    """Freeze the base UNet, train ``unet.sat`` and the CLIP tower (less
    ``CLIP_UNUSED``). -> {name: parameter} of the trainables, "sat." and
    "clip." prefixed."""
    unet.requires_grad_(False)
    unet.sat.requires_grad_(True)
    out = {}
    for name, p in clip.named_parameters():
        p.requires_grad_(not name.startswith(CLIP_UNUSED))
    for prefix, module in (("sat.", unet.sat), ("clip.", clip)):
        out.update({prefix + n: p for n, p in module.named_parameters() if p.requires_grad})
    return out


def _cast_call(module: nn.Module, dtype: torch.dtype, *args, **kwargs):
    """``module(*args, **kwargs)`` with every trainable parameter replaced by
    its cast to ``dtype`` (differentiable; a parameter of that dtype already
    is passed as it is)."""
    params = {n: p.to(dtype) for n, p in module.named_parameters() if p.requires_grad}
    return functional_call(module, params, args, kwargs)


def inject_loss(unet, clip, noisy, t, ctx, sketch_pixels, noise) -> torch.Tensor:
    """The differentiated part: ViT on the sketch, its hidden state at every
    TransformerBlock at scale 1, eps-MSE in fp32. Trainables in the base
    UNet's dtype."""
    dtype = unet.dtype
    hidden = _cast_call(clip, dtype, sketch_pixels)
    states = [hidden] * num_transformer_blocks(unet.config)
    eps = _cast_call(unet, dtype, noisy, t, ctx, injection_states=states, injection_scale=1.0)
    return torch.mean((eps.float() - noise.float()) ** 2)


def inject_inputs(frozen: Frozen, batch: Dict[str, torch.Tensor], *,
                  sketch_fixed_size: int = 512, clip_image_size: int = 224,
                  cached_latents: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  shard: Optional[Tuple[int, int]] = None):
    """The frozen part, without grad: -> (noisy latents, t, text states,
    CLIP pixels of the sketch, diffusion noise). ``batch``: ``input_ids`` and
    ``pixels`` (B, 3, H, W) in [-1, 1], or with ``cached_latents``
    ``latent_dist`` (B, 8, h, w) and ``sketch_clip_pixels`` (B, 3, S, S)."""
    with torch.no_grad():
        ctx = encode_text(frozen.text_encoder, batch["input_ids"])
        if cached_latents:
            mean, logvar = batch["latent_dist"].float().chunk(2, dim=1)
            sk = batch["sketch_clip_pixels"].float()
        else:
            px = batch["pixels"]
            mean, logvar = frozen.vae.encode(px)
            sk = sketch_to_clip_pixels(frozen.gan, px, sketch_fixed_size=sketch_fixed_size,
                                       clip_image_size=clip_image_size)
        if draws is None:
            draws = draw(mean.shape, frozen.schedule.num_train_timesteps, ("latent", "noise"),
                         generator, mean.device, shard)
        latents = sample_latent(mean, logvar, draws["latent"])
        noise, t = draws["noise"], draws["t"]
        noisy = add_noise(frozen.schedule, latents, noise, t)
    return noisy, t, ctx, sk, noise


def inject_train_step(unet, clip, optimizer: torch.optim.Optimizer, frozen: Frozen,
                      batch: Dict[str, torch.Tensor], mesh=None, **kwargs) -> torch.Tensor:
    """One step: ``inject_inputs`` (``kwargs`` go there), ``inject_loss``,
    backward, optimizer update of the trainables. Under ``mesh`` the draws
    are the global batch's rows of this shard and the trainables' gradients
    are averaged over the data group (``train_lgp.reduce_step``). -> the
    loss (0-d, fp32, detached; the global batch's under a mesh)."""
    noisy, t, ctx, sk, noise = inject_inputs(frozen, batch, shard=data_shard(mesh), **kwargs)
    loss = inject_loss(unet, clip, noisy, t, ctx, sk, noise)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    loss = reduce_step(mesh, params, loss)
    optimizer.step()
    return loss.detach()
