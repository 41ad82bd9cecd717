"""CLIP-variant (attention-injection) generation — counterpart of
``sketch2img_tpu/apps/clip_guided_inf.py`` (``ClipGuidedPipeline``), without
the mesh.

The SD stack runs with the clip-injection UNet: the sketchpad goes through
the CLIP ViT-L/14 vision encoder, every TransformerBlock attends over its
own tokens and the projected CLIP tokens, and the CFG pair carries the
state [zeros; hidden] at the UI strength. The injected UNet shares the base
UNet's weights (no copy); only the injection blocks are its own. When the
components hold a safety checker it runs on every generation, as in
``SketchGuidedPipeline``. The command-line demo comes with the apps slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from sketch2img_torch.core.convert import clip_vision_from_jax, injection_from_jax, load_params_npz
from sketch2img_torch.models.clip_vision import VIT_L14_CONFIG, CLIPVisionConfig, CLIPVisionEncoder
from sketch2img_torch.models.safety_checker import clip_normalize, resize_bicubic
from sketch2img_torch.models.unet import UNet2DCondition, UNetConfig, make_sat
from sketch2img_torch.pipelines.attn_injected import cfg_injection_state, sample_attn_injected
from sketch2img_torch.pipelines.text2img import latents_to_image
from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline, _clean, _frozen

StateDict = Dict[str, torch.Tensor]
_TORCH_SUFFIXES = (".pt", ".pth", ".bin")


def _load_torch(path: str) -> StateDict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _clean(sd.get("state_dict", sd))


def load_attn_weights(path: str, config: UNetConfig) -> StateDict:
    """Injection weights as the state dict of ``unet.sat``: the reference's
    ``sketch_attn_model.pt`` as it is, or a JAX package npz export converted."""
    if path.endswith(_TORCH_SUFFIXES):
        return _load_torch(path)
    return injection_from_jax(load_params_npz(path), config)


def load_clip_weights(path: str, num_layers: int) -> StateDict:
    """CLIP vision weights as a ``CLIPVisionEncoder`` state dict: the
    reference's ``sketch_encoder_model.pt`` (a transformers
    ``CLIPVisionModel`` state dict) as it is, or a JAX package npz export."""
    if path.endswith(_TORCH_SUFFIXES):
        return _load_torch(path)
    return clip_vision_from_jax(load_params_npz(path), num_layers)


def preprocess_sketch(spimg01, image_size: int, device) -> torch.Tensor:
    """One sketchpad in [0, 1] ((H, W), (H, W, 3) or RGBA) -> (3, S, S)
    CLIP pixels. As the JAX package does with PIL: quantise to uint8 (by
    truncation), bicubic resize to S x S, then the CLIP mean/std. PIL's
    filter is Keys a = -0.5, antialiased (PyTorch's antialiased bicubic),
    run as a horizontal then a vertical pass that each round and clip to
    uint8 levels; so are the two passes here (within one level of PIL)."""
    arr = np.asarray(spimg01, np.float32)
    if arr.ndim == 2:
        arr = np.tile(arr[:, :, None], (1, 1, 3))
    elif arr.shape[-1] == 4:
        arr = arr[..., :3]
    x = torch.from_numpy((arr * 255).astype(np.uint8)).to(device).permute(2, 0, 1)[None]
    x = resize_bicubic(x.float(), x.shape[2], image_size).round().clamp(0, 255)
    x = resize_bicubic(x, image_size, image_size).round().clamp(0, 255)
    return clip_normalize(x / 255.0)[0]


class ClipGuidedPipeline:
    def __init__(self, model_path: Optional[str] = None, attn_weights: Optional[str] = None,
                 clip_weights: Optional[str] = None, *,
                 components: Optional[SDComponents] = None,
                 clip_config: CLIPVisionConfig = VIT_L14_CONFIG):
        """Build from a diffusers directory (``model_path``) or share loaded
        ``components``. Without ``attn_weights`` / ``clip_weights`` the
        injection blocks and the CLIP encoder get random weights (seed 0)."""
        self.c = components if components is not None else SDComponents.from_diffusers_dir(
            model_path)
        dev, dt = self.c.device, self.c.unet.dtype
        self.clip_config = clip_config
        inj_config = dataclasses.replace(self.c.unet.config, injection="clip",
                                         injection_context_dim=clip_config.hidden_size)
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.device(dev):
            torch.manual_seed(0)
            sat = (load_attn_weights(attn_weights, inj_config) if attn_weights
                   else make_sat(inj_config).state_dict())
            clip = CLIPVisionEncoder(clip_config)
        with torch.device("meta"):
            self.unet = UNet2DCondition(inj_config)
        sd = dict(self.c.unet.state_dict())  # the base weights, shared
        sd.update({"sat." + k: v.to(dev, dt) for k, v in sat.items()})
        self.unet.load_state_dict(sd, strict=True, assign=True)
        self.unet = _frozen(self.unet, dev)
        if clip_weights:
            clip.load_state_dict(load_clip_weights(clip_weights, clip_config.num_layers),
                                 strict=True)
        self.clip = _frozen(clip, dev).to(dt)
        self._helper = SketchGuidedPipeline(self.c)
        self.last_nsfw_flags: Optional[np.ndarray] = None

    @torch.no_grad()
    def encode_sketch(self, spimg01) -> torch.Tensor:
        """One sketch -> (1, S, D) last_hidden_state; a list of per-image
        sketches (any resolutions) -> (B, S, D), in one encoder call."""
        size, dev = self.clip_config.image_size, self.c.device
        sketches = spimg01 if isinstance(spimg01, (list, tuple)) else [spimg01]
        return self.clip(torch.stack([preprocess_sketch(s, size, dev) for s in sketches]))

    @torch.no_grad()
    def __call__(self, prompt, *, negative_prompt="", num_inference_steps: int = 25,
                 guidance_scale: float = 7.5, width: int = 512, height: int = 512, seed=0,
                 strength=0.5, spimg=None) -> np.ndarray:
        """-> (H, W, 3) float image in [0, 1] for one string prompt, else
        (B, H, W, 3). ``seed``: one seed (one generator for the batch) or one
        per image; ``spimg``: one sketch for every image, a list of B, or
        None (zero state at scale 0 through the injected UNet);
        ``strength``: one float or B of them."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch = len(prompts)
        if isinstance(spimg, (list, tuple)) and len(spimg) != batch:
            raise ValueError(f"got {len(spimg)} sketches for a batch of {batch}")
        if isinstance(strength, (list, tuple)) and len(strength) != batch:
            raise ValueError(f"got {len(strength)} strengths for a batch of {batch}")
        f = self.c.vae_scale_factor
        latents0, _ = self._helper._initial_noise(seed, batch, height // f, width // f, 0)
        uncond, cond = self._helper.encode_prompt(prompt, negative_prompt)
        if spimg is not None:
            hidden = self.encode_sketch(spimg)
            state = cfg_injection_state(hidden.expand(batch, -1, -1))
            scale = torch.as_tensor(strength, dtype=torch.float32)
        else:
            state = torch.zeros(2 * batch, self.clip_config.num_tokens,
                                self.clip_config.hidden_size, device=self.c.device,
                                dtype=self.unet.dtype)
            scale = 0.0
        latents = sample_attn_injected(self.unet, self.c.schedule, num_inference_steps,
                                       latents0, torch.cat([uncond, cond]), state, scale,
                                       guidance_scale)
        img = latents_to_image(self.c.vae, latents)
        img, self.last_nsfw_flags = self.c.run_safety_checker(img)
        img = img.permute(0, 2, 3, 1).float().cpu().numpy()
        return img[0] if isinstance(prompt, str) else img
