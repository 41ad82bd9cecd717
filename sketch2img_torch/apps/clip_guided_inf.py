"""CLIP-variant (attention-injection) generation — counterpart of
``sketch2img_tpu/apps/clip_guided_inf.py`` (``ClipGuidedPipeline``).

The SD stack runs with the clip-injection UNet: the sketchpad goes through
the CLIP ViT-L/14 vision encoder, every TransformerBlock attends over its
own tokens and the projected CLIP tokens, and the CFG pair carries the
state [zeros; hidden] at the UI strength. The injected UNet shares the base
UNet's weights (no copy); only the injection blocks are its own. When the
components hold a safety checker it runs on every generation, as in
``SketchGuidedPipeline``. With ``mesh`` (a ``parallel.make_mesh()`` mesh with
a data axis only) it runs data-parallel as ``SketchGuidedPipeline`` does:
rows sharded, a non-dividing batch padded in the per-image-seed mode,
images gathered. ``main()`` is the command-line demo:

    python -m sketch2img_torch.apps.clip_guided_inf --model_path sd15/ \
        --attn_weights sketch_attn_model.pt --clip_weights sketch_encoder_model.pt \
        --prompt "1girl" --sketch sketch.png
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from sketch2img_torch.core.convert import clip_vision_from_jax, injection_from_jax, load_params_npz
from sketch2img_torch.core.manifest import check_state_dict
from sketch2img_torch.models.clip_vision import VIT_L14_CONFIG, CLIPVisionConfig, CLIPVisionEncoder
from sketch2img_torch.models.safety_checker import clip_normalize
from sketch2img_torch.ops.resize import resize_bicubic
from sketch2img_torch.models.unet import SD15_CONFIG, UNet2DCondition, UNetConfig, make_sat
from sketch2img_torch.pipelines.attn_injected import cfg_injection_state, sample_attn_injected
from sketch2img_torch.pipelines.text2img import latents_to_image
from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline, _clean, _frozen
from sketch2img_torch.utils.device import set_deterministic

StateDict = Dict[str, torch.Tensor]
_TORCH_SUFFIXES = (".pt", ".pth", ".bin")


def _load_torch(path: str) -> StateDict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _clean(sd.get("state_dict", sd))


def load_attn_weights(path: str, config: UNetConfig) -> StateDict:
    """Injection weights as the state dict of ``unet.sat``: the reference's
    ``sketch_attn_model.pt`` as it is (held to its manifest for the SD1.5
    clip variant), or a JAX package npz export converted."""
    if path.endswith(_TORCH_SUFFIXES):
        sd = _load_torch(path)
        base = dataclasses.replace(config, injection="none", remat=False,
                                   injection_context_dim=SD15_CONFIG.injection_context_dim)
        if (base == SD15_CONFIG and config.injection == "clip"
                and config.injection_context_dim == VIT_L14_CONFIG.hidden_size):
            check_state_dict("sat_sd15", sd, what=path)
        return sd
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
                 clip_config: CLIPVisionConfig = VIT_L14_CONFIG, mesh=None):
        """Build from a diffusers directory (``model_path``) or share loaded
        ``components``. Without ``attn_weights`` / ``clip_weights`` the
        injection blocks and the CLIP encoder get random weights (seed 0).
        ``mesh``: data-parallel over its data axis; a model axis above 1 is
        refused (the injection blocks would be replicated over head-sliced
        base weights, a combination nothing checks)."""
        if mesh is not None and mesh.shape["model"] > 1:
            raise ValueError(
                "the injection route supports data-parallel meshes only: a model axis > 1 "
                "would merge the replicated sketch_* injection params into Megatron-sharded "
                "base UNet params (untested program). Use model_parallel=1, or serve the "
                "injection route on its own data mesh.")
        self.c = components if components is not None else SDComponents.from_diffusers_dir(
            model_path)
        dev, dt = self.c.device, self.c.unet.dtype
        set_deterministic(dev)
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
            csd = load_clip_weights(clip_weights, clip_config.num_layers)
            if clip_config == VIT_L14_CONFIG:
                check_state_dict("clip_vision_l14", csd, what=clip_weights)
            clip.load_state_dict(csd, strict=True)
        self.clip = _frozen(clip, dev).to(dt)
        self.mesh = mesh
        self._dp = 1
        if mesh is not None:
            from sketch2img_torch.parallel.mesh import shard_params

            self._dp = mesh.shape["data"]
            for m in (self.unet, self.clip, self.c.vae, self.c.text_encoder,
                      self.c.safety_checker):
                if m is not None:
                    shard_params(mesh, m)
        # the helper's noise, prompt encoding, padding, rows and gather serve
        # this pipeline too; it shares the mesh without its own set-up (the
        # weights were replicated above)
        self._helper = SketchGuidedPipeline(self.c)
        self._helper.mesh, self._helper._dp = mesh, self._dp
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
        helper = self._helper
        pad, seed, spimg = helper._pad_for_mesh(batch, seed, spimg)
        if pad and isinstance(strength, (list, tuple)):
            strength = list(strength) + [0.0] * pad
        batch_p = batch + pad
        f = self.c.vae_scale_factor
        latents0, _ = helper._initial_noise(seed, batch_p, height // f, width // f, 0)
        uncond, cond = helper._shard_pair(*helper.encode_prompt(prompt, negative_prompt), pad)
        latents0 = helper._shard_batch(latents0)
        local = latents0.shape[0]
        if isinstance(strength, (list, tuple)):
            strength = helper._shard_batch(list(strength))
        if spimg is not None:
            if isinstance(spimg, (list, tuple)):
                spimg = helper._shard_batch(list(spimg))
            hidden = self.encode_sketch(spimg)
            state = cfg_injection_state(hidden.expand(local, -1, -1))
            scale = torch.as_tensor(strength, dtype=torch.float32)
        else:
            state = torch.zeros(2 * local, self.clip_config.num_tokens,
                                self.clip_config.hidden_size, device=self.c.device,
                                dtype=self.unet.dtype)
            scale = 0.0
        latents = sample_attn_injected(self.unet, self.c.schedule, num_inference_steps,
                                       latents0, torch.cat([uncond, cond]), state, scale,
                                       guidance_scale)
        img = helper._finish(latents_to_image(self.c.vae, latents), batch)
        self.last_nsfw_flags = helper.last_nsfw_flags
        return img[0] if isinstance(prompt, str) else img


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--attn_weights", type=str, default=None)
    parser.add_argument("--clip_weights", type=str, default=None)
    parser.add_argument("--prompt", type=str, required=True)
    parser.add_argument("--negative_prompt", type=str, default="")
    parser.add_argument("--sketch", type=str, default=None)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--guidance", type=float, default=7.5)
    parser.add_argument("--strength", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", type=str, default="output.png")
    args = parser.parse_args(argv)

    from PIL import Image

    start = time.time()
    pipe = ClipGuidedPipeline(args.model_path, args.attn_weights, args.clip_weights)
    print(f"pipeline built in {time.time() - start:.2f} seconds")

    spimg = None
    if args.sketch:
        spimg = np.asarray(Image.open(args.sketch).convert("L"), np.float32) / 255.0
    img = pipe(args.prompt, negative_prompt=args.negative_prompt,
               num_inference_steps=args.steps, guidance_scale=args.guidance,
               strength=args.strength, seed=args.seed, spimg=spimg)
    Image.fromarray((img * 255).astype(np.uint8)).save(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
