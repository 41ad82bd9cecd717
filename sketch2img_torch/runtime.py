"""High-level runtime of the port: assemble the SD1.x stack and expose the
user-facing sketch-guided pipeline — counterpart of ``sketch2img_tpu/runtime.py``.

``SDComponents`` holds the modules (UNet, VAE, CLIP text encoder, optional
LGP and safety checker), the schedule and the tokenizer, all on one device, frozen
(``requires_grad_(False)``) and in eval mode: the guided backward then
computes the gradient with respect to the latent and no weight gradient.
``SketchGuidedPipeline.__call__`` is the reference demo's call signature;
when a safety checker is loaded it runs on every generation and blacks out
flagged images (``last_nsfw_flags``). Everything defaults to ``device="cuda"`` and raises without a GPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from sketch2img_torch.core.schedulers import DiffusionSchedule, make_schedule
from sketch2img_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder, SD15_TEXT_CONFIG
from sketch2img_torch.models.clip_vision import VIT_L14_CONFIG, CLIPVisionConfig
from sketch2img_torch.models.lgp import LatentEdgePredictor
from sketch2img_torch.models.safety_checker import SafetyChecker
from sketch2img_torch.models.unet import SD15_CONFIG, UNet2DCondition, UNetConfig, tap_channels
from sketch2img_torch.models.vae import SD15_VAE_CONFIG, AutoencoderKL, VAEConfig, sample_latent
from sketch2img_torch.pipelines.sketch_guided import sample_sketch_guided
from sketch2img_torch.pipelines.text2img import latents_to_image, sample_text2img
from sketch2img_torch.utils.device import resolve_device, set_precision

# checkpoint keys that carry no weight (old transformers / BatchNorm bookkeeping)
_IGNORED_SUFFIXES = ("position_ids",)
# newer diffusers VAE attention names -> the SD1.x names the port keeps
_VAE_ATTN_RENAMES = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
                     ".to_out.0.": ".proj_attn."}


def canon_seed(seed) -> int:
    """Fold an int seed into the non-negative int32 range."""
    return int(seed) & 0x7FFFFFFF


def _load_state_dict(path_base: str) -> Dict[str, torch.Tensor]:
    """Load <base>.safetensors or <base>.bin (torch pickle)."""
    st = path_base + ".safetensors"
    if os.path.exists(st):
        from safetensors.torch import load_file

        return load_file(st)
    if os.path.exists(path_base + ".bin"):
        return torch.load(path_base + ".bin", map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no checkpoint at {path_base}.(safetensors|bin)")


def _clean(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        if k.endswith(_IGNORED_SUFFIXES):
            continue
        if ".mid_block.attentions.0." in k:
            for new, old in _VAE_ATTN_RENAMES.items():
                k = k.replace(new, old)
        out[k] = v
    return out


def _frozen(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    return module.to(device).eval().requires_grad_(False)


@dataclasses.dataclass
class SDComponents:
    """Frozen SD1.x modules on one device, plus schedule, tokenizer and LGP."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    schedule: DiffusionSchedule
    device: torch.device
    tokenizer: Any = None
    lgp: Optional[LatentEdgePredictor] = None
    safety_checker: Optional[SafetyChecker] = None

    @classmethod
    def random_init(
        cls,
        *,
        seed: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        unet_config: UNetConfig = SD15_CONFIG,
        vae_config: VAEConfig = SD15_VAE_CONFIG,
        text_config: CLIPTextConfig = SD15_TEXT_CONFIG,
        lgp: bool = True,
        device: Union[str, torch.device] = "cuda",
    ) -> "SDComponents":
        """Seeded random weights at the given architecture (PyTorch's default
        initialisers, drawn on ``device``). The LGP, sized to the UNet's taps,
        stays fp32; the other modules are cast to ``compute_dtype``."""
        dev = resolve_device(device)
        set_precision()
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.device(dev):
            torch.manual_seed(seed)
            unet = UNet2DCondition(unet_config)
            vae = AutoencoderKL(vae_config)
            text = CLIPTextEncoder(text_config)
            head = (LatentEdgePredictor(input_dim=tap_channels(unet_config) + 4 + 36)
                    if lgp else None)
        c = cls(unet=_frozen(unet, dev), vae=_frozen(vae, dev), text_encoder=_frozen(text, dev),
                schedule=make_schedule(), device=dev,
                lgp=_frozen(head, dev) if head is not None else None)
        return c.cast_params(compute_dtype)

    @classmethod
    def from_diffusers_dir(
        cls,
        model_path: str,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
        unet_config: UNetConfig = SD15_CONFIG,
        vae_config: VAEConfig = SD15_VAE_CONFIG,
        text_config: CLIPTextConfig = SD15_TEXT_CONFIG,
        device: Union[str, torch.device] = "cuda",
    ) -> "SDComponents":
        """Load a diffusers-format SD1.x directory (unet/, vae/, text_encoder/,
        tokenizer/ and, where present, safety_checker/) with strict
        ``load_state_dict``."""
        from sketch2img_torch.data.tokenizer import CLIPBPETokenizer

        dev = resolve_device(device)
        set_precision()
        with torch.device("meta"):
            unet = UNet2DCondition(unet_config)
            vae = AutoencoderKL(vae_config)
            text = CLIPTextEncoder(text_config)
        for module, sub in ((unet, "unet/diffusion_pytorch_model"),
                            (vae, "vae/diffusion_pytorch_model"),
                            (text, "text_encoder/model")):
            sd = _clean(_load_state_dict(os.path.join(model_path, sub)))
            module.load_state_dict(sd, strict=True, assign=True)
        tok_dir = os.path.join(model_path, "tokenizer")
        tokenizer = CLIPBPETokenizer.from_pretrained(tok_dir) if os.path.isdir(tok_dir) else None
        c = cls(unet=_frozen(unet, dev), vae=_frozen(vae, dev), text_encoder=_frozen(text, dev),
                schedule=make_schedule(), device=dev, tokenizer=tokenizer)
        if os.path.isdir(os.path.join(model_path, "safety_checker")):
            c.load_safety_checker(os.path.join(model_path, "safety_checker"))
        return c.cast_params(compute_dtype)

    def load_safety_checker(self, path: str,
                            vision_config: CLIPVisionConfig = VIT_L14_CONFIG) -> None:
        """Load the diffusers ``safety_checker/`` weights (a directory with
        model.safetensors, model.bin or pytorch_model.bin, or a file path
        without its extension) strictly, in the UNet's dtype."""
        base = path
        if os.path.isdir(path):
            base = os.path.join(path, "model")
            if not any(os.path.exists(base + e) for e in (".safetensors", ".bin")):
                base = os.path.join(path, "pytorch_model")
        sd = _clean(_load_state_dict(base))
        n_concepts, proj_dim = sd["concept_embeds"].shape
        with torch.device("meta"):
            checker = SafetyChecker(vision_config, proj_dim, n_concepts,
                                    sd["special_care_embeds"].shape[0])
        checker.load_state_dict(sd, strict=True, assign=True)
        self.safety_checker = _frozen(checker, self.device).to(self.unet.dtype)

    def random_safety_checker(self, seed: int = 0,
                              vision_config: CLIPVisionConfig = VIT_L14_CONFIG) -> None:
        """A safety checker on seeded random weights (for tests and the card
        while the published weights are not in the repository)."""
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.device(self.device):
            torch.manual_seed(seed)
            checker = SafetyChecker(vision_config)
        self.safety_checker = _frozen(checker, self.device).to(self.unet.dtype)

    def run_safety_checker(self, images01: torch.Tensor
                           ) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
        """(B, 3, H, W) in [0, 1] -> (images with flagged ones blacked out,
        (B,) bool flags), or (images, None) when no checker is loaded."""
        if self.safety_checker is None:
            return images01, None
        img, flags = self.safety_checker.check_images(images01)
        flags = flags.cpu().numpy()
        if flags.any():
            print("Potential NSFW content was detected in one or more images. "
                  "A black image will be returned instead.")
        return img, flags

    def load_lgp_torch(self, path: str) -> None:
        """Load the published ``edge_predictor.pt`` strictly (kept fp32)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        lgp = LatentEdgePredictor(input_dim=sd["layers.0.weight"].shape[1],
                                  output_dim=sd["layers.12.weight"].shape[0])
        lgp.load_state_dict(sd, strict=True)
        self.lgp = _frozen(lgp, self.device)

    def cast_params(self, dtype: torch.dtype = torch.bfloat16) -> "SDComponents":
        """Cast the UNet, VAE, text encoder and safety checker to ``dtype``
        once; the LGP stays fp32."""
        for m in (self.unet, self.vae, self.text_encoder, self.safety_checker):
            if m is not None:
                m.to(dtype)
        return self

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae.config.block_out_channels) - 1)


class SketchGuidedPipeline:
    """User-facing pipeline: prompt or prompt list, ``num_images_per_prompt``,
    scalar or per-image seeds, one sketch or a list of per-image sketches,
    ``solver``, ``callback(i, t, latents)`` every ``callback_steps`` steps."""

    def __init__(self, components: SDComponents):
        self.c = components
        self.last_nsfw_flags: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.c.device

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt="",
                      num_images_per_prompt: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (uncond, cond), each (P * num_images_per_prompt, 77, 768)."""
        tok = self.c.tokenizer
        if tok is None:
            raise ValueError("no tokenizer loaded: set components.tokenizer")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        if len(negs) != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts but {len(negs)} negative prompts")

        def encode(texts):
            ids = tok(texts, padding="max_length", truncation=True, max_length=77).input_ids
            return self.c.text_encoder(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                                       device=self.device))

        cond, uncond = encode(prompts), encode(negs)
        if num_images_per_prompt != 1:
            cond = cond.repeat_interleave(num_images_per_prompt, dim=0)
            uncond = uncond.repeat_interleave(num_images_per_prompt, dim=0)
        return uncond, cond

    @staticmethod
    def _norm_sketch(sketch01) -> np.ndarray:
        """One sketchpad [0, 1] -> (3, H, W) in [-1, 1]; (H, W) and (H, W, 1)
        grayscale are tiled to three channels."""
        arr = np.asarray(sketch01, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[-1] == 1:
            arr = np.tile(arr, (1, 1, 3))
        elif arr.shape[-1] != 3:
            raise ValueError(f"sketch_image must be (H,W), (H,W,1) or (H,W,3); got {arr.shape}")
        return ((arr - 0.5) / 0.5).transpose(2, 0, 1)

    @torch.no_grad()
    def sketch_moments(self, sketch01) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sketch (leading dim 1 out) or a list of per-image sketches ->
        VAE (mean, logvar)."""
        if isinstance(sketch01, (list, tuple)):
            arrs = [self._norm_sketch(s) for s in sketch01]
            if len({a.shape for a in arrs}) != 1:
                raise ValueError("per-image sketches must share one resolution")
            arr = np.stack(arrs)
        else:
            arr = self._norm_sketch(sketch01)[None]
        return self.c.vae.encode(torch.as_tensor(arr, device=self.device))

    def _initial_noise(self, seed, batch: int, h: int, w: int, n_sketch: int):
        """-> (latents0 (B, 4, h, w), sketch noise (n_sketch, 4, h, w) or
        None). A scalar seed drives one generator for the whole batch; a list
        gives image i a generator of its own, so its result depends on
        seed[i] alone. Noise is drawn on the CPU, so a seed gives the same
        noise on every device."""
        def gen_for(s):
            s = canon_seed(s) if s != 0 else int(np.random.randint(2**31 - 1))
            return torch.Generator().manual_seed(s)

        def randn(n, gen):
            return torch.randn(n, 4, h, w, generator=gen)

        if isinstance(seed, (list, tuple)):
            if len(seed) != batch:
                raise ValueError(f"got {len(seed)} seeds for a batch of {batch}")
            gens = [gen_for(s) for s in seed]
            lat = torch.cat([randn(1, g) for g in gens])
            noise = torch.cat([randn(1, g) for g in gens]) if n_sketch else None
        else:
            gen = gen_for(seed)
            lat = randn(batch, gen)
            noise = randn(n_sketch, gen) if n_sketch else None
        return lat.to(self.device), (noise.to(self.device) if noise is not None else None)

    def __call__(
        self,
        prompt,
        *,
        negative_prompt="",
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        width: int = 512,
        height: int = 512,
        seed=0,
        sketch_image=None,
        num_images_per_prompt: int = 1,
        eta: float = 0.0,
        solver: str = "dpm++",
        callback=None,
        callback_steps: int = 1,
        remat: Optional[bool] = None,
    ) -> np.ndarray:
        """-> (H, W, 3) float image in [0, 1] for one string prompt and one
        image per prompt, else (B, H, W, 3). ``eta`` is accepted for API
        parity and unused. ``remat``: only None/False (no recomputation) is
        supported so far."""
        del eta
        if remat:
            raise NotImplementedError("remat=True is not ported yet")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch = len(prompts) * num_images_per_prompt
        single = isinstance(prompt, str) and num_images_per_prompt == 1
        f = self.c.vae_scale_factor
        h, w = height // f, width // f

        if sketch_image is not None and isinstance(sketch_image, (list, tuple)):
            if len(sketch_image) != batch:
                raise ValueError(f"got {len(sketch_image)} sketches for a batch of {batch}")
        per_image = isinstance(seed, (list, tuple))
        n_noise = 0
        if sketch_image is not None:
            n_noise = batch if per_image or isinstance(sketch_image, (list, tuple)) else 1
        latents0, noise = self._initial_noise(seed, batch, h, w, n_noise)
        uncond, cond = self.encode_prompt(prompt, negative_prompt, num_images_per_prompt)

        if sketch_image is not None:
            if self.c.lgp is None:
                raise ValueError("sketch guidance needs an LGP: load_lgp_torch or random_init")
            mean, logvar = self.sketch_moments(sketch_image)  # (1 or B, 4, h, w)
            target = sample_latent(mean, logvar, noise).expand(batch, -1, -1, -1)
            latents = sample_sketch_guided(
                self.c.unet, self.c.lgp, self.c.schedule, num_inference_steps, latents0,
                uncond, cond, target, guidance_scale, solver=solver,
                callback=callback, callback_steps=callback_steps)
        else:
            latents = sample_text2img(
                self.c.unet, self.c.schedule, num_inference_steps, latents0,
                torch.cat([uncond, cond]), guidance_scale, solver=solver,
                callback=callback, callback_steps=callback_steps)
        with torch.no_grad():
            img = latents_to_image(self.c.vae, latents)
        img, self.last_nsfw_flags = self.c.run_safety_checker(img)
        img = img.permute(0, 2, 3, 1).float().cpu().numpy()
        return img[0] if single else img
