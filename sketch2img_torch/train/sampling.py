"""Mid-training samples — counterpart of ``sketch2img_tpu/train/sampling.py``:
the ``sampling:`` block of ``train.yaml``. Every ``every_n_steps`` steps or
``every_n_epochs`` epochs, render the configured prompts with the frozen SD
stack (``pipelines/text2img.sample_text2img``, DPM-Solver++) and save PNGs;
with ``use_wandb`` each is also logged to wandb, and a failure there (no
wandb, no network) is swallowed, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sketch2img_torch.pipelines.text2img import latents_to_image, sample_text2img


class TrainingSampler:
    def __init__(self, sampling_cfg: Optional[Dict[str, Any]], unet, vae,
                 encode_prompt: Callable, schedule):
        """``encode_prompt(prompt, negative) -> (uncond, cond)``, as
        ``SketchGuidedPipeline.encode_prompt``."""
        self.cfg = dict(sampling_cfg or {})
        self.enabled = bool(self.cfg.get("enabled", False))
        self.unet, self.vae = unet, vae
        self.encode_prompt = encode_prompt
        self.schedule = schedule

    def should_sample(self, *, step: Optional[int] = None, epoch: Optional[int] = None) -> bool:
        if not self.enabled:
            return False
        if step is not None:
            n = int(self.cfg.get("every_n_steps", -1))
            return n > 0 and step % n == 0
        if epoch is not None:
            n = int(self.cfg.get("every_n_epochs", -1))
            return n > 0 and (epoch + 1) % n == 0
        return False

    @torch.no_grad()
    def __call__(self, tag: str) -> List[str]:
        """Render every prompt (seed ``seed + i``) -> the PNG paths written."""
        from PIL import Image

        cfg = self.cfg
        steps = int(cfg.get("steps", 20))
        h, w = int(cfg.get("height", 512)) // 8, int(cfg.get("width", 512)) // 8
        seed = int(cfg.get("seed", 0))
        negatives = list(cfg.get("negative_prompts", []))
        save_dir = cfg.get("save_dir", "samples")
        os.makedirs(save_dir, exist_ok=True)
        device = next(self.unet.parameters()).device
        paths = []
        for i, prompt in enumerate(cfg.get("prompts", [])):
            uncond, cond = self.encode_prompt(prompt, negatives[i % len(negatives)]
                                              if negatives else "")
            lat0 = torch.randn(1, 4, h, w, generator=torch.Generator().manual_seed(seed + i))
            latents = sample_text2img(self.unet, self.schedule, steps, lat0.to(device),
                                      torch.cat([uncond, cond]), float(cfg.get("cfg_scale", 9)))
            img = latents_to_image(self.vae, latents)[0].permute(1, 2, 0).float().cpu().numpy()
            arr = (img * 255).astype(np.uint8)
            path = os.path.join(save_dir, f"{tag}_{i}.png")
            Image.fromarray(arr).save(path)
            paths.append(path)
            if cfg.get("use_wandb"):
                try:
                    import wandb

                    wandb.log({f"samples/{i}": wandb.Image(arr)})
                except Exception:
                    pass
        return paths
