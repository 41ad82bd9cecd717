"""Single-image LGP evaluation — counterpart of
``sketch2img_tpu/apps/evaluation.py``.

Loads the SD stack and the LGP weights, noises a picture to t=100, runs ONE
UNet pass with taps on the cond context, predicts the edge latent from the
taps, decodes it and binarises the image at 0.5:

    python -m sketch2img_torch.apps.evaluation --model_path sd15/ \\
        --weights edge_predictor.pt --input picture.png --output edges.png
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True,
                        help="diffusers-format SD1.x model dir")
    parser.add_argument("--weights", type=str, default="edge_predictor.pt")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, default="output.png")
    parser.add_argument("--prompt", type=str, default="1girl, masterpiece")
    parser.add_argument("--negative_prompt", type=str,
                        default="bad quality, worst quality, low quality")
    parser.add_argument("--timestep", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    return parser


@torch.no_grad()
def evaluate(components, prompt: str, negative_prompt: str, image01: np.ndarray,
             timestep: int, seed: int = 0, noise: Optional[np.ndarray] = None,
             deterministic_latent: bool = False) -> np.ndarray:
    """image01: (H, W, 3) float in [0, 1] -> the binarised uint8 edge image
    (H, W, 3), on the components' device.

    ``noise`` ((1, 4, h, w), NCHW) gives the diffusion noise, and
    ``deterministic_latent=True`` takes the VAE posterior mean as the latent
    (as the JAX package does: the mean, unscaled) instead of a sample:
    together they make the evaluation draw nothing. Otherwise the sample's
    and the noise's draws come from a CPU generator seeded with ``seed``."""
    from sketch2img_torch.core.schedulers import add_noise, get_noise_level
    from sketch2img_torch.models.unet import concat_taps
    from sketch2img_torch.models.vae import sample_latent
    from sketch2img_torch.pipelines.text2img import latents_to_image
    from sketch2img_torch.runtime import SketchGuidedPipeline

    c = components
    dev = c.device
    _, cond = SketchGuidedPipeline(c).encode_prompt(prompt, negative_prompt)
    px = (image01.astype(np.float32) - 0.5) / 0.5
    px = torch.from_numpy(np.ascontiguousarray(px.transpose(2, 0, 1)[None])).to(dev)
    gen = torch.Generator().manual_seed(seed)
    mean, logvar = c.vae.encode(px)
    if deterministic_latent:
        latents = mean
    else:
        latents = sample_latent(mean, logvar, torch.randn(mean.shape, generator=gen).to(dev))
    if noise is not None:
        noise = torch.as_tensor(np.asarray(noise), dtype=latents.dtype, device=dev)
    else:
        noise = torch.randn(latents.shape, generator=gen).to(dev, latents.dtype)

    t = torch.full((1,), timestep, dtype=torch.long, device=dev)
    noisy = add_noise(c.schedule, latents, noise, t)
    noise_level = get_noise_level(c.schedule, noise, t)
    # the cond half of the reference's CFG-doubled pass: per-sample modules
    # make it independent of the uncond half, so one cond-context pass is exact
    _, taps = c.unet(noisy, t, cond, capture_taps=True)
    edge_latent = c.lgp(concat_taps(taps, latents.shape[2], latents.shape[3]), noise_level)
    img = latents_to_image(c.vae, edge_latent)[0].permute(1, 2, 0).float().cpu().numpy()
    img[img < 0.5] = 0
    return (img * 255).astype(np.uint8)


def main(argv=None) -> None:
    from PIL import Image

    from sketch2img_torch.runtime import SDComponents

    args = get_parser().parse_args(argv)
    c = SDComponents.from_diffusers_dir(args.model_path)
    c.load_lgp_torch(args.weights)

    img = Image.open(args.input).convert("RGB")
    # the shorter side to 512 (LANCZOS), then the top-left crop whose sides
    # are multiples of 64, for the UNet
    w, h = img.size
    scale = 512 / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.LANCZOS)
    w, h = img.size
    img = img.crop((0, 0, (w // 64) * 64, (h // 64) * 64))
    arr = np.asarray(img, np.float32) / 255.0

    out = evaluate(c, args.prompt, args.negative_prompt, arr, args.timestep, args.seed)
    Image.fromarray(out).convert("L").save(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
