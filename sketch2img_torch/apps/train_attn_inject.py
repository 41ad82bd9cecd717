"""Attention-injection training — counterpart of
``sketch2img_tpu/apps/train_attn_inject.py``.

``train_attn_inject(config, components, gan, clip_vision)`` trains fresh
injection blocks (seeded from ``config.seed``) in a clip-injected UNet over
the frozen base weights of ``components.unet``, and the CLIP vision tower
(``clip_vision``, or a fresh ViT-L/14 from seed 0), with eps-MSE: fp32
master weights and the base UNet's compute dtype, cosine LR with restarts
after 150 warm-up steps, the optional latent cache
(``dataset.cache_latents``: VAE moments and the CLIP pixels of the sketch
once per image), ``checkpoint_every``, resume and checkpoint-on-signal;
``sketch_attn_model.npz`` and ``sketch_encoder_model.npz`` (the JAX
package's npz exports) in ``output_dir`` at the end and, with
``save_torch``, ``sketch_attn_model.pt`` and ``sketch_encoder_model.pt``.
``main()`` is the command line; under ``torchrun`` it trains data-parallel
over every rank (``mesh``: ``batch_size`` is the global batch, the
gradients are averaged over the ranks, rank 0 writes; ``train/loop.py``).
Like the JAX app, it reads neither ``monitor.wandb_id`` nor
``monitor.huggingface_repo``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Union

import torch

from sketch2img_torch.apps.clip_guided_inf import load_clip_weights
from sketch2img_torch.core.config import load_config
from sketch2img_torch.core.convert import clip_vision_to_jax, injection_to_jax
from sketch2img_torch.core.export import clip_vision_state, sat_state, save_torch_state
from sketch2img_torch.models.anime2sketch import load_netg
from sketch2img_torch.models.clip_vision import VIT_L14_CONFIG, CLIPVisionEncoder
from sketch2img_torch.models.unet import UNet2DCondition, make_sat
from sketch2img_torch.runtime import SDComponents
from sketch2img_torch.train import loop
from sketch2img_torch.train.checkpoint import export_params_npz
from sketch2img_torch.train.optim import make_lr_schedule, make_optimizer
from sketch2img_torch.train.train_attn_inject import (
    inject_train_step,
    mark_trainables,
    sketch_to_clip_pixels,
)
from sketch2img_torch.train.train_lgp import Frozen


def injected_unet(components, clip_hidden: int, seed: int) -> UNet2DCondition:
    """A clip-injected UNet whose base parameters are ``components.unet``'s
    (shared, not copied) and whose injection blocks are fresh, fp32, drawn
    from ``seed`` on the components' device."""
    dev = components.device
    config = dataclasses.replace(components.unet.config, injection="clip",
                                 injection_context_dim=clip_hidden)
    devices = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices), torch.device(dev):
        torch.manual_seed(seed)
        sat = make_sat(config)
    with torch.device("meta"):
        unet = UNet2DCondition(config)
    sd = dict(components.unet.state_dict())
    sd.update({"sat." + k: v for k, v in sat.state_dict().items()})
    unet.load_state_dict(sd, strict=True, assign=True)
    return unet.eval()


def train_attn_inject(config, components, gan, clip_vision: Optional[CLIPVisionEncoder] = None,
                      *, resume: Optional[str] = None, max_steps: Optional[int] = None,
                      sketch_fixed_size: int = 512, save_torch: bool = False,
                      device: Union[str, torch.device] = "cuda", mesh=None,
                      log=print) -> loop.TrainResult:
    """Train the injection blocks and ``clip_vision`` (moved to fp32 on
    ``device``; None: a ViT-L/14 from seed 0) for ``train_epochs`` epochs or
    ``max_steps`` steps; the generator sees the images at
    ``sketch_fixed_size``^2. ``components``: ``runtime.SDComponents`` with a
    tokenizer, on ``device``; ``gan``: the anime2sketch generator there.
    ``mesh``: a ``parallel.make_mesh()`` mesh to train data-parallel over
    (every rank calls this with the same arguments). -> ``TrainResult``
    with ``modules`` "unet", "clip", "optimizer"."""
    cfg = loop.as_config(config)
    c = components
    dev = loop.components_device(c, device)
    if clip_vision is None:
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.device(dev):
            torch.manual_seed(0)
            clip_vision = CLIPVisionEncoder(VIT_L14_CONFIG)
    clip = clip_vision.to(dev, torch.float32)
    unet = injected_unet(c, clip.config.hidden_size, cfg.seed)
    if mesh is not None:
        from sketch2img_torch.parallel.mesh import shard_params

        for m in (unet, clip, c.vae, c.text_encoder, gan):
            shard_params(mesh, m)
    trainables = mark_trainables(unet, clip)
    data = loop.Data(cfg, c.tokenizer, allow_arb=False, mesh=mesh)
    frozen = Frozen(None, c.vae, c.text_encoder, gan, c.schedule)

    max_train_steps = cfg.train_epochs * len(data)
    lr = make_lr_schedule("cosine_with_restarts", cfg.optimizer.params["lr"], loop.WARMUP_STEPS,
                          max_train_steps)
    opt_params = {k: v for k, v in cfg.optimizer.params.items() if k != "lr"}
    optimizer = make_optimizer(cfg.optimizer.name, trainables.values(), lr, **opt_params)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    sketch_kw = dict(sketch_fixed_size=sketch_fixed_size, clip_image_size=clip.config.image_size)
    cache = bool(cfg.get_path("dataset.cache_latents", False))
    if cache:
        log(f"caching latents for {len(data.dataset)} images ...")
        data.dataset.cache_latents(
            loop.numpy_nchw_fn(lambda px: torch.cat(c.vae.encode(px), dim=1), dev),
            loop.numpy_nchw_fn(lambda px: sketch_to_clip_pixels(gan, px, **sketch_kw), dev),
            sketch_key="sketch_clip_pixels")
    out_dir = cfg.get_path("output_dir", ".")

    def step(batch):
        return inject_train_step(unet, clip, optimizer, frozen, batch, mesh=mesh,
                                 cached_latents=cache, generator=generator, **sketch_kw)

    def state(global_step):
        return {"step": global_step, "sat": unet.sat.state_dict(), "clip": clip.state_dict(),
                "optimizer": optimizer.state_dict(), "generator": generator.get_state()}

    def load_state(st):
        unet.sat.load_state_dict(st["sat"], strict=True)
        clip.load_state_dict(st["clip"], strict=True)
        optimizer.load_state_dict(st["optimizer"])
        generator.set_state(st["generator"])
        return int(st["step"])

    def on_end():
        os.makedirs(out_dir, exist_ok=True)
        paths = [os.path.join(out_dir, "sketch_encoder_model.npz"),
                 os.path.join(out_dir, "sketch_attn_model.npz")]
        export_params_npz(paths[0], clip_vision_to_jax(clip.state_dict(),
                                                       clip.config.num_layers))
        export_params_npz(paths[1], injection_to_jax(unet.sat.state_dict(), unet.config))
        if save_torch:
            paths += [os.path.join(out_dir, "sketch_attn_model.pt"),
                      os.path.join(out_dir, "sketch_encoder_model.pt")]
            save_torch_state(paths[2], sat_state(unet))
            save_torch_state(paths[3], clip_vision_state(clip))
        return paths

    result = loop.run(cfg, data, step=step, state=state, load_state=load_state, device=dev,
                      ckpt_dir=cfg.get_path("checkpoint_dir", "checkpoints/attn_inject"),
                      resume=resume, max_steps=max_steps, max_train_steps=max_train_steps,
                      on_end=on_end, mesh=mesh, log=log)
    result.modules.update(unet=unet, clip=clip, optimizer=optimizer)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train the attention-injection blocks and the "
                                             "CLIP sketch encoder.")
    ap.add_argument("--config", type=str, default="train.yaml")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint file or directory to resume from")
    ap.add_argument("--netg", type=str, default="weights/netG.pth",
                    help="anime2sketch generator weights")
    ap.add_argument("--clip_vision", type=str, default=None,
                    help="CLIP ViT-L/14 weights (a CLIPVisionModel state dict, .pt/.bin)")
    ap.add_argument("--save_torch", action="store_true",
                    help="also write sketch_attn_model.pt and sketch_encoder_model.pt (the "
                         "reference's torch layouts) beside the npz exports")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    config = load_config(args.config)
    mesh = loop.distributed_mesh()
    components = SDComponents.from_diffusers_dir(config.model_path)
    gan = load_netg(args.netg)
    clip = None
    if args.clip_vision:
        with torch.device("meta"):
            clip = CLIPVisionEncoder(VIT_L14_CONFIG)
        clip.load_state_dict(load_clip_weights(args.clip_vision, VIT_L14_CONFIG.num_layers),
                             strict=True, assign=True)
    train_attn_inject(config, components, gan, clip, resume=args.resume,
                      save_torch=args.save_torch, mesh=mesh)
    print("done")


if __name__ == "__main__":
    main()
