"""LGP training — counterpart of ``sketch2img_tpu/apps/train_lgp.py``.

``train_lgp(config, components, gan)`` trains a fresh Latent Edge Predictor
against the frozen SD stack in ``components`` and the anime2sketch
``gan``: ``train.yaml``'s schema, aspect-ratio buckets (``arb``) or the
plain loader, the optional latent cache (``dataset.cache_latents``:
pixels' and sketches' VAE moments once per image, not under ARB),
constant LR after 150 warm-up steps, ``checkpoint_every``, resume, the
``sampling:`` block, checkpoint-on-signal, and at each epoch's end
``edge_predictor.npz`` in ``output_dir`` (the JAX package's npz export,
``{"params", "batch_stats"}``) and, with ``save_torch``,
``edge_predictor.pt``. ``main()`` is the command line: it loads the SD1.x
directory of ``model_path`` and ``netG.pth`` and calls it; under ``torchrun``
it trains data-parallel over every rank (``mesh``: ``batch_size`` is the
global batch, the BatchNorm statistics are the global batch's, rank 0
writes; ``train/loop.py``).

As the JAX app does, ``monitor.wandb_id`` logs loss, learning rate and
images/s to wandb from rank 0 (``import wandb`` raises where it is not
installed), and ``monitor.huggingface_repo`` pushes each epoch's export to
the hub (``utils/hub.push_file``: a failure, such as no network, is printed
and training goes on).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Union

import torch

from sketch2img_torch.core.config import load_config
from sketch2img_torch.core.convert import lgp_to_jax
from sketch2img_torch.core.export import lgp_state, save_torch_state
from sketch2img_torch.models.anime2sketch import load_netg
from sketch2img_torch.models.lgp import LatentEdgePredictor, sync_batch_stats
from sketch2img_torch.models.unet import tap_channels
from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline
from sketch2img_torch.train import loop
from sketch2img_torch.train.checkpoint import export_params_npz
from sketch2img_torch.train.optim import make_lr_schedule, make_optimizer
from sketch2img_torch.train.sampling import TrainingSampler
from sketch2img_torch.train.train_lgp import Frozen, generate_sketch, lgp_train_step
from sketch2img_torch.utils.hub import push_file


def train_lgp(config, components, gan, *, resume: Optional[str] = None,
              max_steps: Optional[int] = None, network_weights: Optional[str] = None,
              sketch_fixed_size: int = 1024, save_torch: bool = False,
              device: Union[str, torch.device] = "cuda", mesh=None,
              log=print) -> loop.TrainResult:
    """Train an LGP (seeded from ``config.seed``, or ``network_weights``, an
    ``edge_predictor.pt``) for ``train_epochs`` epochs or ``max_steps``
    steps; the generator sees the images at ``sketch_fixed_size``^2.
    ``components``: ``runtime.SDComponents`` with a tokenizer, on
    ``device``; ``gan``: the anime2sketch generator there. ``resume``: a
    checkpoint file or directory. ``mesh``: a ``parallel.make_mesh()``
    mesh to train data-parallel over (every rank calls this with the same
    arguments). -> ``TrainResult``; the LGP's weights are in the last
    checkpoint and in ``output_dir/edge_predictor.npz`` (and ``.pt`` with
    ``save_torch``)."""
    cfg = loop.as_config(config)
    c = components
    dev = loop.components_device(c, device)
    data = loop.Data(cfg, c.tokenizer, mesh=mesh)
    devices = [dev] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices), torch.device(dev):
        torch.manual_seed(cfg.seed)
        lgp = LatentEdgePredictor(input_dim=tap_channels(c.unet.config) + 4 + 36)
    if network_weights:
        lgp.load_state_dict(torch.load(network_weights, map_location=dev, weights_only=True),
                            strict=True)
    frozen = Frozen(c.unet, c.vae, c.text_encoder, gan, c.schedule)
    if mesh is not None:
        from sketch2img_torch.parallel.mesh import shard_params

        for m in (lgp, c.unet, c.vae, c.text_encoder, gan):
            shard_params(mesh, m)
        sync_batch_stats(lgp, mesh.data_group)
    lead = loop.is_lead(mesh)

    max_train_steps = cfg.train_epochs * len(data)
    lr = make_lr_schedule("constant_with_warmup", cfg.optimizer.params["lr"], loop.WARMUP_STEPS,
                          max_train_steps)
    opt_params = {k: v for k, v in cfg.optimizer.params.items() if k != "lr"}
    optimizer = make_optimizer(cfg.optimizer.name, lgp.parameters(), lr, **opt_params)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    cache = bool(cfg.get_path("dataset.cache_latents", False)) and not data.arb
    if cache:
        log(f"caching latents for {len(data.dataset)} images ...")
        def sketch_moments(px):
            return torch.cat(c.vae.encode(generate_sketch(gan, px, sketch_fixed_size)), dim=1)

        data.dataset.cache_latents(
            loop.numpy_nchw_fn(lambda px: torch.cat(c.vae.encode(px), dim=1), dev),
            loop.numpy_nchw_fn(sketch_moments, dev))

    sampler = TrainingSampler(cfg.get_path("sampling", {}), c.unet, c.vae,
                              SketchGuidedPipeline(c).encode_prompt, c.schedule)
    out_dir = cfg.get_path("output_dir", ".")

    def step(batch):
        return lgp_train_step(lgp, optimizer, frozen, batch, mesh=mesh, cached_latents=cache,
                              generator=generator, sketch_fixed_size=sketch_fixed_size)

    def state(global_step):
        return {"step": global_step, "lgp": lgp.state_dict(), "optimizer": optimizer.state_dict(),
                "generator": generator.get_state()}

    def load_state(st):
        lgp.load_state_dict(st["lgp"], strict=True)
        optimizer.load_state_dict(st["optimizer"])
        generator.set_state(st["generator"])
        return int(st["step"])

    def on_step(global_step):
        if sampler.should_sample(step=global_step):
            sampler(f"step{global_step}")

    def on_epoch(epoch):
        if sampler.should_sample(epoch=epoch):
            sampler(f"epoch{epoch + 1}")
        os.makedirs(out_dir, exist_ok=True)
        paths = [os.path.join(out_dir, "edge_predictor.npz")]
        export_params_npz(paths[0], lgp_to_jax(lgp.state_dict()))
        if save_torch:
            paths.append(os.path.join(out_dir, "edge_predictor.pt"))
            save_torch_state(paths[1], lgp_state(lgp))
        repo = cfg.get_path("monitor.huggingface_repo", "")
        if repo:  # per-epoch publish; a failure is printed and training goes on
            for path in paths:
                push_file(repo, path, token=cfg.get_path("monitor.huggingface_token"),
                          commit_message=f"add/update model: epoch {epoch}")
        return paths

    monitor = None
    if cfg.get_path("monitor.wandb_id", "") and lead:
        import wandb

        wandb.init(project=cfg.monitor.wandb_id, reinit=False)

        def monitor(global_step, loss, images_per_sec):
            wandb.log({"loss": loss, "lr": float(lr(global_step)),
                       "images_per_sec": images_per_sec}, step=global_step)

    result = loop.run(cfg, data, step=step, state=state, load_state=load_state, device=dev,
                      ckpt_dir=cfg.get_path("checkpoint_dir", "checkpoints/lgp"), resume=resume,
                      max_steps=max_steps, max_train_steps=max_train_steps, on_step=on_step,
                      on_epoch=on_epoch, monitor=monitor, mesh=mesh, log=log)
    result.modules.update(lgp=lgp, optimizer=optimizer)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train the Latent Edge Predictor.")
    ap.add_argument("--config", type=str, default="train.yaml")
    ap.add_argument("--network_weights", type=str, default=None,
                    help="start from these LGP weights (edge_predictor.pt)")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint file or directory to resume from")
    ap.add_argument("--netg", type=str, default="weights/netG.pth",
                    help="anime2sketch generator weights")
    ap.add_argument("--save_torch", action="store_true",
                    help="also write edge_predictor.pt (the reference's torch layout) beside "
                         "edge_predictor.npz")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    config = load_config(args.config)
    mesh = loop.distributed_mesh()
    components = SDComponents.from_diffusers_dir(config.model_path)
    gan = load_netg(args.netg)
    train_lgp(config, components, gan, resume=args.resume, network_weights=args.network_weights,
              save_torch=args.save_torch, mesh=mesh)
    print("done")


if __name__ == "__main__":
    main()
