"""LGP training step — counterpart of ``sketch2img_tpu/train/train_lgp.py``.

One step (``lgp_train_step``):
  1. encode the text (chunked CLIP, ``encode_tokens_static``), VAE-encode
     the pixels and the anime2sketch sketch of them — all frozen, no grad;
  2. noise the latents at a uniform random timestep and build the
     noise-level map;
  3. run the frozen UNet with taps (eps discarded) and concatenate the taps;
  4. run the LGP in train mode (batch-statistics BatchNorm, running stats
     updated as flax does) and take the MSE against the sketch latents;
  5. update the LGP alone.

Randomness: the latent-sample noise, the sketch-latent noise, the diffusion
noise and the timesteps are drawn from ``generator`` unless the caller
passes them (``draws``; the tests pass the JAX step's draws). Tensors are
NCHW on the frozen modules' device; the LGP stays fp32.

Data parallel (``mesh``, a ``parallel.make_mesh()`` mesh): each rank holds
its shard of the global batch (the loader's rows index::count of it), draws
the global batch's noise and timesteps from the same step generator and
keeps its own rows, takes BatchNorm statistics over the global batch
(``models.lgp.sync_batch_stats``), and averages the gradients over the data
group before the update; the returned loss is the global batch's. A
two-rank step is then the one-rank step on the same global batch, to the
summation order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from sketch2img_torch.core.schedulers import DiffusionSchedule, add_noise, get_noise_level
from sketch2img_torch.models.anime2sketch import binarize_sketch
from sketch2img_torch.models.unet import concat_taps
from sketch2img_torch.models.vae import sample_latent
from sketch2img_torch.ops.resize import resize_bicubic


@dataclasses.dataclass
class Frozen:
    """The frozen modules a train step runs: UNet, VAE, CLIP text encoder,
    anime2sketch generator, and the diffusion schedule."""

    unet: Any
    vae: Any
    text_encoder: Any
    gan: Any
    schedule: DiffusionSchedule


def generate_sketch(gan, px: torch.Tensor, fixed: int = 1024,
                    binarize: bool = True) -> torch.Tensor:
    """px (B, 3, H, W) in [-1, 1] -> (B, 3, H, W) sketch in [0, 1]: bicubic
    resize to fixed^2, the generator, invert, threshold at 0.5 (``binarize``),
    tile to three channels, bicubic back to H x W. fp32 out."""
    b, _, h, w = px.shape
    big = resize_bicubic(px.float(), fixed, fixed)
    raw = gan(big).float()  # (B, 1, fixed, fixed)
    val = binarize_sketch(raw) if binarize else 1.0 - raw
    return resize_bicubic(val.expand(b, 3, fixed, fixed), h, w)


def encode_tokens_static(text_encoder, input_ids: torch.Tensor, *,
                         bos_token_id: int = 49406, eos_token_id: int = 49407) -> torch.Tensor:
    """(B, L) EOS-padded ids -> text states. L <= 77 encodes directly; else
    the ids go in ceil(L / 75) windows of 75, each wrapped in BOS/EOS, the
    tail window padded to 75 with EOS (the JAX package's static-shape
    chunking: PARITY.md deviation 1), and the states are concatenated."""
    b, n = input_ids.shape
    if n <= 77:
        return text_encoder(input_ids)
    bos = input_ids.new_full((b, 1), bos_token_id)
    eos = input_ids.new_full((b, 1), eos_token_id)
    states = []
    for start in range(0, n, 75):
        window = input_ids[:, start:start + 75]
        if window.shape[1] < 75:
            window = torch.cat([window, window.new_full((b, 75 - window.shape[1]),
                                                        eos_token_id)], dim=1)
        states.append(text_encoder(torch.cat([bos, window, eos], dim=1)))
    return torch.cat(states, dim=-2)


def encode_text(text_encoder, input_ids: torch.Tensor) -> torch.Tensor:
    """``encode_tokens_static`` with the encoder's own BOS/EOS ids."""
    cfg = text_encoder.config
    return encode_tokens_static(text_encoder, input_ids, bos_token_id=cfg.bos_token_id,
                                eos_token_id=cfg.eos_token_id)


def draw(shape, num_timesteps: int, names, generator: Optional[torch.Generator],
         device, shard: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """Standard-normal tensors of ``shape`` (B, C, h, w) under each of
    ``names`` and B timesteps in [0, num_timesteps) under "t", from
    ``generator`` (on the CPU or on ``device``; None: PyTorch's default
    generator of ``device``), moved to ``device``. ``shard`` = (index,
    count): ``shape`` is one of ``count`` shards of the batch; the global
    batch's B * count rows are drawn and rows index::count kept (the
    loader's sharding)."""
    gdev = generator.device if generator is not None else device
    index, count = shard or (0, 1)
    full = (shape[0] * count,) + tuple(shape[1:])
    out = {n: torch.randn(full, generator=generator, device=gdev) for n in names}
    out["t"] = torch.randint(0, num_timesteps, (full[0],), generator=generator, device=gdev)
    return {k: v[index::count].to(device) for k, v in out.items()}


def data_shard(mesh) -> Optional[Tuple[int, int]]:
    """(data index, data-axis size) of a mesh, None without one."""
    return None if mesh is None else (mesh.data_index, mesh.shape["data"])


def reduce_step(mesh, params, loss: torch.Tensor) -> torch.Tensor:
    """After the backward of a data-parallel step: average ``params``'
    gradients over the data group, -> the loss averaged over it (the global
    batch's; the local loss without a mesh)."""
    if mesh is None:
        return loss
    from sketch2img_torch.parallel.mesh import all_reduce_, average_gradients

    dp = mesh.shape["data"]
    average_gradients(params, mesh.data_group, dp)
    return all_reduce_(loss.detach().clone(), mesh.data_group) / dp


def lgp_inputs(frozen: Frozen, batch: Dict[str, torch.Tensor], *, sketch_fixed_size: int = 1024,
               cached_latents: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               shard: Optional[Tuple[int, int]] = None):
    """Steps 1-3, without grad: -> (taps concatenated (B, C, h, w) fp32,
    noise level (B, 4, h, w), sketch latents (B, 4, h, w)). ``batch`` holds
    ``input_ids`` (B, L) and ``pixels`` (B, 3, H, W) in [-1, 1], or with
    ``cached_latents`` the VAE moments ``latent_dist`` and
    ``sketch_latent_dist`` (B, 8, h, w) (mean ‖ logvar)."""
    with torch.no_grad():
        ids = batch["input_ids"]
        ctx = encode_text(frozen.text_encoder, ids)
        if cached_latents:
            mean, logvar = batch["latent_dist"].float().chunk(2, dim=1)
            smean, slogvar = batch["sketch_latent_dist"].float().chunk(2, dim=1)
        else:
            px = batch["pixels"]
            mean, logvar = frozen.vae.encode(px)
            sketch = generate_sketch(frozen.gan, px, fixed=sketch_fixed_size)
            smean, slogvar = frozen.vae.encode(sketch)  # the [0, 1] sketch, as in JAX
        if draws is None:
            draws = draw(mean.shape, frozen.schedule.num_train_timesteps,
                         ("latent", "sketch", "noise"), generator, mean.device, shard)
        latents = sample_latent(mean, logvar, draws["latent"])
        sketch_latents = sample_latent(smean, slogvar, draws["sketch"])
        noise, t = draws["noise"], draws["t"]
        noisy = add_noise(frozen.schedule, latents, noise, t)
        noise_level = get_noise_level(frozen.schedule, noise, t)
        _, taps = frozen.unet(noisy, t, ctx, capture_taps=True)
        feats = concat_taps(taps, latents.shape[2], latents.shape[3])
    return feats, noise_level, sketch_latents


def lgp_train_step(lgp, optimizer: torch.optim.Optimizer, frozen: Frozen,
                   batch: Dict[str, torch.Tensor], mesh=None, **kwargs) -> torch.Tensor:
    """One step (module docstring); ``kwargs`` go to ``lgp_inputs``. The LGP
    runs in train mode (under ``mesh``, its BatchNorms synchronised over the
    data group). Returns the loss (a 0-d fp32 tensor, detached)."""
    feats, noise_level, sketch_latents = lgp_inputs(frozen, batch, shard=data_shard(mesh),
                                                    **kwargs)
    lgp.train()
    out = lgp(feats, noise_level)
    loss = torch.mean((out.float() - sketch_latents.float()) ** 2)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = reduce_step(mesh, list(lgp.parameters()), loss)
    optimizer.step()
    return loss.detach()
