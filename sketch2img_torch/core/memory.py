"""Device-memory budgeting: pick the UNet's rematerialisation per request —
counterpart of ``sketch2img_tpu/core/memory.py``.

The guided backward keeps the UNet's activations for the gradient with
respect to the latent, and they grow with batch x latent pixels; a large
guided request that does not fit runs out of memory unless the UNet
recomputes its blocks in the backward (``UNetConfig.remat``). The runtime
estimates the guided sampling call's peak per (batch, height, width) from
rows measured on the card and turns remat on only when the plain call would
not fit (``choose_remat``); callers may still force either.

Calibration: ``measure_guided_gib`` runs one guided step of the port's
sampling call (``pipelines/sketch_guided.sample_sketch_guided``) and takes
``torch.cuda.max_memory_allocated`` above what was allocated before it,
plus the bytes of the UNet's and the LGP's parameters (the call's
arguments, as the JAX package's XLA totals count them); ``python3
chip_smoke.py --phases build,calibrate`` prints a row per case. The rows in
``CALIBRATION`` are fitted per remat setting as ``total = base + slope *
(batch * latent pixels)``, an upper envelope (``fit_from_calibration``): the
steepest slope between neighbouring rows and the base lifted until every row
sits on or under the line, so interpolation errs toward turning remat on
early (some speed lost, never an out-of-memory).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

# (size_px, batch, remat, total_gib): the guided sampling call's peak device
# memory, parameters included, bf16 UNet, fp32 LGP; measured by
# ``python3 chip_smoke.py --phases build,calibrate`` on NVIDIA H100 80GB HBM3,
# 700.00 W (nvidia-smi name, power.limit), torch 2.11.0+cu128, each row the
# largest of three runs (they spread by up to 0.03 GiB). Without remat the
# rows run up to just under the flip (88 images at 512^2, 22 at 1024^2 on
# 79.18 GiB); with remat, past it. Regenerate after a UNet or pipeline change.
CALIBRATION: List[Tuple[int, int, bool, float]] = [
    (512, 1, False, 2.470),    # NVIDIA H100 80GB HBM3, 700.00 W
    (512, 16, False, 14.729),  # NVIDIA H100 80GB HBM3, 700.00 W
    (512, 72, False, 60.566),  # NVIDIA H100 80GB HBM3, 700.00 W
    (768, 4, False, 9.015),    # NVIDIA H100 80GB HBM3, 700.00 W
    (1024, 4, False, 14.658),  # NVIDIA H100 80GB HBM3, 700.00 W
    (1024, 18, False, 60.251),  # NVIDIA H100 80GB HBM3, 700.00 W
    (512, 4, True, 2.256),     # NVIDIA H100 80GB HBM3, 700.00 W
    (512, 32, True, 6.689),    # NVIDIA H100 80GB HBM3, 700.00 W
    (512, 96, True, 16.824),   # NVIDIA H100 80GB HBM3, 700.00 W
    (1024, 8, True, 6.683),    # NVIDIA H100 80GB HBM3, 700.00 W
    (1024, 24, True, 16.815),  # NVIDIA H100 80GB HBM3, 700.00 W
]

# the cases ``chip_smoke.py`` measures: each remat setting at three or more
# (size, batch) points around the batch where choose_remat flips on 80 GB
CALIBRATION_CASES: List[Tuple[int, int, bool]] = [
    (512, 1, False), (512, 16, False), (512, 72, False), (768, 4, False), (1024, 4, False),
    (1024, 18, False),
    (512, 4, True), (512, 32, True), (512, 96, True), (1024, 8, True), (1024, 24, True),
]

# total_gib ~ _BASE_GIB[remat] + _SLOPE_GIB_PER_MPIX[remat] * mpix, where
# mpix = batch * (H/8) * (W/8) / 2**20 (latent megapixels):
# fit_from_calibration(CALIBRATION), rounded up in the last digit
_BASE_GIB = {False: 1.662, True: 1.635}
_SLOPE_GIB_PER_MPIX = {False: 209.44, True: 40.51}

_DEFAULT_HBM_GIB = 79.18  # total memory of an H100 80GB HBM3 as PyTorch reports it


def device_hbm_gib(default: float = _DEFAULT_HBM_GIB) -> float:
    """Memory budget of the current CUDA device in GiB: ``SKETCH2IMG_HBM_GIB``
    when set (tests, shared cards), else the device's total memory, else
    ``default`` (no GPU)."""
    env = os.environ.get("SKETCH2IMG_HBM_GIB")
    if env:
        return float(env)
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory / 2**30
    return default


def estimate_guided_gib(batch: int, height: int, width: int, remat: bool, *,
                        vae_scale: int = 8) -> float:
    """Predicted peak device memory (GiB) of the guided sampling call."""
    mpix = batch * (height // vae_scale) * (width // vae_scale) / 2**20
    return _BASE_GIB[remat] + _SLOPE_GIB_PER_MPIX[remat] * mpix


def choose_remat(batch: int, height: int, width: int, *, budget_gib: Optional[float] = None,
                 headroom: float = 0.92) -> bool:
    """True iff the guided call without remat is predicted not to fit.
    ``headroom`` keeps a margin under the budget for what is resident beside
    the sampler (VAE, text encoder, safety checker) and for the allocator's
    fragmentation."""
    budget = budget_gib if budget_gib is not None else device_hbm_gib()
    return estimate_guided_gib(batch, height, width, False) > headroom * budget


def fit_from_calibration(rows: List[Tuple[int, int, bool, float]], *, vae_scale: int = 8):
    """(size, batch, remat, total_gib) rows -> ({remat: base}, {remat: slope}).

    Upper envelope: slope = the largest incremental slope between rows
    sorted by pixel term, base = the largest (total - slope * pixel term),
    so every row sits on or under the fitted line."""
    bases, slopes = {}, {}
    for flag in (False, True):
        pts = sorted((b * (s // vae_scale) ** 2 / 2**20, t) for s, b, r, t in rows if r == flag)
        if len(pts) < 2:
            continue
        slope = max((t2 - t1) / (m2 - m1) for (m1, t1), (m2, t2) in zip(pts, pts[1:])
                    if m2 > m1)
        base = max(t - slope * m for m, t in pts)
        bases[flag], slopes[flag] = base, slope
    return bases, slopes


def measure_guided_gib(pipe, size: int, batch: int, remat: bool) -> float:
    """One calibration row's total: one guided step of the sampling call at
    (batch, size^2) on ``pipe``'s components (a ``SketchGuidedPipeline`` on
    the card), its peak allocated memory above what was allocated before it
    plus the UNet's and the LGP's parameter bytes, in GiB."""
    import torch

    from sketch2img_torch.pipelines.sketch_guided import sample_sketch_guided

    c = pipe.c
    dev = c.device
    h = size // c.vae_scale_factor
    gen = torch.Generator(device=dev).manual_seed(0)
    lat = torch.randn(batch, 4, h, h, generator=gen, device=dev)
    target = torch.randn(batch, 4, h, h, generator=gen, device=dev) * 0.2
    uncond, cond = pipe.encode_prompt([""] * batch)
    params = sum(p.numel() * p.element_size()
                 for m in (c.unet, c.lgp) for p in m.parameters())
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = sample_sketch_guided(c.unet, c.lgp, c.schedule, 1, lat, uncond, cond, target, 7.5,
                               remat=remat)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del out
    return (peak - before + params) / 2**30
