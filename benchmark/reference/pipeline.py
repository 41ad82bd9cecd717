"""Plain float32 reference of the sampling and training arithmetic the cells
time: the SD1.x schedule, DPM-Solver++ 2M, classifier-free guidance, the
sketch-guided step (the LGP's gradient nudge), the attention-injection
step, the VAE's latent sampling and image decode, the preprocessing of the
safety checker and of the CLIP sketch encoder, the LGP training step and
AdamW.

Why it is here: these are the steps whose outputs the benchmark compares,
written from the published algorithms (diffusers' DPMSolverMultistep with
``lower_order_final``, Mikubill/sketch2img's guidance rule, PyTorch's
AdamW) and independent of the port. Coefficients are computed in float64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import concat_taps

LATENT_SCALE = 0.18215
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BOS, EOS = 49406, 49407


def alphas_cumprod(n: int = 1000, start: float = 0.00085, end: float = 0.012) -> np.ndarray:
    """SD1.x scaled-linear schedule, float64."""
    betas = np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


class DPMSolver:
    """DPM-Solver++ 2M (midpoint, epsilon prediction); step 0 first order,
    the last step too below 15 steps (``lower_order_final``)."""

    def __init__(self, steps: int, n_train: int = 1000):
        ac = alphas_cumprod(n_train)
        self.ac = ac
        self.timesteps = (np.linspace(0, n_train - 1, steps + 1).round()[::-1][:-1]
                          .astype(np.int64))
        alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
        lam = np.log(alpha) - np.log(sigma)
        ts = self.timesteps
        self.coef = []
        for i in range(steps):
            s0, t = ts[i], 0 if i == steps - 1 else ts[i + 1]
            h = lam[t] - lam[s0]
            phi = math.expm1(-h)
            first = i == 0 or (steps < 15 and i == steps - 1)
            if first:
                m0, m1 = -alpha[t] * phi, 0.0
            else:
                r0 = (lam[s0] - lam[ts[i - 1]]) / h
                m0, m1 = -alpha[t] * phi * (1 + 0.5 / r0), alpha[t] * phi * 0.5 / r0
            self.coef.append((alpha[s0], sigma[s0], sigma[t] / sigma[s0], m0, m1))

    def step(self, i: int, x, eps, x0_prev):
        """-> (x_next, x0)."""
        a, s, cx, m0, m1 = self.coef[i]
        x0 = (x - s * eps) / a
        return cx * x + m0 * x0 + m1 * x0_prev, x0

    def eps_from_x0(self, i: int, x, x0):
        """The epsilon a step used, read back from its x0."""
        a, s = self.coef[i][:2]
        return (x - a * x0) / s

    def eps_from_next(self, i: int, x, x0_prev, x_next):
        """The epsilon a step's x_next implies, given its x and x0_prev."""
        a, s, cx, m0, m1 = self.coef[i]
        return (cx * x + m0 * x / a + m1 * x0_prev - x_next) / (m0 * s / a)

    def linear_part(self, i: int, x, x0, x0_prev):
        _, _, cx, m0, m1 = self.coef[i]
        return cx * x + m0 * x0 + m1 * x0_prev


def num_guided_steps(steps: int) -> int:
    """Steps i <= steps / 2 are guided (the published rule)."""
    return int(math.floor(0.5 * steps)) + 1


def cfg(eps_u, eps_c, scale: float):
    return eps_u + scale * (eps_c - eps_u)


def noise_level(ac: np.ndarray, noise: torch.Tensor, t: int) -> torch.Tensor:
    return math.sqrt(1.0 - ac[t]) * noise


def lgp_head(lgp, taps: Dict[str, torch.Tensor], nl: torch.Tensor) -> torch.Tensor:
    return lgp(concat_taps(taps, nl.shape[2], nl.shape[3]), nl)


def guided_step(m, solver: DPMSolver, i: int, x, x0_prev, noise0, uncond, cond, target,
                scale: float, beta: float = 1.6) -> Tuple[torch.Tensor, torch.Tensor,
                                                         torch.Tensor]:
    """One sketch-guided step from (x, x0_prev) -> (eps after CFG, the
    guidance nudge added to the solver's x, x_next)."""
    t = int(solver.timesteps[i])
    tt = torch.full((x.shape[0],), t, device=x.device)
    with torch.no_grad():
        eps_u = m.unet(x, tt, uncond)
    with torch.enable_grad():
        xc = x.detach().requires_grad_(True)
        eps_c, taps = m.unet(xc, tt, cond, taps=True)
        out = lgp_head(m.lgp, taps, noise_level(solver.ac, noise0, t))
        (g,) = torch.autograd.grad(torch.mean((target - out) ** 2), xc)
    eps = cfg(eps_u, eps_c.detach(), scale)
    x_prev, _ = solver.step(i, x, eps, x0_prev)
    norm = lambda v: v.flatten(1).norm(dim=1).view(-1, 1, 1, 1)  # noqa: E731
    alpha = math.sqrt(2.0) * norm(x - x_prev) / norm(g).clamp(min=1e-20) * beta
    nudge = -alpha * g
    return eps, nudge, x_prev + nudge


@torch.no_grad()
def plain_eps(m, solver: DPMSolver, i: int, x, uncond, cond, guidance: float, **inject):
    """CFG epsilon of one step at batch 2B ([uncond; cond]); ``inject``
    goes to the UNet (injection state and strength)."""
    t = int(solver.timesteps[i])
    tt = torch.full((2 * x.shape[0],), t, device=x.device)
    eps = m.unet(torch.cat([x, x]), tt, torch.cat([uncond, cond]), **inject)
    return cfg(*eps.chunk(2), guidance)


@torch.no_grad()
def decode(vae, latents) -> torch.Tensor:
    """Latents -> (B, 3, H, W) image in [0, 1]."""
    return (vae.decode(latents / LATENT_SCALE) / 2 + 0.5).clamp(0.0, 1.0)


@torch.no_grad()
def decode_checked(m, latents, size: int, chunk: int = 2):
    """Latents -> (images in [0, 1] with the ones the safety checker flags
    blacked out, (B,) flags), ``chunk`` images at a time."""
    imgs, flags = [], []
    for s in range(0, latents.shape[0], chunk):
        img = decode(m.vae, latents[s:s + chunk])
        f = m.safety_checker.flags(safety_pixels(img, size))
        imgs.append(torch.where(f[:, None, None, None], torch.zeros_like(img), img))
        flags.append(f)
    return torch.cat(imgs), torch.cat(flags).cpu().numpy()


def clip_normalize(x):
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def bicubic(x, h: int, w: int):
    """Keys a = -0.5, antialiased when shrinking (PIL's and jax.image's)."""
    return F.interpolate(x, size=(h, w), mode="bicubic", antialias=True, align_corners=False)


def safety_pixels(images01, size: int = 224):
    """Shortest edge to ``size`` (bicubic), centre crop, CLIP-normalise."""
    h, w = images01.shape[2:]
    nh, nw = ((size, max(round(w * size / h), size)) if h <= w
              else (max(round(h * size / w), size), size))
    x = bicubic(images01, nh, nw)
    top, left = (nh - size) // 2, (nw - size) // 2
    return clip_normalize(x[:, :, top:top + size, left:left + size].clamp(0.0, 1.0))


def sketch_pixels(sketch01: np.ndarray, size: int, device) -> torch.Tensor:
    """A sketchpad in [0, 1] -> CLIP pixels as PIL makes them: uint8 by
    truncation, bicubic in two passes (width, then height) each rounded
    and clipped to uint8 levels, CLIP-normalised. (1, 3, size, size)."""
    arr = np.asarray(sketch01, np.float32)
    if arr.ndim == 2:
        arr = np.tile(arr[:, :, None], (1, 1, 3))
    x = torch.from_numpy((arr * 255).astype(np.uint8)).to(device).permute(2, 0, 1)[None].float()
    x = bicubic(x, x.shape[2], size).round().clamp(0, 255)
    x = bicubic(x, size, size).round().clamp(0, 255)
    return clip_normalize(x / 255.0)


def sketch_vae_input(sketch01: np.ndarray, device) -> torch.Tensor:
    """A grayscale sketchpad in [0, 1] -> (1, 3, H, W) in [-1, 1]."""
    arr = np.asarray(sketch01, np.float32)
    x = torch.from_numpy((arr - 0.5) / 0.5).to(device)
    return x[None, None].expand(1, 3, *arr.shape).contiguous()


@torch.no_grad()
def encode_prompts(text, ids: np.ndarray, device) -> torch.Tensor:
    return text(torch.as_tensor(ids, dtype=torch.long, device=device))


@torch.no_grad()
def encode_long(text, ids: np.ndarray, device) -> torch.Tensor:
    """(B, L > 77) ids -> windows of 75 wrapped in BOS/EOS (the last padded
    with EOS), each encoded, concatenated on the token axis."""
    ids = torch.as_tensor(ids, dtype=torch.long, device=device)
    if ids.shape[1] <= 77:
        return text(ids)
    b = ids.shape[0]
    outs = []
    for s in range(0, ids.shape[1], 75):
        w = ids[:, s:s + 75]
        w = torch.cat([w, w.new_full((b, 75 - w.shape[1]), EOS)], dim=1)
        outs.append(text(torch.cat([w.new_full((b, 1), BOS), w, w.new_full((b, 1), EOS)], 1)))
    return torch.cat(outs, dim=1)


def sample_latent(mean, logvar, noise):
    return (mean + torch.exp(0.5 * logvar) * noise) * LATENT_SCALE


@torch.no_grad()
def training_sketch(gan, px: torch.Tensor, fixed: int) -> torch.Tensor:
    """anime2sketch's sketch of px (B, 3, H, W) in [-1, 1]: bicubic to
    fixed^2, the generator, 1 - out thresholded at 0.5, three channels,
    bicubic back. In [0, 1]."""
    b, _, h, w = px.shape
    raw = gan(bicubic(px, fixed, fixed))
    val = torch.where(1.0 - raw < 0.5, 0.0, 1.0)
    return bicubic(val.expand(b, 3, fixed, fixed), h, w)


def lgp_loss(m, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
             ac: np.ndarray, fixed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LGP training loss (the LGP in train mode; frozen parts without
    grad): text states, VAE moments of the pixels and of their sketch,
    the noised latents, the taps at the latent size, MSE against the
    sketch latents. -> (loss, the LGP's output)."""
    with torch.no_grad():
        ctx = encode_long(m.text, batch["input_ids"], batch["pixels"].device)
        px = batch["pixels"]
        mean, logvar = m.vae.encode(px)
        smean, slogvar = m.vae.encode(training_sketch(m.anime2sketch, px, fixed))
        lat = sample_latent(mean, logvar, draws["latent"])
        sk = sample_latent(smean, slogvar, draws["sketch"])
        t = draws["t"]
        a = torch.as_tensor(np.sqrt(ac), device=px.device, dtype=torch.float32)[t]
        s = torch.as_tensor(np.sqrt(1.0 - ac), device=px.device, dtype=torch.float32)[t]
        a, s = a.view(-1, 1, 1, 1), s.view(-1, 1, 1, 1)
        noisy = a * lat + s * draws["noise"]
        _, taps = m.unet(noisy, t, ctx, taps=True)
        feats = concat_taps(taps, lat.shape[2], lat.shape[3])
    m.lgp.train()
    out = m.lgp(feats, s * draws["noise"])
    return torch.mean((out - sk) ** 2), out


class AdamW:
    """PyTorch's AdamW (decoupled decay), the learning rate read at the
    step count before the update from a linear warm-up. ``moments`` and
    ``count``: a state to start from (copied), zeros and 0 by default."""

    BETAS = (0.9, 0.999)

    def __init__(self, params: Sequence[torch.Tensor], lr: float, warmup: int,
                 weight_decay: float, eps: float, betas=BETAS, moments=None, count: int = 0):
        self.params = list(params)
        self.lr, self.warmup, self.wd, self.eps, self.betas = lr, warmup, weight_decay, eps, betas
        if moments is None:
            moments = ([torch.zeros_like(p) for p in self.params],) * 2
        self.m = [t.detach().float().clone() for t in moments[0]]
        self.v = [t.detach().float().clone() for t in moments[1]]
        self.count = count

    @torch.no_grad()
    def step(self) -> None:
        lr = self.lr * min(self.count, self.warmup) / max(self.warmup, 1)
        self.count += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1 - lr * self.wd)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mh = m / (1 - b1 ** self.count)
            vh = v / (1 - b2 ** self.count)
            p.sub_(lr * mh / (vh.sqrt() + self.eps))
            p.grad = None


#: what ``rel`` reads for two tensors of different shapes (a batch cut short)
NO_MATCH = 1e9


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64; ``NO_MATCH`` when the shapes differ."""
    if a.shape != b.shape:
        return NO_MATCH
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
              keep: Sequence[bool]) -> float:
    """Worst leaf of |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖) over
    the leaves ``keep`` marks."""
    pn = [float(p.double().norm()) for p in prog]
    rn = [float(r.double().norm()) for r in ref]
    med = float(np.median([r for r, k in zip(rn, keep) if k]))
    return max(abs(p - r) / max(r, med, 1e-30)
               for p, r, k in zip(pn, rn, keep) if k)
