"""The reference against the port's plain path (the CPU runs the port
without its kernels) at tiny widths, on one state dict: the two are the
same mathematics, so they agree to float32 rounding."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, models
from benchmark.reference import build, pipeline as ref
from benchmark.reference.models import concat_taps
from benchmark.tests.tiny import tiny_cell

CFG = tiny_cell("sd15-lgp.guided-b1-512-50").config
INJ = tiny_cell("sd15-inject.clip-b8-512-25").config
TOL = 1e-4


def both(cfg, tree, seed=11):
    sd = models.make_weights(cfg, seed, tree, "cpu")
    port = models.port_module(cfg, tree, {k: v.clone() for k, v in sd.items()})
    mine = build.build(cfg, models.TREES[tree][0])
    mine.load_state_dict(sd, strict=True)
    return port, mine.eval()


def randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_unet_eps_and_taps():
    port, mine = both(CFG, "unet")
    x, ctx = randn(2, 4, 8, 8), randn(2, 77, 32, seed=1)
    t = torch.tensor([999, 10])
    eps_p, taps_p = port(x, t, ctx, capture_taps=True)
    eps_r, taps_r = mine(x, t, ctx, taps=True)
    assert ref.rel(eps_p, eps_r) < TOL
    for name in taps_r:
        assert ref.rel(taps_p[name], taps_r[name]) < TOL


def test_injected_unet():
    from sketch2img_torch.models.unet import UNet2DCondition

    base = models.make_weights(INJ, 3, "unet", "cpu")
    sat = models.make_weights(INJ, 3, "sat", "cpu")
    port0 = models.port_module(INJ, "unet", dict(base))
    cfg = dataclasses.replace(port0.config, injection="clip",
                              injection_context_dim=INJ["vision"]["hidden_size"])
    port = UNet2DCondition(cfg)
    port.load_state_dict({**base, **{"sat." + k: v for k, v in sat.items()}}, strict=True)
    mine = models.reference(INJ, 3, ["unet", "sat"], "cpu").unet
    x, ctx, state = randn(2, 4, 8, 8), randn(2, 77, 32, seed=1), randn(2, 5, 32, seed=2)
    scale = torch.tensor([0.0, 0.5]).view(2, 1, 1)
    n = len(mine.transformer_sites())
    eps_p = port(x, torch.tensor([500, 500]), ctx, injection_states=[state] * n,
                 injection_scale=scale)
    eps_r = mine(x, torch.tensor([500, 500]), ctx, injection=state, scale=scale)
    assert ref.rel(eps_p, eps_r) < TOL


def test_vae_text_and_vision():
    port, mine = both(CFG, "vae")
    x = randn(1, 3, 64, 64).clamp(-1, 1)
    for a, b in zip(port.encode(x), mine.encode(x)):
        assert ref.rel(a, b) < TOL
    z = randn(1, 4, 8, 8, seed=3)
    assert ref.rel(port.decode(z), mine.decode(z)) < TOL
    port, mine = both(CFG, "text_encoder")
    ids = torch.as_tensor(inputs.StandInTokenizer()(["a, b", ""]).input_ids)
    assert ref.rel(port(ids), mine(ids)) < TOL
    port, mine = both(INJ, "vision")
    px = randn(2, 3, 28, 28)
    assert ref.rel(port(px), mine(px)) < TOL


def test_safety_checker_and_preprocessing():
    from sketch2img_torch.apps.clip_guided_inf import preprocess_sketch
    from sketch2img_torch.models.safety_checker import preprocess

    port, mine = both(CFG, "safety_checker")
    img = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    assert ref.rel(preprocess(img, 28), ref.safety_pixels(img, 28)) < TOL
    _, flags_p = port.check_images(img)
    assert np.array_equal(flags_p.numpy(), mine.flags(ref.safety_pixels(img, 28)).numpy())
    sk = inputs.stroke_sketch(inputs.rng_for(1, 1), 64)
    assert ref.rel(preprocess_sketch(sk, 28, "cpu")[None], ref.sketch_pixels(sk, 28, "cpu")) < TOL


def test_lgp_eval_fused_and_train_mode():
    from sketch2img_torch.models.lgp import lgp_fused_apply

    unet, _ = both(CFG, "unet")
    port, mine = both(CFG, "lgp")
    _, taps = unet(randn(2, 4, 8, 8), torch.tensor([300, 300]), randn(2, 77, 32, seed=1),
                   capture_taps=True)
    nl = randn(2, 4, 8, 8, seed=5)
    got = lgp_fused_apply(port, taps, nl, 8, 8)
    assert ref.rel(got, ref.lgp_head(mine, taps, nl)) < TOL
    feats = concat_taps(taps, 8, 8)
    port.train()
    mine.train()
    assert ref.rel(port(feats, nl), mine(feats, nl)) < TOL
    assert ref.rel(port.layers[2].running_var, mine.layers[2].running_var) < TOL


def test_anime2sketch():
    port, mine = both(CFG, "anime2sketch")
    x = randn(1, 3, 64, 64).clamp(-1, 1)
    assert ref.rel(port(x), mine(x)) < TOL


@pytest.mark.parametrize("steps", [4, 25, 50])
def test_dpm_solver_tables(steps):
    from sketch2img_torch.core.schedulers import make_schedule, plan_dpm_solver

    plan = plan_dpm_solver(make_schedule(), steps)
    mine = ref.DPMSolver(steps)
    assert np.array_equal(plan.timesteps, mine.timesteps)
    got = np.stack([plan.alpha, plan.sigma, plan.c_x, plan.c_m0, plan.c_m1], 1)
    # the port keeps alphas_cumprod in float32; the reference in float64
    assert np.allclose(got, np.asarray(mine.coef), rtol=1e-4, atol=1e-7)
    assert ref.num_guided_steps(steps) == {4: 3, 25: 13, 50: 26}[steps]
