"""The port's schedulers against the JAX package's and the committed golden
fixture (tests/fixtures/scheduler_golden.json)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.core import schedulers as js
from sketch2img_torch.core import schedulers as ts

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "scheduler_golden.json")


@pytest.fixture(scope="module")
def golden():
    with open(_GOLDEN) as f:
        return json.load(f)


def test_schedule_matches_jax():
    for kind in ("scaled_linear", "linear"):
        a, b = ts.make_schedule(beta_schedule=kind), js.make_schedule(beta_schedule=kind)
        np.testing.assert_array_equal(a.betas, b.betas)
        np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
    with pytest.raises(ValueError):
        ts.make_schedule(beta_schedule="cosine")


@pytest.mark.parametrize("num_steps", [1, 10, 20, 25, 50])
def test_plans_match_jax_exactly(num_steps):
    """Same host-side numpy tables: bit-identical."""
    sched, jsched = ts.make_schedule(), js.make_schedule()
    a, b = ts.plan_dpm_solver(sched, num_steps), js.plan_dpm_solver(jsched, num_steps)
    for f in ("timesteps", "alpha", "sigma", "c_x", "c_m0", "c_m1"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    a, b = ts.plan_ddim(sched, num_steps), js.plan_ddim(jsched, num_steps)
    for f in ("timesteps", "sqrt_ac_t", "sqrt_om_t", "sqrt_ac_prev", "sqrt_om_prev"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_add_noise_and_noise_level_match_jax():
    """fp32 elementwise on both sides: 1e-6."""
    rng = np.random.RandomState(0)
    x0, eps = rng.randn(2, 4, 8, 8).astype(np.float32), rng.randn(2, 4, 8, 8).astype(np.float32)
    tt = np.array([100, 900])
    sched, jsched = ts.make_schedule(), js.make_schedule()
    got = ts.add_noise(sched, torch.tensor(x0), torch.tensor(eps), torch.tensor(tt))
    want = js.add_noise(jsched, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = ts.get_noise_level(sched, torch.tensor(eps), torch.tensor(tt))
    want = js.get_noise_level(jsched, jnp.asarray(eps), jnp.asarray(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("solver,key", [("dpm++", "dpmpp"), ("ddim", "ddim")])
@pytest.mark.parametrize("num_steps", [10, 25, 50])
def test_sampler_trajectory_matches_golden(golden, solver, key, num_steps):
    """Replay the fixture's synthetic model eps = sin(1.7x + 0.01t) through
    the port's sampler step; every latent matches the committed fp64
    trajectory to fp32 tolerance (2e-4, as the JAX package's own test)."""
    fx = golden[f"{key}_{num_steps}"]
    x = torch.tensor(golden["_meta"]["x_init"], dtype=torch.float32)
    tsteps, step = ts.make_sampler_step(solver, ts.make_schedule(), num_steps)
    assert list(tsteps) == fx["timesteps"]
    x0_prev = torch.zeros_like(x)
    for i, t in enumerate(tsteps):
        eps = torch.sin(1.7 * x + 0.01 * float(t))
        x, x0_prev = step(i, x, eps, x0_prev)
        np.testing.assert_allclose(x.numpy(), np.asarray(fx["trajectory"][i]),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("solver", ["dpm++", "ddim"])
def test_sampler_steps_match_jax(solver):
    """Port step vs JAX step on the same (x, eps, x0_prev): 1e-5."""
    rng = np.random.RandomState(1)
    x, eps, x0p = (rng.randn(1, 4, 8, 8).astype(np.float32) for _ in range(3))
    tsteps, tstep = ts.make_sampler_step(solver, ts.make_schedule(), 12)
    jsteps, jstep = js.make_sampler_step(solver, js.make_schedule(), 12)
    assert list(tsteps) == list(jsteps)
    for i in range(12):
        a = tstep(i, torch.tensor(x), torch.tensor(eps), torch.tensor(x0p))
        b = jstep(i, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(x0p))
        for u, w in zip(a, b):
            np.testing.assert_allclose(u.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ts.make_sampler_step("euler", ts.make_schedule(), 4)
