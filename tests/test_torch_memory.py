"""UNet rematerialisation and the device-memory budget of the PyTorch port
(``models/unet.py`` remat, ``core/memory.py``) against the JAX package.

The remat gradient is the plain one (a tiny UNet with taps, fp32: the same
ops recomputed, so within 1e-6); the estimator, ``choose_remat`` and the
upper-envelope fit are the JAX functions on the JAX package's own v5e rows
(``sketch2img_tpu/core/memory.py`` imports jax only inside
``device_hbm_gib``); the port's committed H100 rows sit under their own
fitted envelope; ``SKETCH2IMG_HBM_GIB`` sets the budget, and the pipeline's
``remat=None`` decides from it (``last_remat``).
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as w
from sketch2img_torch.core import memory
from sketch2img_tpu.core import memory as jmemory
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def stack():
    from sketch2img_torch.runtime import SketchGuidedPipeline

    c = w.components()
    return c, SketchGuidedPipeline(c)


def _pass(c, remat):
    from sketch2img_torch.core.schedulers import get_noise_level
    from sketch2img_torch.models.lgp import lgp_fused_apply

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 16, 16, generator=gen).requires_grad_(True)
    target = 0.2 * torch.randn(2, 4, 16, 16, generator=gen)
    ctx = torch.randn(2, 77, 32, generator=gen)
    t = torch.tensor([801, 301])
    eps, taps = c.unet(x, t, ctx, capture_taps=True, remat=remat)
    out = lgp_fused_apply(c.lgp, taps, get_noise_level(c.schedule, x.detach(), t), 16, 16)
    (g,) = torch.autograd.grad(torch.mean((target - out) ** 2), x)
    return eps.detach(), {k: v.detach() for k, v in taps.items()}, g


def test_remat_gradient_equals_the_plain_one(stack):
    """Each ResnetBlock and SpatialTransformer recomputed in the backward:
    eps and the taps unchanged, the gradient w.r.t. the latent within 1e-6
    of its largest value; no recomputation without autograd."""
    c, _ = stack
    eps0, taps0, g0 = _pass(c, False)
    eps1, taps1, g1 = _pass(c, True)
    assert torch.equal(eps0, eps1)
    assert all(torch.equal(taps0[k], taps1[k]) for k in taps0)
    assert float((g1 - g0).abs().max()) <= 1e-6 * float(g0.abs().max())
    with torch.no_grad():
        x = torch.zeros(1, 4, 16, 16)
        assert torch.equal(c.unet(x, torch.tensor([5]), torch.zeros(1, 77, 32), remat=True),
                           c.unet(x, torch.tensor([5]), torch.zeros(1, 77, 32)))


def test_remat_keeps_the_taps_out_of_the_recomputed_blocks(stack, monkeypatch):
    """The taps are taken between blocks: recomputation in the backward runs
    the blocks' forwards again (each checkpointed block once) but never the
    code that records a tap."""
    import torch.utils.checkpoint as cp

    c, _ = stack
    calls = []
    real = cp.checkpoint

    def spy(fn, *args, **kw):
        calls.append(type(fn).__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr("sketch2img_torch.models.unet.checkpoint", spy)
    _, taps, _ = _pass(c, True)
    assert sorted(set(calls)) == ["ResnetBlock", "SpatialTransformer"]
    assert len(taps) == 9 and len(calls) == sum(
        1 for m in c.unet.modules() if type(m).__name__ in ("ResnetBlock", "SpatialTransformer"))


@pytest.mark.parametrize("fn", ["estimate_guided_gib", "choose_remat", "fit_from_calibration"])
def test_memory_functions_equal_jax_on_its_rows(monkeypatch, fn):
    """With the JAX package's fitted v5e constants, the port's functions give
    the JAX ones' answers over a grid of requests; the fit of the JAX rows is
    the JAX fit."""
    if fn == "fit_from_calibration":
        assert memory.fit_from_calibration(jmemory.CALIBRATION) == \
            jmemory.fit_from_calibration(jmemory.CALIBRATION)
        return
    monkeypatch.setattr(memory, "_BASE_GIB", dict(jmemory._BASE_GIB))
    monkeypatch.setattr(memory, "_SLOPE_GIB_PER_MPIX", dict(jmemory._SLOPE_GIB_PER_MPIX))
    for size in (256, 512, 768, 1024):
        for batch in (1, 2, 4, 8, 16):
            for remat in (False, True):
                if fn == "estimate_guided_gib":
                    assert memory.estimate_guided_gib(batch, size, size, remat) == \
                        jmemory.estimate_guided_gib(batch, size, size, remat)
            if fn == "choose_remat":
                for budget in (8.0, 15.7, 80.0):
                    assert memory.choose_remat(batch, size, size, budget_gib=budget) == \
                        jmemory.choose_remat(batch, size, size, budget_gib=budget)


def test_h100_rows_fit_under_their_envelope():
    """Every committed row on or under the committed line; the constants are
    the fit of the rows (rounded up); each remat setting has at least three
    rows, and the rows bracket the batch where choose_remat flips on 80 GB."""
    assert all(sum(r == flag for *_, r, _ in memory.CALIBRATION) >= 3 for flag in (False, True))
    bases, slopes = memory.fit_from_calibration(memory.CALIBRATION)
    for flag in (False, True):
        assert memory._BASE_GIB[flag] == pytest.approx(bases[flag], abs=2e-3)
        assert memory._SLOPE_GIB_PER_MPIX[flag] == pytest.approx(slopes[flag], abs=2e-2)
    for size, batch, remat, total in memory.CALIBRATION:
        assert total <= memory.estimate_guided_gib(batch, size, size, remat) + 1e-9
    budget = memory._DEFAULT_HBM_GIB
    flips = [memory.choose_remat(b, s, s, budget_gib=budget)
             for s, b, r, _ in memory.CALIBRATION if r]
    assert any(flips) and not all(flips)


def test_hbm_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("SKETCH2IMG_HBM_GIB", "12.5")
    assert memory.device_hbm_gib() == 12.5
    monkeypatch.delenv("SKETCH2IMG_HBM_GIB")
    if not torch.cuda.is_available():
        assert memory.device_hbm_gib() == memory._DEFAULT_HBM_GIB


def test_pipeline_picks_remat_and_reports_it(stack, monkeypatch):
    """``remat=None`` asks ``choose_remat`` (a tiny budget flags the request,
    the card's does not); ``last_remat`` says which ran; the image is the
    same either way, and ``remat=True`` runs."""
    _, pipe = stack
    kw = dict(num_inference_steps=2, width=w.PX, height=w.PX, seed=3, sketch_image=w.sketch())
    monkeypatch.setenv("SKETCH2IMG_HBM_GIB", "80")
    plain = pipe("a", **kw)
    assert pipe.last_remat is False
    monkeypatch.setenv("SKETCH2IMG_HBM_GIB", "0.001")
    chosen = pipe("a", **kw)
    assert pipe.last_remat is True
    forced = pipe("a", remat=True, **kw)
    assert pipe.last_remat is True
    np.testing.assert_array_equal(chosen, forced)
    np.testing.assert_allclose(chosen, plain, rtol=0, atol=1e-6)
