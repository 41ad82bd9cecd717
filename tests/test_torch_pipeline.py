"""Slice parity of the PyTorch port: a tiny sketch-guided trajectory plus VAE
decode against the JAX package's ``make_sketch_guided_fn``, and the port's
user-facing pipeline on the CPU.

The same weights (converted from the port's state dicts) and the same
initial latents, contexts and sketch latent (numpy, fed to both sides) go
through both; the JAX side is jit-compiled as its runtime compiles it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.core.schedulers import make_schedule as j_make_schedule
from sketch2img_tpu.models.lgp import lgp_fused_apply as j_lgp_fused
from sketch2img_tpu.models.vae import AutoencoderKL as JVAE
from sketch2img_tpu.pipelines.sketch_guided import make_sketch_guided_fn
from sketch2img_tpu.pipelines.text2img import latents_to_image as j_latents_to_image
from sketch2img_tpu.pipelines.text2img import make_text2img_fn
from sketch2img_torch.core.schedulers import make_schedule
from sketch2img_torch.pipelines.sketch_guided import sample_sketch_guided
from sketch2img_torch.pipelines.text2img import latents_to_image, sample_text2img

from torch_port_stack import lgp_pair, nchw, nhwc, t, unet_pair, vae_pair
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def stack():
    return unet_pair(1), lgp_pair(2), vae_pair(3)


def _inputs(seed, hw=16):
    rng = np.random.RandomState(seed)
    lat0 = rng.randn(1, hw, hw, 4).astype(np.float32)
    ctx_u = rng.randn(1, 7, 24).astype(np.float32)
    ctx_c = rng.randn(1, 7, 24).astype(np.float32)
    target = (0.5 * rng.randn(1, hw, hw, 4)).astype(np.float32)
    return lat0, ctx_u, ctx_c, target


def test_sketch_guided_trajectory_and_decode_match_jax(stack):
    """Two guided DPM-Solver++ steps (num_guided_steps(2) == 2), then the VAE
    decode. fp32 on both sides; the guidance step size ||x - x_prev|| /
    ||grad|| carries the rounding of two UNet backward passes. Latents
    (magnitude ~150 with this random tiny UNet): 1e-5 of their scale,
    measured 2e-6. Image in [0, 1], 99% unclipped: 2e-5, measured 1.5e-6."""
    (tu, ju, jup), (tl, jl, jlv), (tv, jv, jvp) = stack
    lat0, ctx_u, ctx_c, target = _inputs(0)
    steps, gs = 2, 7.5

    run = make_sketch_guided_fn(
        lambda p, x, tt, c: ju.apply({"params": p}, x, tt, c),
        lambda p, x, tt, c: ju.apply({"params": p}, x, tt, c, capture_taps=True),
        lambda v, f, nl: jl.apply(v, f, nl, train=False),
        j_make_schedule(), steps,
        lgp_apply_fused=lambda v, taps, nl, h, w: j_lgp_fused(v, taps, nl, h, w))
    want_lat = jax.jit(run)(jup, jlv, jnp.asarray(lat0), jnp.asarray(ctx_u),
                            jnp.asarray(ctx_c), jnp.asarray(target), gs)
    want = np.asarray(jax.jit(lambda p, z: j_latents_to_image(
        lambda pp, zz: jv.apply({"params": pp}, zz, method=JVAE.decode), p, z))(jvp, want_lat))

    lat = sample_sketch_guided(tu, tl, make_schedule(), steps, t(nchw(lat0)), t(ctx_u),
                               t(ctx_c), t(nchw(target)), gs)
    want_lat = np.asarray(want_lat)
    np.testing.assert_allclose(nhwc(lat.numpy()), want_lat, rtol=0,
                               atol=1e-5 * np.abs(want_lat).max())
    with torch.no_grad():
        got = nhwc(latents_to_image(tv, lat).numpy())
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_text2img_matches_jax(stack):
    """Plain CFG sampling (no sketch): two DPM-Solver++ steps at batch 2B.
    fp32 on both sides. The random tiny UNet's eps differences are amplified
    by guidance 7.5 into latents of magnitude ~30, so the tolerance is 2e-5
    of the largest latent (measured 4e-6)."""
    (tu, ju, jup), _, _ = stack
    lat0, ctx_u, ctx_c, _ = _inputs(1)
    pair = np.concatenate([ctx_u, ctx_c])
    fn = make_text2img_fn(lambda p, x, tt, c: ju.apply({"params": p}, x, tt, c),
                          j_make_schedule(), 2)
    want = np.asarray(jax.jit(fn)(jup, jnp.asarray(lat0), jnp.asarray(pair), 7.5))
    got = sample_text2img(tu, make_schedule(), 2, t(nchw(lat0)), t(pair), 7.5)
    np.testing.assert_allclose(nhwc(got.numpy()), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the user-facing pipeline on the CPU (device="cpu", tiny config)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipe():
    from sketch2img_torch.models.clip_text import CLIPTextConfig
    from sketch2img_torch.models.unet import UNetConfig
    from sketch2img_torch.models.vae import VAEConfig
    from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline

    from fakes import FakeTokenizer

    c = SDComponents.random_init(
        seed=0, compute_dtype=torch.float32, random_weights=True, device="cpu",
        unet_config=UNetConfig(block_out_channels=(32, 32, 64), cross_attn=(True, True, False),
                               layers_per_block=1, num_heads=2, cross_attention_dim=32),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        text_config=CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=4))
    c.tokenizer = FakeTokenizer()
    return SketchGuidedPipeline(c)


def _sketch(hw=32):
    s = np.zeros((hw, hw), np.float32)
    s[8:24, 14:18] = 1.0
    return s


def test_pipeline_sketch_guided_surface(pipe):
    events = []
    img = pipe("a tree", num_inference_steps=3, width=32, height=32, seed=5,
               sketch_image=_sketch(), callback=lambda i, tt, x: events.append((i, tt, x.shape)),
               callback_steps=2)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 1.0
    assert [e[0] for e in events] == [0, 2]
    assert all(e[2] == (1, 4, 16, 16) for e in events)
    batch = pipe(["a", "b"], num_images_per_prompt=2, num_inference_steps=2, width=32,
                 height=32, seed=7, sketch_image=_sketch())
    assert batch.shape == (4, 32, 32, 3)
    # remat=True recomputes the UNet's blocks in the guided backward: the same image
    again = pipe("a tree", num_inference_steps=3, width=32, height=32, seed=5,
                 sketch_image=_sketch(), remat=True)
    assert pipe.last_remat is True
    np.testing.assert_allclose(again, img, rtol=0, atol=1e-6)


def test_pipeline_per_image_seeds_are_batch_invariant(pipe):
    """Image i depends on (seed[i], sketch[i]) alone: norms are per image and
    every module is per sample. fp32 on the CPU; 1e-5 absolute covers the
    batch-size-dependent summation order of the convolutions."""
    sk = [_sketch(), _sketch()[::-1].copy()]
    both = pipe(["x", "y"], num_inference_steps=2, width=32, height=32, seed=[11, 12],
                sketch_image=sk)
    one = pipe(["y"], num_inference_steps=2, width=32, height=32, seed=[12],
               sketch_image=sk[1:])
    np.testing.assert_allclose(both[1], one[0], rtol=0, atol=1e-5)


def test_pipeline_text2img_and_seed_determinism(pipe):
    a = pipe("a cat", num_inference_steps=2, width=32, height=32, seed=3)
    b = pipe("a cat", num_inference_steps=2, width=32, height=32, seed=3)
    c = pipe("a cat", num_inference_steps=2, width=32, height=32, seed=4)
    assert a.shape == (32, 32, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
