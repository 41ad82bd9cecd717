"""Attention injection in the PyTorch port against the JAX package: the
CLIP vision encoder, the injected UNet (clip and sketch variants), the
sketch variant's down residuals and injection states, a two-step
``attn_injected`` trajectory, the user-facing ``ClipGuidedPipeline`` and its
sketch preprocessing.

Weights come from the port's modules (tests/torch_port_stack.py), carried
to the JAX side by its own converters (``convert_torch_unet``,
``convert_torch_sat``, ``convert_torch_clip_vision``); inputs and initial
noise are numpy, fed to both. All fp32 on the CPU.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.core.schedulers import make_schedule as j_make_schedule
from sketch2img_tpu.models import injection as jinj
from sketch2img_tpu.models import unet as junet
from sketch2img_tpu.pipelines.attn_injected import make_attn_injected_fn
from sketch2img_torch.core.schedulers import make_schedule
from sketch2img_torch.models import injection as tinj
from sketch2img_torch.models import unet as tunet
from sketch2img_torch.pipelines.attn_injected import cfg_injection_state, sample_attn_injected

from torch_port_stack import (
    UNET_KW, VISION_KW, clip_vision_pair, injected_unet_pair, nchw, nhwc, t,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CTX_DIM = 16  # the injected tiny UNet's CLIP width


def _close(got, want, rel, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=name)


def test_clip_vision_matches_jax():
    """224/14 -> 257 tokens, 2 layers of width 32: last_hidden_state (before
    post_layernorm) to 1e-5 of its scale, fp32."""
    port, jmod, params = clip_vision_pair(0)
    px = np.random.RandomState(0).randn(2, 224, 224, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, jnp.asarray(px))
    with torch.no_grad():
        got = port(t(nchw(px))).numpy()
    assert got.shape == (2, 257, VISION_KW["hidden_size"])
    _close(got, want, 1e-5)


def _unet_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 16, 16, 4).astype(np.float32), np.array([801, 21]),
            rng.randn(2, 7, 24).astype(np.float32))


@pytest.mark.parametrize("variant", ["clip", "sketch"])
def test_injected_unet_matches_jax(variant):
    """eps of the injected UNet with per-image scales (2, 1, 1): clip with
    one (2, 257, 16) CLIP state at every block (the 16x16 level's
    ``sketch_attn`` has 256 queries over 640 keys, kv_len 513: a flash
    site), sketch with states built from a sketch UNet's down residuals.
    fp32: 1e-4 of eps's scale, as for the plain UNet."""
    port, jmod, params = injected_unet_pair(variant, 1, CTX_DIM)
    x, tt, ctx = _unet_inputs(2)
    scale = np.array([0.7, 1.3], np.float32)[:, None, None]
    rng = np.random.RandomState(3)
    if variant == "clip":
        st = rng.randn(2, 257, CTX_DIM).astype(np.float32)
        jstates = [jnp.asarray(st)] * junet.num_transformer_blocks(jmod.config)
        tstates = [t(st)] * tunet.num_transformer_blocks(port.config)
    else:
        with torch.no_grad():
            res = port.down_residuals(t(nchw(rng.randn(2, 16, 16, 4).astype(np.float32))),
                                      torch.tensor(tt), t(ctx))
        tstates = tinj.build_sketch_injection_states(port.config, res)
        jstates = [jnp.asarray(s.numpy()) for s in tstates]
    want = jax.jit(lambda p, a, b, c, s, sc: jmod.apply(
        {"params": p}, a, b, c, injection_states=s, injection_scale=sc))(
        params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx), jstates, jnp.asarray(scale))
    with torch.no_grad():
        got = port(t(nchw(x)), torch.tensor(tt), t(ctx), injection_states=tstates,
                   injection_scale=t(scale))
        plain = port(t(nchw(x)), torch.tensor(tt), t(ctx))
    _close(nhwc(got.numpy()), want, 1e-4, variant)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3  # the injection did something


def test_down_residuals_and_injection_states_match_jax():
    """down_residuals of the tiny UNet (one tuple per down block) to 1e-5
    of their scale; the channel-aligned states built from them equal the
    JAX package's built from its own; block dims and counts equal at SD1.5
    and at the tiny config."""
    port, jmod, params = injected_unet_pair("sketch", 4, CTX_DIM)
    x, tt, ctx = _unet_inputs(5)
    want = jax.jit(lambda p, a, b, c: jmod.apply({"params": p}, a, b, c,
                                                 method=junet.UNet2DCondition.down_residuals))(
        params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx))
    with torch.no_grad():
        got = port.down_residuals(t(nchw(x)), torch.tensor(tt), t(ctx))
    assert [len(r) for r in got] == [len(r) for r in want]
    for gr, wr in zip(got, want):
        for g, w in zip(gr, wr):
            _close(nhwc(g.numpy()), w, 1e-5)
    t_states = tinj.build_sketch_injection_states(port.config, got)
    j_states = jinj.build_sketch_injection_states(jmod.config, want)
    for g, w in zip(t_states, j_states):
        _close(g.numpy(), w, 1e-5)
    for kw in ({}, UNET_KW):
        tc, jc = tunet.UNetConfig(**kw), junet.UNetConfig(**kw)
        assert tunet.transformer_block_dims(tc) == junet.transformer_block_dims(jc)
        assert tunet.num_transformer_blocks(tc) == junet.num_transformer_blocks(jc)
    assert tunet.num_transformer_blocks(tunet.UNetConfig()) == 16


def test_attn_injected_trajectory_matches_jax():
    """Two DPM-Solver++ steps at batch 2 with per-image strengths (0.25,
    0.9), the [zeros; h] CFG state. fp32; guidance 7.5 amplifies eps
    differences, so 2e-5 of the latents' scale (as text2img)."""
    port, jmod, params = injected_unet_pair("clip", 6, CTX_DIM)
    rng = np.random.RandomState(7)
    lat0 = rng.randn(2, 16, 16, 4).astype(np.float32)
    pair = rng.randn(4, 7, 24).astype(np.float32)
    hidden = rng.randn(2, 257, CTX_DIM).astype(np.float32)
    strengths = np.array([0.25, 0.9], np.float32)
    fn = make_attn_injected_fn(
        lambda p, x, tt, c, s, sc: jmod.apply({"params": p}, x, tt, c, injection_states=s,
                                              injection_scale=sc),
        j_make_schedule(), 2, junet.num_transformer_blocks(jmod.config))
    state = np.concatenate([np.zeros_like(hidden), hidden])
    want = jax.jit(fn)(params, jnp.asarray(lat0), jnp.asarray(pair), jnp.asarray(state),
                       jnp.asarray(strengths), 7.5)
    got = sample_attn_injected(port, make_schedule(), 2, t(nchw(lat0)), t(pair),
                               cfg_injection_state(t(hidden)), t(strengths), 7.5)
    _close(nhwc(got.numpy()), want, 2e-5)


# ---------------------------------------------------------------------------
# the user-facing pipeline (tiny SD stack on the CPU) against the JAX one
# ---------------------------------------------------------------------------


def _sketch(hw=64):
    s = np.zeros((hw, hw), np.float32)
    s[10:54, 28:36] = 1.0
    s[28:36, 10:54] = 0.6
    return s


def test_sketch_preprocessing_matches_jax_pil_path():
    """uint8 quantisation, 224^2 bicubic (PIL in the JAX package, PyTorch's
    antialiased bicubic here), CLIP normalisation: pixel levels within 2/255
    before normalising, for a grayscale, an RGB and an RGBA sketch."""
    pytest.importorskip("PIL")
    from sketch2img_tpu.apps.clip_guided_inf import CLIP_MEAN, CLIP_STD, ClipGuidedPipeline
    from sketch2img_torch.apps.clip_guided_inf import preprocess_sketch

    fake = types.SimpleNamespace(clip=types.SimpleNamespace(
        config=types.SimpleNamespace(image_size=224)))
    rng = np.random.RandomState(8)
    for sk in (_sketch(64), rng.rand(300, 200, 3).astype(np.float32),
               rng.rand(512, 512, 4).astype(np.float32)):
        want = ClipGuidedPipeline._preprocess_sketch(fake, sk) * CLIP_STD + CLIP_MEAN
        got = preprocess_sketch(sk, 224, "cpu").permute(1, 2, 0).numpy()
        got = got * CLIP_STD + CLIP_MEAN
        assert got.shape == want.shape == (224, 224, 3)
        assert np.abs(got - want).max() <= 2 / 255 + 1e-6


def test_clip_guided_pipeline_image_matches_jax(monkeypatch):
    """The port's ClipGuidedPipeline on a tiny SD stack against the JAX
    package's ClipGuidedPipeline.__call__ path, step for step on the same
    weights: its PIL sketch preprocessing, the CLIP encoder, the [zeros; h]
    state, ``make_attn_injected_fn`` and the VAE decode, jit-compiled (the
    JAX class's constructor, which only initialises and loads, is skipped).
    Batch 2, one sketch, per-image strengths, 2 steps, 32x32, the JAX
    pipeline's initial noise (one PRNG key for the batch) handed to the
    port. The sketch's pixels differ by up to one uint8 level between PIL
    and PyTorch: images in [0, 1] to 1e-3."""
    pytest.importorskip("PIL")
    from sketch2img_tpu.apps.clip_guided_inf import ClipGuidedPipeline as JPipe
    from sketch2img_tpu.core.export import convert_torch_sat
    from sketch2img_tpu.models.clip_vision import CLIPVisionConfig as JVisionConfig
    from sketch2img_tpu.models.clip_vision import CLIPVisionEncoder as JVision
    from sketch2img_tpu.models.clip_vision import convert_torch_clip_vision
    from sketch2img_tpu.models.vae import AutoencoderKL as JVAE
    from sketch2img_tpu.pipelines.text2img import latents_to_image as j_latents_to_image
    from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline
    from sketch2img_torch.models.clip_vision import CLIPVisionConfig
    from sketch2img_torch.runtime import SDComponents

    from fakes import FakeTokenizer
    from torch_port_stack import _merge, clip_pair, unet_pair, vae_pair

    (tu, _, jup), (tv, jv, jvp), (tc, jc, jcp) = (unet_pair(9, cross_attention_dim=32),
                                                  vae_pair(10), clip_pair(11))
    comps = SDComponents(unet=tu, vae=tv, text_encoder=tc, schedule=make_schedule(),
                         device=torch.device("cpu"), tokenizer=FakeTokenizer())
    port = ClipGuidedPipeline(components=comps, clip_config=CLIPVisionConfig(**VISION_KW))
    jcfg = junet.UNetConfig(**dict(UNET_KW, cross_attention_dim=32, injection="clip",
                                   injection_context_dim=VISION_KW["hidden_size"]))
    junet_mod = junet.UNet2DCondition(jcfg)
    params = _merge(jup, convert_torch_sat(port.unet.sat.state_dict(), jcfg))
    jclip_params = convert_torch_clip_vision(port.clip.state_dict(), VISION_KW["num_layers"])

    prompts, strengths, sk = ["a red house", "a tree"], [0.4, 1.0], _sketch()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 16, 16, 4), jnp.float32))
    fake = types.SimpleNamespace(clip=types.SimpleNamespace(
        config=types.SimpleNamespace(image_size=224)))
    px = JPipe._preprocess_sketch(fake, sk)[None]
    hidden = jax.jit(lambda p, x: JVision(JVisionConfig(**VISION_KW)).apply({"params": p}, x))(
        jclip_params, px)
    state = jnp.concatenate([jnp.zeros((2,) + hidden.shape[1:]),
                             jnp.broadcast_to(hidden, (2,) + hidden.shape[1:])])
    tok = FakeTokenizer()
    ids = [np.asarray(tok(x, padding="max_length", max_length=77).input_ids)
           for x in (["", ""], prompts)]
    encode = jax.jit(lambda p, i: jc.apply({"params": p}, i))  # one trace for both halves
    ctx = jnp.concatenate([encode(jcp, i) for i in ids])
    fn = make_attn_injected_fn(
        lambda p, x, tt, c, s, sc: junet_mod.apply({"params": p}, x, tt, c, injection_states=s,
                                                   injection_scale=sc),
        j_make_schedule(), 2, junet.num_transformer_blocks(jcfg))
    lat = jax.jit(fn)(params, jnp.asarray(noise), ctx, state, jnp.asarray(strengths), 7.5)
    want = np.asarray(jax.jit(lambda p, z: j_latents_to_image(
        lambda pp, zz: jv.apply({"params": pp}, zz, method=JVAE.decode), p, z))(jvp, lat))

    monkeypatch.setattr(port._helper, "_initial_noise", lambda *a: (t(nchw(noise)), None))
    got = port(prompts, num_inference_steps=2, width=32, height=32, seed=5,
               strength=strengths, spimg=sk)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    monkeypatch.undo()  # the port's own noise from here on
    no_sketch = port("a red house", num_inference_steps=2, width=32, height=32, seed=5)
    assert no_sketch.shape == (32, 32, 3) and np.isfinite(no_sketch).all()
    with pytest.raises(ValueError, match="strengths"):
        port(["a", "b"], num_inference_steps=1, width=32, height=32, strength=[0.5], spimg=sk)
