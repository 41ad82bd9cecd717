"""Module parity of the PyTorch port against the JAX package: UNet with taps
(forward and the gradient the guided step takes), the LGP head (fused and
naive), VAE encode/decode, CLIP text, and the small shared layers.

Weights come from the port's modules (tests/torch_port_stack.py), converted
for the JAX side by its own converters; inputs are numpy, fed to both. All
fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.models.clip_text import chunk_input_ids as j_chunk
from sketch2img_tpu.models.layers import timestep_embedding as j_temb
from sketch2img_tpu.models.lgp import lgp_fused_apply as j_lgp_fused
from sketch2img_tpu.models.unet import TAP_NAMES as J_TAP_NAMES
from sketch2img_tpu.models.unet import concat_taps as j_concat_taps
from sketch2img_tpu.models.vae import AutoencoderKL as JVAE
from sketch2img_tpu.ops.resize import resize_bilinear as j_resize
from sketch2img_torch.models.clip_text import chunk_input_ids, encode_tokens
from sketch2img_torch.models.layers import timestep_embedding
from sketch2img_torch.models.lgp import lgp_fused_apply
from sketch2img_torch.models.unet import TAP_NAMES, concat_taps, tap_channels
from sketch2img_torch.models.unet import UNetConfig
from sketch2img_torch.ops.resize import resize_bilinear

from torch_port_stack import (
    clip_pair, lgp_pair, nchw, nhwc, t, unet_pair, vae_pair,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def unet():
    return unet_pair(0)


def _unet_inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(2, 7, 24).astype(np.float32)
    return x, np.array([801, 21]), ctx


@pytest.fixture(scope="module")
def unet_outputs(unet):
    """(eps, taps) of both sides on one numpy batch (B=2, two timesteps)."""
    port, jmod, params = unet
    x, tt, ctx = _unet_inputs()
    eps_j, taps_j = jax.jit(lambda *a: jmod.apply({"params": params}, *a, capture_taps=True))(
        jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx))
    with torch.no_grad():
        eps_t, taps_t = port(t(nchw(x)), torch.tensor(tt), t(ctx), capture_taps=True)
    return (eps_t, taps_t), (np.asarray(eps_j), {n: np.asarray(v) for n, v in taps_j.items()})


def test_unet_eps_and_taps_match_jax(unet, unet_outputs):
    """fp32 through ~40 layers: 1e-4 of each output's scale."""
    (eps_t, taps_t), (eps_j, taps_j) = unet_outputs
    assert TAP_NAMES == J_TAP_NAMES and set(taps_t) == set(taps_j)
    pairs = [("eps", eps_t, eps_j)] + [(n, taps_t[n], taps_j[n]) for n in TAP_NAMES]
    for name, a, w in pairs:
        np.testing.assert_allclose(nhwc(a.numpy()), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert sum(v.shape[1] for v in taps_t.values()) == tap_channels(unet[0].config)
    assert tap_channels(UNetConfig()) == 9280  # SD1.5: 9280 tap + 4 noise + 36 pos = 9320


def test_unet_latent_gradient_matches_jax(unet):
    """d/dx of a loss over the taps (the guided step's backward, which runs
    the flash backward at the 16x16 level): 1e-4 of the gradient's scale."""
    port, jmod, params = unet
    x, tt, ctx = _unet_inputs(1)
    x, tt, ctx = x[:1], tt[:1], ctx[:1]

    def jloss(xx):
        _, taps = jmod.apply({"params": params}, xx, jnp.asarray(tt), jnp.asarray(ctx),
                             capture_taps=True)
        return sum(jnp.sum(jnp.sin(taps[n])) for n in J_TAP_NAMES)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = t(nchw(x)).requires_grad_(True)
    _, taps = port(xt, torch.tensor(tt), t(ctx), capture_taps=True)
    (g,) = torch.autograd.grad(sum(torch.sin(taps[n]).sum() for n in TAP_NAMES), xt)
    np.testing.assert_allclose(nhwc(g.numpy()), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def lgp_case(unet_outputs):
    nl = (0.3 * np.random.RandomState(4).randn(2, 16, 16, 4)).astype(np.float32)
    return lgp_pair(5), unet_outputs[1][1], nl


def test_lgp_fused_matches_jax_fused_and_naive(lgp_case):
    """Port fused head vs the JAX package's fused head and its naive
    (concat_taps + LatentEdgePredictor) path, and the port's own naive path.
    fp32: 1e-4 of the output scale."""
    (port, jmod, jvars), taps, nl = lgp_case
    jtaps = {n: jnp.asarray(v) for n, v in taps.items()}
    want_fused = np.asarray(jax.jit(lambda tp, z: j_lgp_fused(jvars, tp, z, 16, 16))(
        jtaps, jnp.asarray(nl)))
    want_naive = np.asarray(jax.jit(lambda tp, z: jmod.apply(
        jvars, j_concat_taps(tp, 16, 16), z, train=False))(jtaps, jnp.asarray(nl)))
    taps_t = {n: t(nchw(v)) for n, v in taps.items()}
    with torch.no_grad():
        got_fused = nhwc(lgp_fused_apply(port, taps_t, t(nchw(nl)), 16, 16).numpy())
        got_naive = nhwc(port(concat_taps(taps_t, 16, 16), t(nchw(nl))).numpy())
    scale = np.abs(want_naive).max()
    for got, want in ((got_fused, want_fused), (got_fused, want_naive),
                      (got_naive, want_naive)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def vae():
    return vae_pair(0)


def test_vae_encode_decode_match_jax(vae):
    """fp32: mean/logvar and the decoded image to 1e-4 of their scale."""
    port, jmod, params = vae
    rng = np.random.RandomState(6)
    img = np.tanh(rng.randn(1, 32, 32, 3)).astype(np.float32)
    z = rng.randn(1, 16, 16, 4).astype(np.float32)
    jm, jl = jax.jit(lambda a: jmod.apply({"params": params}, a, method=JVAE.encode))(
        jnp.asarray(img))
    jd = jax.jit(lambda a: jmod.apply({"params": params}, a, method=JVAE.decode))(
        jnp.asarray(z))
    with torch.no_grad():
        tm, tl = port.encode(t(nchw(img)))
        td = port.decode(t(nchw(z)))
    for a, w in ((tm, jm), (tl, jl), (td, jd)):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(a.numpy()), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_clip_text_matches_jax():
    """Causal 2-layer encoder, fp32: 1e-5 of the output scale; also a short
    sequence (positions sliced) and the >77-token chunking helpers."""
    port, jmod, params = clip_pair(0)
    rng = np.random.RandomState(7)
    japply = jax.jit(lambda a: jmod.apply({"params": params}, a))
    for n in (77, 12):
        ids = rng.randint(0, 100, size=(2, n))
        want = np.asarray(japply(jnp.asarray(ids)))
        with torch.no_grad():
            got = port(torch.tensor(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    rows = [list(range(1, 170)), list(range(5, 40))]
    for a, b in zip(chunk_input_ids(rows), j_chunk(rows)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():  # ids folded into the tiny vocab (BOS/EOS are 49406/49407)
        states = encode_tokens(lambda ids: port(ids % 100), [list(rng.randint(0, 100, 90))],
                               "cpu")
    assert states.shape == (1, 77 + 17, 32)  # windows of 75 + 15 tokens, each + BOS/EOS


def test_timestep_embedding_and_resize_match_jax():
    """Embedding: sin/cos of fp32 arguments up to ~1000 rad, where one fp32
    ulp of the argument is 6e-5: 2e-4 absolute. Resize: 1e-5."""
    tt = np.array([0, 1, 500, 999])
    for dim in (320, 33):
        np.testing.assert_allclose(timestep_embedding(torch.tensor(tt), dim).numpy(),
                                   np.asarray(j_temb(jnp.asarray(tt), dim)),
                                   rtol=0, atol=2e-4)
    x = np.random.RandomState(8).randn(1, 8, 8, 3).astype(np.float32)
    for hw in ((16, 16), (64, 32), (4, 4)):
        np.testing.assert_allclose(nhwc(resize_bilinear(t(nchw(x)), *hw).numpy()),
                                   np.asarray(j_resize(jnp.asarray(x), *hw)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((8, 8), (64, 64)), ((16, 16), (64, 64)),
                                     ((32, 32), (64, 64)), ((5, 7), (12, 9))])
def test_resize_backward_matches_jax(src, dst):
    """The bilinear resize's backward (the adjoint through the 1-D
    interpolation matrices, which replaces PyTorch's atomic-add CUDA
    backward) against ``jax.vjp`` of the JAX package's resize: 1e-5 of the
    gradient's scale. The taps' upsamplings to 64^2 and a ragged one."""
    rng = np.random.RandomState(sum(src + dst))
    x = rng.randn(2, *src, 3).astype(np.float32)
    dy = rng.randn(2, *dst, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_resize(a, *dst), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = t(nchw(x)).requires_grad_(True)
    (got,) = torch.autograd.grad(resize_bilinear(xt, *dst), xt, t(nchw(dy)))
    np.testing.assert_allclose(nhwc(got.numpy()), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_geglu_uses_tanh_under_bf16():
    from sketch2img_torch.models.layers import GEGLU

    m = GEGLU(8, 16)
    x = torch.randn(3, 8)
    h, gate = m.proj(x).chunk(2, dim=-1)
    torch.testing.assert_close(m(x), h * torch.nn.functional.gelu(gate))
    mb = m.to(torch.bfloat16)
    xb = x.bfloat16()
    h, gate = mb.proj(xb).chunk(2, dim=-1)
    torch.testing.assert_close(mb(xb), h * torch.nn.functional.gelu(gate, approximate="tanh"))
