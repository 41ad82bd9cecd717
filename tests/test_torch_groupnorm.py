"""The port's fused GroupNorm(+SiLU) against the JAX package's.

On the CPU the port's ``group_norm_silu`` runs its plain PyTorch version
(the CUDA kernel needs the card); the JAX side runs the Pallas kernel in
interpret mode where its gate takes the shape (C a multiple of 128), else
its XLA reference. Same numpy inputs (NHWC for JAX, NCHW for the port),
fp32, forward and gradients. Also: the kernel wrapper's input checks, the
split plan, and that every GroupNorm of the UNet and VAE goes through the
op. A last test, marked ``cuda``, holds the kernel against the plain
version on a card and skips elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.ops import groupnorm as jgn
from sketch2img_torch.ops import groupnorm as tgn

# tiny configs of tests/torch_port_stack.py, repeated here so that this file
# imports no flax (the machine with the card has jax but not flax)
UNET_KW = dict(block_out_channels=(32, 32, 64), cross_attn=(True, True, False),
               layers_per_block=1, num_heads=2, cross_attention_dim=24)
VAE_KW = dict(block_out_channels=(32, 64), layers_per_block=1)


def nchw(x):
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))

# fp32 on both sides; the JAX kernel takes E[x^2] - E[x]^2 from channel sums,
# the plain version the two-pass variance: agreement to ~1e-6 on these
# unit-scale inputs, checked at 2e-5 of the output's scale
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    jgn.set_interpret_mode(True)
    yield
    jgn.set_interpret_mode(False)


def _inputs(seed, shape, offset=0.0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (offset + rng.randn(*shape)).astype(np.float32)
    return x, (rng.rand(c) + 0.5).astype(np.float32), rng.randn(c).astype(np.float32)


def _port(x, scale, bias, groups, eps, silu):
    return nhwc(tgn.group_norm_silu(t(nchw(x)), t(scale), t(bias), groups, eps, silu).numpy())


@pytest.mark.parametrize("shape,eps,silu,offset", [
    ((1, 8, 8, 128), 1e-5, True, 0.0),
    ((1, 8, 8, 128), 1e-6, False, 1.5),
    ((2, 4, 8, 256), 1e-6, True, 0.0),
    ((2, 4, 8, 256), 1e-5, False, -1.0),
])
def test_plain_matches_pallas_kernel(shape, eps, silu, offset):
    x, scale, bias = _inputs(0, shape, offset)
    assert jgn.supported(jnp.asarray(x), 32)
    want = np.asarray(jgn.fused_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale),
                                               jnp.asarray(bias), 32, eps, silu))
    got = _port(x, scale, bias, 32, eps, silu)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("c", [320, 96])
def test_plain_matches_xla_reference_where_pallas_declines(c):
    """C = 320 (the UNet's first width) and 96 are not 128-multiples: the
    JAX package takes its XLA reference."""
    x, scale, bias = _inputs(1, (2, 4, 4, c))
    assert not jgn.supported(jnp.asarray(x), 32)
    for silu in (True, False):
        want = np.asarray(jgn._xla_reference(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias), 32, 1e-6, silu))
        got = _port(x, scale, bias, 32, 1e-6, silu)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_gradients_match_jax_custom_vjp():
    """d/d(x, gamma, beta) of sum(y^2) through the Function (its backward
    differentiates the recomputed plain version) against jax.grad of the
    Pallas kernel's custom_vjp. fp32: 1e-5 of each gradient's scale."""
    x, scale, bias = _inputs(2, (1, 8, 8, 128))
    want = jax.grad(lambda a, s, b: jnp.sum(jgn._fused(a, s, b, 32, 1e-5, True) ** 2),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (nchw(x), scale, bias))
    (tgn.group_norm_silu(xt, st, bt, 32, 1e-5, True) ** 2).sum().backward()
    for got, w in ((nhwc(xt.grad.numpy()), want[0]), (st.grad.numpy(), want[1]),
                   (bt.grad.numpy(), want[2])):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.randn(1, 64, 4, 4)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="contiguous"):
        tgn.group_norm_silu_kernel(x.to(memory_format=torch.channels_last), w, b, 32, 1e-5, True)
    with pytest.raises(ValueError, match="contiguous"):
        tgn.group_norm_silu_kernel(x[:, :, :, :2], w, b, 32, 1e-5, True)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tgn.group_norm_silu_kernel(x.double(), w, b, 32, 1e-5, True)
    with pytest.raises(ValueError, match="groups"):
        tgn.group_norm_silu_kernel(x[:, :48].contiguous(), w[:48], b[:48], 32, 1e-5, True)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_silu_kernel(x, w, b, 32, 1e-5, True)


@pytest.mark.parametrize("b,c,hw", [(1, 128, 512 * 512), (16, 320, 64 * 64), (16, 1280, 64),
                                    (2, 640, 32 * 32), (1, 32, 9), (3, 96, 7 * 5)])
def test_split_plan_covers_each_group(b, c, hw):
    s, chunk = tgn.split_plan(b, c, hw, 32)
    n = (c // 32) * hw
    assert chunk % 8 == 0 and 1 <= s <= 256
    assert (s - 1) * chunk < n <= s * chunk  # every chunk holds at least one element
    if n >= 2048 * 528 // (b * 32):
        assert s * b * 32 >= 528  # large tensors fill the card: four blocks per SM


def test_every_unet_and_vae_groupnorm_goes_through_the_op(monkeypatch):
    """Counts calls of the op's forward during one pass of a tiny UNet and
    VAE: 2 per resnet, 1 per SpatialTransformer, 1 per VAE attention, 1 per
    conv_norm_out (the counts chip_smoke.py expects at full width)."""
    from sketch2img_torch.models import unet as tunet
    from sketch2img_torch.models import vae as tvae

    calls = []
    real = tgn._forward
    monkeypatch.setattr(tgn, "_forward", lambda x, *a: calls.append(a[-1]) or real(x, *a))
    cfg = tunet.UNetConfig(**UNET_KW)
    unet = tunet.UNet2DCondition(cfg)
    vae = tvae.AutoencoderKL(tvae.VAEConfig(**VAE_KW))
    with torch.no_grad():
        unet(torch.randn(1, 4, 16, 16), torch.tensor([5]), torch.randn(1, 7, 24))
        n_unet = len(calls)
        vae.decode(torch.randn(1, 4, 8, 8))
        n_dec = len(calls) - n_unet
    resnets = sum(1 for m in unet.modules() if type(m).__name__ == "ResnetBlock")
    assert n_unet == 2 * resnets + tunet.num_transformer_blocks(cfg) + 1
    dec_resnets = sum(1 for m in vae.decoder.modules() if type(m).__name__ == "ResnetBlock")
    assert n_dec == 2 * dec_resnets + 1 + 1
    assert sum(calls) == 2 * resnets + 1 + 2 * dec_resnets + 1  # silu on every one but
    # the transformer and VAE-attention norms


def test_module_takes_channels_last_and_rounds_once_under_bf16():
    """The model's GroupNorm copies a channels-last input to NCHW first; in
    bf16 it equals the fp32 GroupNorm+SiLU rounded once."""
    from sketch2img_torch.models.layers import GroupNorm

    gnm = GroupNorm(32, 64, eps=1e-6)
    with torch.no_grad():
        gnm.weight.uniform_(0.5, 1.5)
        gnm.bias.normal_()
    x = torch.randn(2, 64, 4, 4)
    want = gnm(x, silu=True)
    got = gnm(x.to(memory_format=torch.channels_last), silu=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    xb = x.bfloat16()
    once = gnm(xb.float(), silu=True).bfloat16()  # fp32 math on the bf16 input, one rounding
    torch.testing.assert_close(gnm(xb, silu=True), once, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_card():
    """bf16 and fp32 at a UNet, a VAE and a ragged shape (H*W not a multiple
    of 8: the element-wise path), silu on and off. bf16: max error within 1%
    of max|plain| (one bf16 rounding of the output, 2^-9, plus another
    summation order); fp32: 1e-4 of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda tests/test_torch_groupnorm.py` "
                    "on the GPU machine")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, c, h, w), dt, silu in (((2, 320, 64, 64), torch.bfloat16, True),
                                   ((1, 128, 256, 256), torch.bfloat16, False),
                                   ((3, 96, 7, 5), torch.float32, True)):
        x = (torch.randn(b, c, h, w, generator=gen, device="cuda") + 0.5).to(dt)
        wt = torch.rand(c, generator=gen, device="cuda").to(dt) + 0.5
        bs = torch.randn(c, generator=gen, device="cuda").to(dt)
        got = tgn.group_norm_silu_kernel(x, wt, bs, 32, 1e-6, silu)
        want = tgn.group_norm_silu_plain(x, wt, bs, 32, 1e-6, silu)
        torch.cuda.synchronize()
        tol = (1e-2 if dt == torch.bfloat16 else 1e-4) * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol
