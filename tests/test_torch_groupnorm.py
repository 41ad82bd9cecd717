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

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.ops import groupnorm as jgn
from sketch2img_torch.ops import groupnorm as tgn

from torch_port_util import c_params, c_struct, one_torch_thread  # noqa: F401

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


# the parts of both paths with the batches each runs at: the UNet at 1 and
# 2 (sketch-guided) and 16 (injection, whose injected UNet has the same
# norms), the VAE encoder at 1 and its decoder at 1 and 8
PATH_BATCHES = [("unet", 1), ("unet", 2), ("unet", 16), ("vae_encoder", 1),
                ("vae_decoder", 1), ("vae_decoder", 8)]
# (C, H, W) of the norms whose groups (2 MB and up) take the split variant
_SPLIT_SHAPES = {
    ("unet", 2): set(),
    ("vae_encoder", 2): {(128, 512, 512)},
    ("vae_decoder", 2): {(128, 512, 512), (256, 512, 512), (512, 256, 256)},
    ("unet", 4): set(),
    ("vae_encoder", 4): {(128, 512, 512), (256, 256, 256)},
    ("vae_decoder", 4): {(128, 512, 512), (256, 512, 512), (256, 256, 256),
                         (512, 256, 256)},
}


@pytest.fixture(scope="module")
def path_shapes():
    """{part: sorted (C, H, W) of its GroupNorm calls}, from one pass of the
    full-width SD1.5 UNet and VAE on the meta device (shapes only, nothing
    is computed)."""
    from sketch2img_torch.models.unet import SD15_CONFIG, UNet2DCondition
    from sketch2img_torch.models.vae import SD15_VAE_CONFIG, AutoencoderKL
    from sketch2img_torch.ops.attention import set_default_attention_backend

    calls, real = [], tgn._forward
    tgn._forward = lambda x, *a: calls.append(tuple(x.shape[1:])) or torch.empty_like(x)
    set_default_attention_backend("plain")
    try:
        with torch.device("meta"), torch.no_grad():
            unet, vae = UNet2DCondition(SD15_CONFIG), AutoencoderKL(SD15_VAE_CONFIG)
            unet(torch.empty(1, 4, 64, 64), torch.tensor([500]), torch.empty(1, 77, 768))
            n_unet = len(calls)
            vae.encode(torch.empty(1, 3, 512, 512))
            n_enc = len(calls) - n_unet
            vae.decode(torch.empty(1, 4, 64, 64))
    finally:
        tgn._forward = real
        set_default_attention_backend("auto")
    assert (n_unet, n_enc, len(calls) - n_unet - n_enc) == (61, 22, 30)
    return {"unet": sorted(set(calls[:n_unet])),
            "vae_encoder": sorted(set(calls[n_unet:n_unet + n_enc])),
            "vae_decoder": sorted(set(calls[n_unet + n_enc:]))}


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("part,b", PATH_BATCHES)
def test_plan_takes_one_pass_with_a_legal_cluster_wherever_a_group_fits(path_shapes, part, b,
                                                                        elem_bytes):
    """Every GroupNorm shape of one part of a path at one batch: groups of
    up to 1 MB take the one-pass variant on a cluster of 1-16 blocks (a
    power of two), one block for a group of up to 20 KB, with slices that
    cover the group and hold at most 96 KB (two blocks an SM); larger groups
    (2 MB and up) take the split variant: in bf16 the VAE's 512^2 norms and
    its decoder's 256^2 norms at 512 channels."""
    es = elem_bytes
    split = set()
    for c, h, w in path_shapes[part]:
        n = c // 32 * h * w
        plan = tgn.launch_plan(b, c, h * w, 32, es)
        assert (plan.kernel == tgn.ONE_PASS) == (n * es <= 2 ** 20), (b, c, h, w, es)
        if plan.kernel == tgn.ONE_PASS:
            assert plan.cluster in (1, 2, 4, 8, 16) and plan.splits == 1
            assert plan.cluster == 1 or n * es > 20 * 1024
            assert plan.chunk % 8 == 0
            assert (plan.cluster - 1) * plan.chunk < n <= plan.cluster * plan.chunk
            assert plan.smem == plan.chunk * es <= 96 * 1024
            assert plan.threads in (128, 256, 512)
        else:
            assert plan.kernel == tgn.SPLIT and plan.cluster == 1 and plan.smem == 0
            assert (plan.splits, plan.chunk) == tgn.split_plan(b, c, h * w, 32)
            split.add((c, h, w))
    assert split == _SPLIT_SHAPES[part, es]


@pytest.mark.parametrize("b,c,hw,es,want", [
    (1, 32, 10240, 2, (tgn.ONE_PASS, 1, 10240)),     # a 20 KB group: one block
    (1, 32, 5120, 4, (tgn.ONE_PASS, 1, 5120)),       # the same in fp32
    # 16 bytes more: 32 groups are too few to fill the card, so the group is
    # cut into slices of about 10 KB (4 of them) rather than one of 96 KB
    (1, 32, 10248, 2, (tgn.ONE_PASS, 4, 2568)),
    (16, 320, 4096, 2, (tgn.ONE_PASS, 1, 40960)),    # 80 KB, but 512 groups fill the card
    (1, 32, 786432, 2, (tgn.ONE_PASS, 16, 49152)),   # 16 slices of 96 KB: the largest group
    (1, 32, 393216, 4, (tgn.ONE_PASS, 16, 24576)),   # the same in fp32
    (1, 32, 786440, 2, (tgn.SPLIT, 1, None)),        # 16 bytes more: split
    (1, 32, 393218, 4, (tgn.SPLIT, 1, None)),        # the same in fp32
])
def test_plan_at_the_variants_boundaries(b, c, hw, es, want):
    """Group sizes on either side of the rule's thresholds (one block up to
    20 KB, one pass up to 16 slices of 96 KB) and a batch that fills the
    card with groups alone."""
    plan = tgn.launch_plan(b, c, hw, 32, es)
    kernel, cluster, chunk = want
    assert (plan.kernel, plan.cluster) == (kernel, cluster)
    if kernel == tgn.ONE_PASS:
        assert plan.chunk == chunk and plan.smem == chunk * es and plan.splits == 1
    else:
        assert (plan.splits, plan.chunk) == tgn.split_plan(b, c, hw, 32)


def test_plan_is_cached_per_key_and_variants_can_be_forced():
    """One plan per shape and dtype (and one C struct per call key); a
    variant can be forced, one pass only where the group fits."""
    plan = tgn.launch_plan(1, 320, 64 * 64, 32, 2)
    assert tgn.launch_plan(1, 320, 64 * 64, 32, 2) is plan
    assert plan == (tgn.ONE_PASS, 8, 5120, 1, 10240, 256)
    # forced one pass on a 2 MB group: 16 blocks of 128 KB
    assert tgn.launch_plan(1, 128, 512 * 512, 32, 2, tgn.ONE_PASS) == (
        tgn.ONE_PASS, 16, 65536, 1, 131072, 512)
    key = ((1, 320, 64, 64), torch.bfloat16, torch.float32, 32, 1e-5, True, 0, None)
    call = tgn._call_plan(*key)
    assert tgn._call_plan(*key) is call and call.plan == plan
    st = call.struct
    assert (st.B, st.C, st.HW, st.G, st.variant, st.cluster, st.S, st.chunk, st.smem,
            st.threads) == (1, 320, 4096, 32, 0, 8, 1, 5120, 10240, 256)
    assert (st.silu, st.dtype, st.pdtype) == (1, 0, 1) and abs(st.eps - 1e-5) < 1e-12
    assert ctypes.sizeof(tgn._PlanStruct) == 64  # the C struct: 8 ints, a long long, 6 words
    forced = tgn.launch_plan(1, 320, 64 * 64, 32, 2, tgn.SPLIT)
    assert forced.kernel == tgn.SPLIT and forced.cluster == 1
    with pytest.raises(ValueError, match="split variant"):
        tgn.launch_plan(1, 256, 512 * 512, 32, 2, tgn.ONE_PASS)  # 4 MB
    with pytest.raises(ValueError, match="unknown"):
        tgn.launch_plan(1, 256, 64 * 64, 32, 2, "groupnorm_silu_fast")
    assert set(tgn.LAUNCHES) == {tgn.ONE_PASS, tgn.SPLIT}


@pytest.mark.parametrize("name", sorted(tgn.ARGTYPES))
def test_ctypes_signatures_match_the_source(name):
    """The wrapper's ctypes parameters of each C entry point are those of
    csrc/groupnorm_silu.cu, one for one (the plan by pointer to the struct
    below)."""
    plan = {"gn::Plan": ctypes.POINTER(tgn._PlanStruct)}
    assert tgn.ARGTYPES[name] == c_params("groupnorm_silu.cu", name, plan)


def test_plan_struct_matches_the_source():
    """``_PlanStruct`` is the kernel's ``gn::Plan``, field for field."""
    assert tgn._PlanStruct._fields_ == c_struct("groupnorm_silu.cu", "Plan")


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


@pytest.mark.cuda
def test_cuda_variants_match_plain_version_on_card():
    """Both variants on both sides of their boundary, in bf16 and fp32: the
    largest groups one pass takes (2 MB: 16-block clusters of 128 KB,
    forced; the plan sends them to the split variant), 1 MB groups (the
    largest the plan gives one pass), 4 MB groups (split only), a one-block
    group, and H*W not a multiple of 8 (element-wise loads), each planned
    and, where the group fits, forced into the other variant. bf16: max error within 1% of max|plain|
    (one bf16 rounding of the output, 2^-9, plus another summation order);
    fp32: 1e-4 of it (summation order only). Launches counted by variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda tests/test_torch_groupnorm.py` "
                    "on the GPU machine")
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    for shape, dt in (((1, 128, 512, 512), bf16), ((1, 256, 512, 512), bf16),
                      ((1, 256, 256, 256), bf16), ((1, 256, 256, 256), fp32),
                      ((1, 128, 512, 512), fp32),
                      ((1, 1280, 8, 8), bf16), ((3, 96, 7, 5), fp32), ((2, 64, 9, 9), bf16)):
        b, c, h, w = shape
        x = (torch.randn(*shape, generator=gen, device="cuda") + 0.5).to(dt)
        wt = torch.rand(c, generator=gen, device="cuda").to(dt) + 0.5
        bs = torch.randn(c, generator=gen, device="cuda").to(dt)
        want = tgn.group_norm_silu_plain(x, wt, bs, 32, 1e-6, True)
        tol = (1e-2 if dt == bf16 else 1e-4) * want.float().abs().max().item()
        fits = x.element_size() * c // 32 * h * w <= 16 * (200 * 1024 - 16)
        for kernel in (tgn.ONE_PASS, tgn.SPLIT):
            if kernel == tgn.ONE_PASS and not fits:
                continue
            tgn.reset_launch_counts()
            got = tgn.group_norm_silu_kernel(x, wt, bs, 32, 1e-6, True, kernel=kernel)
            torch.cuda.synchronize()
            assert tgn.LAUNCHES == {k: int(k == kernel) for k in tgn.LAUNCHES}
            assert (got.float() - want.float()).abs().max().item() <= tol, (shape, dt, kernel)
