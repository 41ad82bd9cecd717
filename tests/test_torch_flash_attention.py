"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version
(the CUDA kernels need the card); the JAX side runs the Pallas kernels in
interpret mode, in both of their layouts (d-major "transposed" and
"classic"). Same numpy inputs on both sides, forward and gradients. A last
test, marked ``cuda``, holds the CUDA kernels against the plain version on a
card and skips elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.ops import attention as jattn
from sketch2img_tpu.ops import flash_attention as jfa
from sketch2img_torch.ops import attention as tattn
from sketch2img_torch.ops import flash_attention as tfa

from torch_port_util import c_params, one_torch_thread  # noqa: F401 (autouse)

# fp32 on both sides; the kernels sum in blocks and in the exp2 domain, the
# plain version in one pass: agreement to ~1e-6, checked at 2e-5
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.set_interpret_mode(True)
    yield
    jfa.set_interpret_mode(False)


@pytest.fixture(params=[True, False], ids=["transposed", "classic"])
def jax_layout(request):
    jfa.set_transposed_kernels(request.param)
    yield
    jfa.set_transposed_kernels(True)


def _qkv(seed, b, h, nq, nk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, n, d).astype(np.float32) for n in (nq, nk, nk)]


def _jax_out_grads(q, k, v, scale, kv_len=None):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, scale, None, kv_len)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_out_grads(q, k, v, scale, kv_len=None):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, scale, kv_len=kv_len)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("shape", [(1, 2, 256, 40), (1, 2, 300, 64)],
                         ids=["sd-d40", "ragged-300"])
def test_forward_and_gradients_match_jax_kernels(jax_layout, shape):
    b, h, n, d = shape
    q, k, v = _qkv(0, b, h, n, n, d)
    want, gwant = _jax_out_grads(q, k, v, d ** -0.5)
    got, ggot = _port_out_grads(q, k, v, d ** -0.5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for a, w in zip(ggot, gwant):
        np.testing.assert_allclose(a, w, rtol=TOL, atol=TOL)


def test_kv_len_tail_matches_jax_kernels(jax_layout):
    """Keys padded with garbage past kv_len: masked exactly, and the tail's
    dK/dV are zero on both sides."""
    b, h, nq, nk, d, kv_len = 1, 2, 256, 384, 40, 300
    q, k, v = _qkv(1, b, h, nq, nk, d)
    k[:, :, kv_len:] += 37.0
    v[:, :, kv_len:] += 37.0
    want, gwant = _jax_out_grads(q, k, v, d ** -0.5, kv_len)
    got, ggot = _port_out_grads(q, k, v, d ** -0.5, kv_len)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for a, w in zip(ggot, gwant):
        np.testing.assert_allclose(a, w, rtol=TOL, atol=TOL)
    for g in ggot[1:]:
        assert np.all(g[:, :, kv_len:] == 0.0)


def test_backward_dq_and_delta_match_jax_backward():
    """The port's dQ entry (``flash_backward_dq``: on the CPU its plain
    version, on the card the dQ kernel that also writes delta) against the
    JAX package's ``_flash_backward`` (classic layout, interpret mode), fed
    the same O and LSE from the JAX forward, with a kv_len tail; delta
    against rowsum(dO * O). fp32: TOL."""
    b, h, nq, nk, d, kv_len = 1, 2, 256, 300, 40, 290
    q, k, v = _qkv(4, b, h, nq, nk, d)
    do = np.random.RandomState(5).randn(b, h, nq, d).astype(np.float32)
    o, lse = jfa._flash_forward(*(jnp.asarray(x) for x in (q, k, v)), d ** -0.5, kv_len)
    want = np.asarray(jfa._flash_backward(*(jnp.asarray(x) for x in (q, k, v)), o, lse,
                                          jnp.asarray(do), d ** -0.5, kv_len)[0])
    lse_t = torch.tensor(np.asarray(lse)[:, :nq, 0]).view(b, h, nq)
    o_t = torch.tensor(np.asarray(o))
    dq, delta = tfa.flash_backward_dq(*(torch.tensor(x) for x in (q, k, v)), o_t, lse_t,
                                      torch.tensor(do), d ** -0.5, kv_len)
    np.testing.assert_allclose(dq.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(delta.numpy(), (do * np.asarray(o)).sum(-1), rtol=TOL, atol=TOL)


def test_lse_is_natural_log():
    q, k, v = _qkv(2, 1, 2, 256, 256, 40)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    _, lse = tfa.flash_forward(qt, kt, vt, 40 ** -0.5)
    want = torch.logsumexp(qt @ kt.transpose(-1, -2) * 40 ** -0.5, dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("nq,nk,d,masked", [
    (256, 256, 40, False), (128, 128, 256, False), (256, 77, 40, False),
    (64, 64, 40, False), (256, 256, 264, False), (256, 256, 40, True),
])
def test_gates_match_jax(nq, nk, d, masked):
    q, k = np.zeros((1, 2, nq, d), np.float32), np.zeros((1, 2, nk, d), np.float32)
    mask = np.zeros((1, 1, nq, nk), np.float32) if masked else None
    for tf, jf in ((tfa.supported, jfa.supported), (tfa.preferred, jfa.preferred)):
        assert tf(torch.tensor(q), torch.tensor(k), None,
                  None if mask is None else torch.tensor(mask)) == jf(
            jnp.asarray(q), jnp.asarray(k), None, None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("case", ["self-flash", "cross-77", "masked", "kv_len", "mid-64"])
def test_multi_head_attention_matches_jax(case):
    """Routing and math of ``multi_head_attention`` against the JAX package's
    (XLA path, the reference both sides of the gate are held to), with
    gradients w.r.t. q, k, v."""
    rng = np.random.RandomState(3)
    heads, dh = 2, 40
    nq, nk = {"self-flash": (256, 256), "cross-77": (256, 77), "masked": (128, 128),
              "kv_len": (256, 384), "mid-64": (64, 64)}[case]
    q, k, v = (rng.randn(2, n, heads * dh).astype(np.float32) for n in (nq, nk, nk))
    mask = None
    if case == "masked":
        mask = np.triu(np.full((nq, nk), -1e9, np.float32), 1)[None, None]
    kv_len = 300 if case == "kv_len" else None

    def jloss(q, k, v):
        out = jattn.multi_head_attention(q, k, v, heads, backend="xla", kv_len=kv_len,
                                         mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(jnp.sin(out)), out

    (_, want), gw = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = tattn.multi_head_attention(qt, kt, vt, heads, kv_len=kv_len,
                                     mask=None if mask is None else torch.tensor(mask))
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for a, w in zip((qt, kt, vt), gw):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_flash_sites_take_the_flash_function(monkeypatch):
    """Sites that pass the gate go through ``flash_attention`` (on a CPU
    tensor: its plain version); the others never reach it."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    x = torch.randn(1, 256, 80)
    tattn.multi_head_attention(x, x, x, 2)
    tattn.multi_head_attention(x, x[:, :77], x[:, :77], 2)
    tattn.multi_head_attention(x, x, x, 2, backend="plain")
    assert calls == [(1, 2, 256, 40)]
    with pytest.raises(ValueError):
        tattn.multi_head_attention(x[:, :64], x[:, :64], x[:, :64], 2, backend="flash")


# ---------------------------------------------------------------------------
# the wrapper's argument preparation (pure, runs on CPU tensors)
# ---------------------------------------------------------------------------


def _heads_view(b, h, n, d, dtype=torch.bfloat16, seed=0):
    """q/k/v as the model passes them: a (B, H, N, d) view of a (B, N, H*d)
    projection, strides (N*H*d, d, H*d, 1)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, n, h * d, generator=g).to(dtype).view(b, n, h, d).transpose(1, 2)


@pytest.mark.parametrize("case,accepts", [
    ("contiguous-d40", True),        # row pitch 80 B
    ("heads-view-d40", True),        # the UNet's q/k/v: strides (N*H*d, d, H*d, 1)
    ("heads-view-d64", True),        # the ViT's
    ("contiguous-d36", False),       # 72-byte rows
    ("heads-view-d36", False),       # head offset 72 B
    ("sliced-d", False),             # unit stride on d but a 2-byte base offset
    ("d-strided", False),            # no unit stride on d
    ("fp32", False),                 # TMA reads bf16 only
    ("batch1-odd-stride", True),     # a size-1 dim's stride is never used
])
def test_tma_accepts(case, accepts):
    x = {
        "contiguous-d40": lambda: torch.zeros(2, 8, 64, 40, dtype=torch.bfloat16),
        "heads-view-d40": lambda: _heads_view(2, 8, 64, 40),
        "heads-view-d64": lambda: _heads_view(1, 16, 257, 64),
        "contiguous-d36": lambda: torch.zeros(1, 2, 64, 36, dtype=torch.bfloat16),
        "heads-view-d36": lambda: _heads_view(1, 2, 64, 36),
        "sliced-d": lambda: torch.zeros(1, 2, 64, 48, dtype=torch.bfloat16)[..., 1:41],
        "d-strided": lambda: torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16).transpose(2, 3),
        "fp32": lambda: torch.zeros(1, 2, 64, 40),
        "batch1-odd-stride": lambda: torch.zeros(2, 64, 40, dtype=torch.bfloat16).as_strided(
            (1, 2, 64, 40), (3, 64 * 40, 40, 1)),
    }[case]()
    assert tfa.tma_accepts(x) is accepts


@pytest.mark.parametrize("case", ["heads-view", "fp32-heads-view", "d36", "d-strided"])
def test_prepare_operand_copies_only_what_tma_refuses(case):
    """The cast and the copy keep the values; a copy gets a row pitch that
    is a multiple of 8 elements and is what TMA takes; a tensor TMA takes
    is passed through as it is."""
    x = {"heads-view": lambda: _heads_view(2, 4, 64, 40),
         "fp32-heads-view": lambda: _heads_view(2, 4, 64, 40, torch.float32),
         "d36": lambda: _heads_view(1, 2, 64, 36),
         "d-strided": lambda: _heads_view(1, 2, 64, 40).transpose(2, 3).contiguous()
         .transpose(2, 3)}[case]()
    y, copied = tfa.prepare_operand(x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert torch.equal(y.float(), x.to(torch.bfloat16).float())
    assert tfa.tma_accepts(y)
    assert copied is (case in ("d36", "d-strided"))
    if case == "heads-view":
        assert y is x
    if copied:
        assert y.stride(2) == -(-x.shape[3] // 8) * 8


@pytest.mark.parametrize("d,copied", [(40, False), (36, True)])
def test_backward_operands_include_o_for_dq(d, copied):
    """The backward's operands are q, k, v, dO (read by both kernels,
    copies counted under dK/dV) and O (read by the dQ kernel for delta,
    counted under dQ); the forward's O, a heads-merged view, is taken in
    place when its rows are 16-byte multiples."""
    q, k, v, do, o = (_heads_view(1, 2, 64, d, seed=i) for i in range(5))
    tfa.reset_launch_counts()
    out = tfa.backward_operands(q, k, v, o, do)
    assert len(out) == 5 and all(tfa.tma_accepts(x) for x in out)
    for got, x in zip(out, (q, k, v, do, o)):
        assert torch.equal(got.float(), x.float())
        assert (got is x) is not copied
    assert tfa.TMA_COPIES == {"flash_fwd": 0, "flash_bwd_dq": int(copied),
                              "flash_bwd_dkv": 4 * int(copied)}


@pytest.mark.parametrize("nk,kv_len,want", [(384, None, 384), (384, 300, 300), (384, 999, 384),
                                            (77, 77, 77)])
def test_kv_len_is_clamped_to_the_keys(nk, kv_len, want):
    assert tfa._kv_len(nk, kv_len) == want


@pytest.mark.parametrize("kv_len", [0, -3])
def test_kv_len_below_one_is_refused(kv_len):
    with pytest.raises(ValueError):
        tfa._kv_len(384, kv_len)


@pytest.mark.parametrize("name", sorted(tfa.ARGTYPES))
def test_ctypes_signatures_match_the_sources(name):
    """The wrapper's ctypes parameters of each kernel's C entry point are
    those of its source (csrc/<name>.cu), one for one."""
    assert tfa.ARGTYPES[name] == c_params(name + ".cu", name)


def test_committed_wgmma_header_is_generated():
    import os

    from sketch2img_torch.utils import gen_wgmma
    from sketch2img_torch.utils.cuda_build import CSRC_DIR

    with open(os.path.join(CSRC_DIR, gen_wgmma.HEADER)) as f:
        assert f.read() == gen_wgmma.render()


# Card-only: (B, H, nq, nk, d, kv_len, layout). One shape of every head-dim
# bucket of FA_DISPATCH_DP (d = 24 -> 32, 40 -> 48, 64, 72 -> 80, 96, 112 ->
# 128, 160, 176 -> 192, 256), a main-path shape, a ragged nq/nk, the
# injection's kv_len concat, fewer keys than a key tile, a head dim that is
# not a multiple of 8 (copied for TMA), q/k/v as heads-views of (B, N, H*d)
# projections (not copied), and fp32 inputs.
CARD_CASES = (
    [(1, 2, 256, 256, d, None, "bhnd") for d in (24, 40, 64, 72, 96, 112, 160, 176, 256)]
    + [(1, 8, 1024, 1024, 80, None, "bhnd"), (1, 2, 300, 333, 40, 301, "bhnd"),
       (2, 2, 256, 640, 40, 513, "heads"), (1, 2, 128, 77, 40, None, "bhnd"),
       (1, 2, 200, 200, 36, None, "bhnd"), (2, 8, 256, 256, 40, None, "heads"),
       (1, 4, 256, 256, 160, None, "heads"), (1, 2, 256, 256, 40, None, "fp32")])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_version_on_card():
    """Forward, dQ and dK/dV kernels against the plain version at
    ``CARD_CASES``. O, dQ, dK and dV: tolerance 2% of each tensor's own
    largest reference value (the plain version rounds P and dS to bf16 as
    the kernels do; what is left is bf16 output rounding and the summation
    order). LSE: 1e-3 absolute (fp32 from exact bf16 products). The backward
    reference takes the plain forward's O and LSE. Operands are copied for
    TMA only where the head dim is not a multiple of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda "
                    "tests/test_torch_flash_attention.py` on the GPU machine")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, nq, nk, d, kv_len, layout in CARD_CASES:
        def make(n):
            if layout == "heads":
                x = torch.randn(b, n, h * d, generator=gen, device="cuda").bfloat16()
                return x.view(b, n, h, d).transpose(1, 2)
            x = torch.randn(b, h, n, d, generator=gen, device="cuda")
            return x if layout == "fp32" else x.bfloat16()

        q, k, v, do = make(nq), make(nk), make(nk), make(nq)
        tfa.reset_launch_counts()
        o, lse = tfa.flash_forward(q, k, v, d ** -0.5, kv_len)
        got = tfa.flash_backward(q, k, v, o, lse, do, d ** -0.5, kv_len)
        # fp32 inputs are rounded to bf16 by the wrapper: the reference sees
        # the same rounded values, in fp32
        q, k, v, do = (x.bfloat16().to(x.dtype) for x in (q, k, v, do))
        o_ref, lse_ref = tfa.flash_forward_plain(q, k, v, d ** -0.5, kv_len)
        want = tfa.flash_backward_plain(q, k, v, o_ref, lse_ref, do, d ** -0.5, kv_len)
        torch.cuda.synchronize()
        case = (b, h, nq, nk, d, kv_len, layout)
        assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}, case
        # every operand: q, k, v forward; q, k, v, dO backward (and the
        # forward's O, which the dQ kernel reads for delta)
        copied = d % 8 != 0
        assert tfa.TMA_COPIES == {"flash_fwd": 3 * copied, "flash_bwd_dq": copied,
                                  "flash_bwd_dkv": 4 * copied}, case
        assert (lse - lse_ref).abs().max().item() <= 1e-3, case
        for name, a, r in zip(("O", "dQ", "dK", "dV"), (o,) + tuple(got), (o_ref,) + tuple(want)):
            assert a.dtype == q.dtype and a.shape == r.shape, (case, name)
            err = (a.float() - r.float()).abs().max().item()
            assert err <= 2e-2 * r.float().abs().max().item(), (case, name, err)
        if kv_len is not None:
            assert got[1][:, :, kv_len:].abs().max().item() == 0.0, case
            assert got[2][:, :, kv_len:].abs().max().item() == 0.0, case


@pytest.mark.cuda
def test_cuda_dq_block_shapes_and_delta_match_plain_version_on_card():
    """The dQ kernel in each block shape (variant 1: 128-query blocks; 2:
    64-query blocks taking alternate key tiles; head dims above 160 have
    one shape) at ``CARD_CASES``, against the plain dQ (2% of its largest
    value, as above) and its delta against the plain rowsum(dO * O) (fp32
    sums of exact bf16 products in another order: 1e-4 of the largest
    |delta|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda "
                    "tests/test_torch_flash_attention.py` on the GPU machine")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, h, nq, nk, d, kv_len, layout in CARD_CASES:
        q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device="cuda").bfloat16()
                       for n in (nq, nk, nk, nq))
        o, lse = tfa.flash_forward_plain(q, k, v, d ** -0.5, kv_len)
        want = tfa.flash_backward_plain(q, k, v, o, lse, do, d ** -0.5, kv_len)[0]
        want_delta = tfa.flash_delta_plain(o, do)
        for variant in (0, 1, 2):
            dq, delta = tfa.flash_backward_dq(q, k, v, o, lse, do, d ** -0.5, kv_len, variant)
            torch.cuda.synchronize()
            case = (b, h, nq, nk, d, kv_len, layout, variant)
            err = (dq.float() - want.float()).abs().max().item()
            assert err <= 2e-2 * want.float().abs().max().item(), (case, err)
            err = (delta - want_delta).abs().max().item()
            assert err <= 1e-4 * want_delta.abs().max().item(), (case, err)
