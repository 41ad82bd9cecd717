"""Flash attention on Hopper: three hand-written CUDA kernels and their
plain PyTorch versions.

Counterpart of ``sketch2img_tpu/ops/flash_attention.py``. The JAX package
has six Pallas kernels (forward, backward dQ, backward dK/dV, each in a
row-major and a d-major layout for the TPU's 128-wide matrix unit); here
one kernel per direction covers every head dim up to 256:

  * ``csrc/flash_fwd.cu``      O = softmax(scale QK^T) V and the row LSE
                               (TMA + wgmma, warp-specialised)
  * ``csrc/flash_bwd_dq.cu``   dQ, recomputing P from the LSE, and
                               delta = rowsum(dO O) for the dK/dV pass
                               (TMA + wgmma, warp-specialised)
  * ``csrc/flash_bwd_dkv.cu``  dK and dV, recomputing P from the LSE
                               (TMA + wgmma, warp-specialised)

All three mask keys at index >= ``kv_len`` exactly (-1e30 logits), take
bf16 tensors of shape (B, H, N, d) with a unit stride on d, and keep
softmax statistics and accumulators in fp32. Each source file states what
bounds it and how it is laid out.

TMA reads every operand straight from its strided view (the model's
heads-views of (B, N, H*d) projections included) when the base is 16-byte
aligned and every stride is a multiple of 16 bytes;
``prepare_operand`` copies an operand that misses that into a buffer with
a padded row pitch and counts the copy in ``TMA_COPIES`` (0 on both
paths). fp32 inputs on the card are cast to bf16 by the wrapper (the
kernels compute in bf16 either way) and the outputs cast back to fp32.

Dispatch: a CPU tensor takes the plain version (the CPU tests); a CUDA
tensor launches the kernel, and any failure to build or launch raises.
``LAUNCHES`` counts kernel launches per kernel, ``FWD_VARIANTS`` the
forward's by tile: ``forward_variant`` picks the tile from the call's shape
and the card's SM count (``csrc/flash_fwd.cu`` states the rule's
measurements).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from sketch2img_torch.utils.device import current_stream_handle

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
#: the forward's tiles, by the ``variant`` code its C entry point takes:
#: 128 queries a block on two consumer warpgroups (every head dim), 192 on
#: three (head dims up to WIDE_MAX_HEAD_DIM)
FWD_TILES = ("bm128", "bm192")
#: forward launches by tile
FWD_VARIANTS = dict.fromkeys(FWD_TILES, 0)
WIDE_MAX_HEAD_DIM = 64
WIDE_ROWS = 192
#: the 192-query tile where its grid fills the card at least this many times
WIDE_MIN_WAVES = 1.5
#: operands the wrapper had to copy before TMA would take them, by kernel
TMA_COPIES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu")
HEADERS = ("flash_common.cuh", "hopper_common.cuh", "wgmma_ops.cuh")
MAX_HEAD_DIM = 256

_NEG_INF = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_lib = None
_lib_lock = threading.Lock()

_ptr, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_VIEW = [_ptr, _i64, _i64, _i64]  # a tensor's base and its B, H, N strides
_DIMS = [_i32] * 6 + [_f32, _i32]  # B, H, nq, nk, d, kv_len, scale, dtype
#: the C entry points' parameters (device, stream, ...); each returns a CUDA error
ARGTYPES = {
    "flash_fwd": [_i32, _ptr] + _VIEW * 4 + [_ptr] + _DIMS + [_i32],
    "flash_bwd_dq": [_i32, _ptr] + _VIEW * 5 + [_ptr, _ptr] + _VIEW + _DIMS + [_i32],
    "flash_bwd_dkv": [_i32, _ptr] + _VIEW * 4 + [_ptr, _ptr] + _VIEW * 2 + _DIMS,
}


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES``, ``FWD_VARIANTS`` and ``TMA_COPIES``."""
    for counts in (LAUNCHES, FWD_VARIANTS, TMA_COPIES):
        for name in counts:
            counts[name] = 0


def load_library(verbose: bool = False):
    """Build (first use) and load the kernels' shared library. Threads that
    reach a first use together build it once: the rest wait for it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from sketch2img_torch.utils.cuda_build import load_ctypes_library

                _lib = load_ctypes_library("flash_attention", SOURCES, HEADERS, ARGTYPES,
                                           verbose=verbose)
    return _lib


# ---------------------------------------------------------------------------
# shape gates (sketch2img_tpu/ops/flash_attention.py:74-100, minus the backend)
# ---------------------------------------------------------------------------


def supported(q, k, v, mask) -> bool:
    """Can the kernels take these (B, H, N, d) shapes: no additive mask,
    d <= 256, at least 128 queries."""
    if mask is not None:
        return False
    nq, d = q.shape[2], q.shape[3]
    return d <= MAX_HEAD_DIM and nq >= 128 and k.shape[2] >= 1


def preferred(q, k, v, mask) -> bool:
    """The sites the model routes through the kernels: ``supported`` and at
    least 128 keys (the UNet self-attentions at 64^2, 32^2 and 16^2)."""
    return supported(q, k, v, mask) and k.shape[2] >= 128


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _logits(q, k, scale, kv_len):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        s[..., kv_len:] = _NEG_INF
    return s


def flash_forward_plain(q, k, v, scale: float, kv_len: Optional[int] = None):
    """-> (O in q's dtype, natural-log LSE in fp32 of shape (B, H, nq)).
    P is rounded to v's dtype before the PV product, as in the kernels."""
    s = _logits(q, k, scale, kv_len)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse


def flash_delta_plain(o, do):
    """delta = rowsum(dO * O) in fp32, (B, H, nq): what the dQ kernel
    computes and hands to the dK/dV kernel."""
    return (do.float() * o.float()).sum(-1)


def flash_backward_plain(q, k, v, o, lse, do, scale: float,
                         kv_len: Optional[int] = None):
    """-> (dQ, dK, dV), recomputing P from ``lse``; P and dS are rounded to
    the input dtype before their products, as in the kernels."""
    dt = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp(_logits(q, k, scale, kv_len) - lse[..., None])
    delta = flash_delta_plain(o, do)[..., None]
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def tma_accepts(x: torch.Tensor) -> bool:
    """Can TMA read this bf16 (B, H, N, d) tensor in place: unit stride on
    d, 16-byte aligned base, and every stride of a dim longer than 1 a
    nonzero multiple of 16 bytes (8 elements)."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        return False
    (b, h, n, d), (sb, sh, sn, sd) = x.shape, x.stride()
    return ((sd == 1 or d == 1) and x.data_ptr() % 16 == 0
            and (b == 1 or (sb > 0 and sb % 8 == 0))
            and (h == 1 or (sh > 0 and sh % 8 == 0))
            and (n == 1 or (sn > 0 and sn % 8 == 0)))


def prepare_operand(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """-> (bf16 tensor TMA can read, whether it had to be copied). fp32 is
    cast to bf16 first (an explicit rounding the kernels would do anyway);
    a tensor TMA refuses is copied into a (B, H, N, ceil8(d)) buffer and
    viewed back to d columns, so its row pitch is a multiple of 16 bytes."""
    if x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    if tma_accepts(x):
        return x, False
    b, h, n, d = x.shape
    pitch = -(-d // 8) * 8
    y = torch.empty(b, h, n, pitch, dtype=torch.bfloat16, device=x.device)[..., :d]
    return y.copy_(x), True


def _prepare(kernel: str, *xs: torch.Tensor):
    """``prepare_operand`` on each of ``xs``, counting copies under ``kernel``
    (the common case, a tensor TMA takes as it is, costs one check)."""
    out = []
    for x in xs:
        if not tma_accepts(x):
            x, copied = prepare_operand(x)
            TMA_COPIES[kernel] += int(copied)
        out.append(x)
    return out


def _view(x: torch.Tensor):
    return [x.data_ptr(), *x.stride()[:3]]


def _heads_merged(b: int, h: int, n: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) view of (B, N, H, d) memory: merging the heads back to
    (B, N, H*d) afterwards is free."""
    return torch.empty(b, n, h, d, dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def _check_cuda(scale: float, *xs: torch.Tensor) -> None:
    x0 = xs[0]
    if x0.device.type != "cuda":
        raise ValueError(f"flash kernels take CPU or CUDA tensors, got {x0.device}")
    if x0.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernels take bf16 or fp32, got {x0.dtype}")
    for x in xs:
        if x.device != x0.device or x.dtype != x0.dtype or x.dim() != 4:
            raise ValueError("q, k, v (and o, dO) must be 4-d tensors of one dtype on one device")
    if x0.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {x0.shape[3]} > {MAX_HEAD_DIM}")
    if not scale > 0:
        raise ValueError(f"the flash kernels take a positive scale, got {scale}")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error {err}")
    LAUNCHES[name] += 1


def _kv_len(nk: int, kv_len: Optional[int]) -> int:
    if kv_len is not None and kv_len < 1:
        raise ValueError(f"kv_len must be at least 1, got {kv_len}")
    return nk if kv_len is None else min(int(kv_len), nk)


def forward_variant(b: int, h: int, nq: int, kv: int, d: int, sms: int) -> int:
    """The forward's tile for a (b, h, nq, d) call over ``kv`` keys on a
    card of ``sms`` SMs (an index into ``FWD_TILES``): 192 queries a block on
    three consumer warpgroups where d <= 64, that grid fills the card
    WIDE_MIN_WAVES times or more, and its 192-key tiles are fewer than the
    128-key ones (kv <= 128 or 193-256 would only add masked keys); else
    128 queries on two."""
    blocks = b * h * -(-nq // WIDE_ROWS)
    return int(d <= WIDE_MAX_HEAD_DIM and blocks >= WIDE_MIN_WAVES * sms
               and -(-kv // WIDE_ROWS) < -(-kv // 128))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_forward(q, k, v, scale: float, kv_len: Optional[int] = None,
                  variant: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, nq, d) x (B, H, nk, d) -> (O, LSE). Keys >= kv_len masked.
    ``variant`` forces a tile of ``FWD_TILES`` (above 0: d <= 64 only);
    None takes ``forward_variant``'s."""
    if variant not in (None, 0, 1) or (variant == 1 and q.shape[3] > WIDE_MAX_HEAD_DIM):
        raise ValueError(f"no forward tile {variant!r} at head dim {q.shape[3]}")
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, scale, kv_len)
    _check_cuda(scale, q, k, v)
    dtype = q.dtype
    q, k, v = _prepare("flash_fwd", q, k, v)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    kvl = _kv_len(nk, kv_len)
    if variant is None:
        variant = forward_variant(b, h, nq, kvl, d, _sm_count(q.device.index))
    o = _heads_merged(b, h, nq, d, q)
    lse = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    lib = load_library()
    stream = current_stream_handle(q.device)
    _launch("flash_fwd", lib.flash_fwd, q.device.index, stream,
            *_view(q), *_view(k), *_view(v), *_view(o), lse.data_ptr(),
            b, h, nq, nk, d, kvl, float(scale), _DTYPE_CODES[torch.bfloat16], variant)
    FWD_VARIANTS[FWD_TILES[variant]] += 1
    return (o if dtype == torch.bfloat16 else o.to(dtype)), lse


def backward_operands(q, k, v, o, do):
    """-> (q, k, v, dO, O) as the backward kernels read them: bf16 that TMA
    takes in place (``_prepare``). q, k, v and dO feed both kernels and count
    their copies under dK/dV; O feeds the dQ kernel alone (for delta)."""
    q, k, v, do = _prepare("flash_bwd_dkv", q, k, v, do)
    (o,) = _prepare("flash_bwd_dq", o)
    return q, k, v, do, o


def _backward_call(q, k, v, o, lse, do, scale, kv_len):
    """Checked and prepared operands of a backward call (the caller keeps
    them alive until its launches are enqueued: a copy freed earlier could
    be handed to an output), and the launch arguments both kernels share."""
    _check_cuda(scale, q, k, v, do)
    ops = backward_operands(q, k, v, o, do)
    q, k, v, do, _ = ops
    b, h, nq, d = q.shape
    nk = k.shape[2]
    lse = lse.float().contiguous()
    shared = (q.device.index, current_stream_handle(q.device),
              *_view(q), *_view(k), *_view(v), *_view(do))
    tail = (b, h, nq, nk, d, _kv_len(nk, kv_len), float(scale), _DTYPE_CODES[torch.bfloat16])
    return ops, lse, shared, tail


def _dq_launch(ops, lse, shared, tail, variant: int):
    q, o = ops[0], ops[4]
    b, h, nq, d = q.shape
    delta = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    dq = _heads_merged(b, h, nq, d, q)
    _launch("flash_bwd_dq", load_library().flash_bwd_dq, *shared, *_view(o), lse.data_ptr(),
            delta.data_ptr(), *_view(dq), *tail, variant)
    return dq, delta


def flash_backward_dq(q, k, v, o, lse, do, scale: float, kv_len: Optional[int] = None,
                      variant: int = 0):
    """-> (dQ in q's dtype, delta in fp32 (B, H, nq)) from the dQ kernel
    alone. ``variant`` picks its block shape: 0 as ``flash_backward`` does
    (64-query blocks where 128-query ones leave SMs idle), 1: 128-query
    blocks, 2: 64-query blocks (head dims above 160 have one shape)."""
    if q.device.type == "cpu":
        dq = flash_backward_plain(q, k, v, o, lse, do, scale, kv_len)[0]
        return dq, flash_delta_plain(o, do)
    dtype = q.dtype
    ops, lse, shared, tail = _backward_call(q, k, v, o, lse, do, scale, kv_len)
    dq, delta = _dq_launch(ops, lse, shared, tail, variant)
    return dq.to(dtype), delta


def flash_backward(q, k, v, o, lse, do, scale: float, kv_len: Optional[int] = None):
    """-> (dQ, dK, dV). The dQ kernel computes delta = rowsum(dO * O) (the
    JAX package computes it outside its kernels) and writes it for the
    dK/dV kernel, which follows on the same stream."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, scale, kv_len)
    dtype = q.dtype
    ops, lse, shared, tail = _backward_call(q, k, v, o, lse, do, scale, kv_len)
    dq, delta = _dq_launch(ops, lse, shared, tail, 0)
    b, h, _, d = ops[0].shape
    nk = tail[3]
    dk = _heads_merged(b, h, nk, d, ops[0])
    dv = _heads_merged(b, h, nk, d, ops[0])
    _launch("flash_bwd_dkv", load_library().flash_bwd_dkv, *shared, lse.data_ptr(),
            delta.data_ptr(), *_view(dk), *_view(dv), *tail)
    if dtype != torch.bfloat16:
        dq, dk, dv = dq.to(dtype), dk.to(dtype), dv.to(dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernels' backward (the JAX package's
    ``_flash`` custom_vjp). Saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        o, lse = flash_forward(q, k, v, scale, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kv_len = scale, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.scale, ctx.kv_len)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale: float, mask=None, kv_len: Optional[int] = None):
    """q, k, v: (B, H, N, d) -> (B, H, nq, d). ``kv_len``: true key count
    when k/v carry a padded tail (keys >= kv_len are masked exactly)."""
    if mask is not None:
        raise ValueError("flash attention takes no additive mask; use the plain path")
    return FlashAttention.apply(q, k, v, scale, kv_len)
