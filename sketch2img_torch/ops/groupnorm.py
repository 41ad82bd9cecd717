"""Fused GroupNorm (+ SiLU) on Hopper: a hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``sketch2img_tpu/ops/groupnorm.py`` (the Pallas
``fused_groupnorm_silu``), in NCHW: ``csrc/groupnorm_silu.cu`` computes
GroupNorm with fp32 statistics, the affine, an optional SiLU in fp32 and
one cast back to the input dtype. Its source says what bounds it and how
the split reduction fills the card.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (two passes, counted as one launch in ``LAUNCHES``), and any failure
to build or launch raises. The kernel takes contiguous NCHW in bf16 or fp32
only. The backward, as in the JAX package (``_fused_bwd``), is no kernel:
``GroupNormSiLU`` saves (x, weight, bias) and differentiates the plain
version, recomputed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

LAUNCHES = {"groupnorm_silu": 0}
SOURCES = ("groupnorm_silu.cu",)

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_TARGET_BLOCKS = 4 * 132  # four blocks per SM of an H100 SXM
_MIN_CHUNK = 2048         # elements per block: 256 threads x one 8-wide vector
_MAX_SPLIT = 256
_lib = None


def reset_launch_counts() -> None:
    LAUNCHES["groupnorm_silu"] = 0


def load_library(verbose: bool = False):
    """Build (first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        from sketch2img_torch.utils.cuda_build import build_library

        lib = ctypes.CDLL(build_library("groupnorm", SOURCES, verbose=verbose))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.groupnorm_silu.argtypes = ([i32] + [ptr] * 6 + [i32] * 5
                                       + [ctypes.c_longlong, f32, i32, i32, i32])
        lib.groupnorm_silu.restype = i32
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=512)
def split_plan(b: int, c: int, hw: int, num_groups: int) -> Tuple[int, int]:
    """-> (S, chunk): each of the B*G groups (cg*H*W contiguous elements) is
    cut into S chunks of ``chunk`` elements (a multiple of 8), S chosen so the
    grid holds about four blocks per SM with at least 2048 elements a block."""
    n = (c // num_groups) * hw
    want = -(-_TARGET_BLOCKS // (b * num_groups))
    s = max(1, min(want, -(-n // _MIN_CHUNK), _MAX_SPLIT))
    chunk = -(-n // s)
    chunk = -(-chunk // 8) * 8
    return -(-n // chunk), chunk


def group_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm with its affine in fp32, optional SiLU in fp32, then one
    cast to x's dtype. Built on fp32 ``F.group_norm`` so that the backward
    (which differentiates this, recomputed) takes PyTorch's fused GroupNorm
    backward rather than a dozen elementwise ones.

    Under bf16 this rounds once, after SiLU; a GroupNorm followed by a
    separate ``F.silu`` rounds before SiLU as well, so the two differ by up
    to one bf16 rounding of the output."""
    y = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return (F.silu(y) if silu else y).to(x.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                num_groups: int) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"the GroupNorm kernel takes contiguous NCHW tensors, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the GroupNorm kernel takes bf16 or fp32, got {x.dtype}")
    c = x.shape[1]
    if c % num_groups != 0:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    for p in (weight, bias):
        if (p.shape != (c,) or p.dtype not in _DTYPE_CODES or p.device != x.device
                or not p.is_contiguous() or p.dtype != weight.dtype):
            raise ValueError("weight and bias must be contiguous (C,) bf16 or fp32 tensors "
                             "of one dtype on x's device")
    if x.device.type != "cuda":
        raise ValueError(f"the GroupNorm kernel runs on CUDA tensors, got {x.device}")


def group_norm_silu_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """Launch the CUDA kernel (both passes) on the current stream."""
    _check(x, weight, bias, num_groups)
    b, c, h, w = x.shape
    s, chunk = split_plan(b, c, h * w, num_groups)
    y = torch.empty_like(x)
    partials = torch.empty(b * num_groups * s, 2, dtype=torch.float32, device=x.device)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.groupnorm_silu(x.device.index, stream, x.data_ptr(), weight.data_ptr(),
                             bias.data_ptr(), y.data_ptr(), partials.data_ptr(),
                             b, c, h * w, num_groups, s, chunk, float(eps), int(silu),
                             _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype])
    if err != 0:
        raise RuntimeError(f"groupnorm_silu kernel failed to launch: CUDA error {err}")
    LAUNCHES["groupnorm_silu"] += 1
    return y


def _forward(x, weight, bias, num_groups, eps, silu):
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, num_groups, eps, silu)
    return group_norm_silu_kernel(x, weight, bias, num_groups, eps, silu)


class GroupNormSiLU(torch.autograd.Function):
    """Forward through ``_forward``; backward by recomputing the plain
    version and differentiating it (the JAX package's ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, silu)
        return _forward(x, weight, bias, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            y = group_norm_silu_plain(*ins, *ctx.args)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(y, wrt, grad)) if wrt else iter(())
        return tuple(next(grads) if n else None for n in need) + (None, None, None)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5, silu: bool = True
                    ) -> torch.Tensor:
    """GroupNorm + affine (+ SiLU) on NCHW input, output in x's dtype.
    Through ``GroupNormSiLU`` where a gradient is wanted, else straight to
    the forward (no autograd bookkeeping on the no-grad passes)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormSiLU.apply(x, weight, bias, num_groups, eps, silu)
    return _forward(x, weight, bias, num_groups, eps, silu)
