"""Fused GroupNorm (+ SiLU) on Hopper: a hand-written CUDA kernel, in two
variants, and its plain PyTorch version.

Counterpart of ``sketch2img_tpu/ops/groupnorm.py`` (the Pallas
``fused_groupnorm_silu``), in NCHW: ``csrc/groupnorm_silu.cu`` computes
GroupNorm with fp32 statistics, the affine, an optional SiLU in fp32 and
one cast back to the input dtype. Its source says what bounds it and how
each variant works:

  * ``groupnorm_silu`` (one pass, the rule): one launch; each group goes to
    a cluster of 1-16 blocks that hold it in shared memory, so x is read
    once;
  * ``groupnorm_silu_split`` (two passes): for a group larger than 16
    blocks of 96 KB, statistics by a split reduction into a scratch tensor,
    then a second read of x.

``launch_plan`` picks the variant and its launch parameters from the shape
and dtype alone; the wrapper caches one plan per (shape, dtype, groups,
eps, silu, device), holding the shape checks' result and the C struct the
kernel takes, so that a call runs the checks that depend on the tensors
themselves and one ctypes call.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and any failure to build or launch raises. The kernel takes
contiguous NCHW in bf16 or fp32 only. ``LAUNCHES`` counts calls by variant
(a split call's two passes count once). The backward, as in the JAX
package (``_fused_bwd``), is no kernel: ``GroupNormSiLU`` saves (x,
weight, bias) and differentiates the plain version, recomputed.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sketch2img_torch.utils.device import current_stream_handle

ONE_PASS, SPLIT = "groupnorm_silu", "groupnorm_silu_split"
LAUNCHES = {ONE_PASS: 0, SPLIT: 0}
SOURCES = ("groupnorm_silu.cu",)
HEADERS = ("hopper_common.cuh", "wgmma_ops.cuh")

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_SMS = 132                # SMs of an H100 SXM
MAX_CLUSTER = 16          # blocks a group (above 8: the card's non-portable sizes)
_MAX_SLICE = 200 * 1024   # shared memory a one-pass block may hold (csrc kMaxSlice)
_PREF_SLICE = 96 * 1024   # a slice that leaves room for two blocks on an SM
_ALONE = 20 * 1024        # a group this small takes one block
_MIN_SLICE = 10 * 1024    # groups are not cut below this for parallelism
# split variant: about four blocks per SM, at least 2048 elements a block
_TARGET_BLOCKS = 4 * _SMS
_MIN_CHUNK = 2048
_MAX_SPLIT = 256
_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _PlanStruct(ctypes.Structure):
    """The kernel's ``gn::Plan`` (csrc/groupnorm_silu.cu), field for field."""
    _fields_ = ([(name, ctypes.c_int) for name in ("device", "B", "C", "HW", "G", "variant",
                                                   "cluster", "S")]
                + [("chunk", ctypes.c_longlong), ("smem", ctypes.c_int),
                   ("threads", ctypes.c_int), ("eps", ctypes.c_float)]
                + [(name, ctypes.c_int) for name in ("silu", "dtype", "pdtype")])


#: the C entry points' parameters; each returns an int (a CUDA error, or a count)
ARGTYPES = {
    # plan, stream, x, gamma, beta, y, split partials
    "groupnorm_silu": [ctypes.POINTER(_PlanStruct)] + [ctypes.c_void_p] * 6,
    "groupnorm_max_active_clusters": [ctypes.c_int] * 3,  # device, cluster, smem
}


def load_library(verbose: bool = False):
    """Build (first use) and load the kernel's shared library. Threads that
    reach a first use together build it once: the rest wait for it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from sketch2img_torch.utils.cuda_build import load_ctypes_library

                _lib = load_ctypes_library("groupnorm", SOURCES, HEADERS, ARGTYPES,
                                           verbose=verbose)
    return _lib


class LaunchPlan(NamedTuple):
    kernel: str    # ONE_PASS or SPLIT
    cluster: int   # one pass: blocks a group (1 for split)
    chunk: int     # elements a block
    splits: int    # split: blocks a group (1 for one pass)
    smem: int      # one pass: dynamic shared memory a block (0 for split)
    threads: int   # one pass: threads a block (256 for split)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, c: int, hw: int, num_groups: int, elem_bytes: int,
                kernel: Optional[str] = None) -> LaunchPlan:
    """The variant and launch parameters for a (B, C, H*W) input with
    ``elem_bytes``-byte elements, from the shape and dtype alone.

    One pass wherever a group of L = (C/G) * H * W elements fits 16 blocks
    of at most 96 KB each (two blocks an SM): a group of up to 20 KB takes
    one block; a larger one the smallest power-of-two cluster that keeps
    slices at <= 96 KB, or more blocks, down to slices of 10 KB, until the
    B*G groups give about two blocks an SM. Blocks of 512 threads where a
    block holds 4096 16-byte vectors or the grid has at most one block for
    two SMs, 256 where it holds at least 512, else 128. Larger groups take
    the split variant. (The rule and its constants follow a sweep of cluster
    and block sizes at the paths' shapes on the H100; a one-pass block of
    128 KB or more, one an SM, measured slower than the split variant.)
    ``kernel`` forces a variant (the tests and the on-card checks use it):
    one pass on a group of up to 16 x 200 KB, in 200 KB slices if need be;
    forcing it on a larger group raises."""
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    n = (c // num_groups) * hw
    nbytes = n * elem_bytes
    if kernel in (None, ONE_PASS):
        cluster = 1
        if nbytes > _ALONE:
            fill = _pow2_at_least(-(-2 * _SMS // (b * num_groups)))
            cluster = max(_pow2_at_least(-(-nbytes // _PREF_SLICE)),
                          min(fill, _pow2_at_least(-(-nbytes // _MIN_SLICE))))
        if cluster > MAX_CLUSTER and kernel == ONE_PASS:
            cluster = _pow2_at_least(-(-nbytes // (_MAX_SLICE - 16)))
        if cluster <= MAX_CLUSTER:
            chunk = -(-n // cluster)
            chunk = -(-chunk // 8) * 8
            vectors = chunk * elem_bytes // 16
            blocks = b * num_groups * cluster
            threads = (512 if vectors >= 4096 or blocks <= _SMS // 2 else
                       256 if vectors >= 512 else 128)
            return LaunchPlan(ONE_PASS, cluster, chunk, 1, chunk * elem_bytes, threads)
        if kernel == ONE_PASS:
            raise ValueError(f"a group of {nbytes} bytes does not fit {MAX_CLUSTER} blocks' "
                             "shared memory; the split variant takes it")
    elif kernel != SPLIT:
        raise ValueError(f"unknown GroupNorm kernel {kernel!r}")
    s, chunk = split_plan(b, c, hw, num_groups)
    return LaunchPlan(SPLIT, 1, chunk, s, 0, 256)


@functools.lru_cache(maxsize=512)
def split_plan(b: int, c: int, hw: int, num_groups: int) -> Tuple[int, int]:
    """-> (S, chunk) of the split variant: each of the B*G groups (cg*H*W
    contiguous elements) is cut into S chunks of ``chunk`` elements (a
    multiple of 8), S chosen so the grid holds about four blocks per SM with
    at least 2048 elements a block."""
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


class _Call(NamedTuple):
    plan: LaunchPlan
    struct: _PlanStruct
    pdtype: torch.dtype


@functools.lru_cache(maxsize=1024)
def _call_plan(shape: Tuple[int, ...], dtype: torch.dtype, pdtype: torch.dtype,
               num_groups: int, eps: float, silu: bool, device: int,
               kernel: Optional[str]) -> _Call:
    """The checks that depend on the shape and dtypes alone, and the launch
    plan with its C struct, once per key."""
    if len(shape) != 4:
        raise ValueError(f"the GroupNorm kernel takes NCHW tensors, got shape {shape}")
    if dtype not in _DTYPE_CODES or pdtype not in _DTYPE_CODES:
        raise ValueError(f"the GroupNorm kernel takes bf16 or fp32, got {dtype} and {pdtype}")
    b, c, h, w = shape
    plan = launch_plan(b, c, h * w, num_groups, dtype.itemsize, kernel)
    struct = _PlanStruct(device, b, c, h * w, num_groups, int(plan.kernel == SPLIT),
                         plan.cluster, plan.splits, plan.chunk, plan.smem, plan.threads,
                         float(eps), int(silu), _DTYPE_CODES[dtype], _DTYPE_CODES[pdtype])
    return _Call(plan, struct, pdtype)


def group_norm_silu_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float, silu: bool,
                           kernel: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, in the variant
    ``launch_plan`` picks (or ``kernel``)."""
    call = _call_plan(tuple(x.shape), x.dtype, weight.dtype, num_groups, eps, silu,
                      -1 if x.device.index is None else x.device.index, kernel)
    c = x.shape[1]
    if not x.is_contiguous():
        raise ValueError(f"the GroupNorm kernel takes contiguous NCHW tensors, got strides "
                         f"{x.stride()}")
    for p in (weight, bias):
        if (p.dtype != call.pdtype or p.device != x.device or p.shape != (c,)
                or not p.is_contiguous()):
            raise ValueError("weight and bias must be contiguous (C,) bf16 or fp32 tensors "
                             "of one dtype on x's device")
    if x.device.type != "cuda":
        raise ValueError(f"the GroupNorm kernel runs on CUDA tensors, got {x.device}")
    y = torch.empty_like(x)
    plan = call.plan
    scratch = None  # the split variant's partial sums
    if plan.kernel == SPLIT:
        scratch = torch.empty(x.shape[0] * num_groups * plan.splits, 2, dtype=torch.float32,
                              device=x.device)
    lib = _lib or load_library()
    err = lib.groupnorm_silu(call.struct, current_stream_handle(x.device), x.data_ptr(),
                             weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                             None if scratch is None else scratch.data_ptr())
    if err != 0:
        raise RuntimeError(f"{plan.kernel} kernel failed to launch: CUDA error {err}")
    LAUNCHES[plan.kernel] += 1
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
