#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sketch2img_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as on a fresh checkout
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,profile

Phases, each printing its own lines:

  1. build    compile the CUDA sources in csrc/ (flash attention and the
              fused GroupNorm+SiLU: one nvcc process per source, all started
              together) and load them;
  2. kernels  hold each kernel against its plain PyTorch version in bf16 at
              every shape the two paths give it (and against itself: each
              output launched twice on the same inputs must come out bit-
              identical: O and the LSE, dQ and delta, dK/dV, GroupNorm in
              both variants) and time the kernel, the
              plain version and one PyTorch call as a yardstick (the port
              never calls it): flash forward, backward dQ (with the delta =
              rowsum(dO O) it writes for dK/dV, against the plain delta, and
              each of its two block shapes at the guided shapes) and dK/dV
              at the sketch-guided shapes (q/k/v as the model passes them:
              heads views of (B, N, H*d) projections) plus a ragged and a
              kv_len case, one shape of every head-dim bucket, a head dim
              TMA cannot take in place, the flash forward at the injection
              path's shapes (batch 16 self- and concat attention, the ViT's
              257 tokens); at every flash case with d <= 64 each forward
              tile (128 queries on two consumer warpgroups, 192 on three)
              forced, held to the plain version, launched twice and timed
              beside the library and the tile the rule picks; and both
              variants of the GroupNorm kernel (one
              pass on clusters where a group fits 16 blocks' shared memory,
              and the split two-pass one) at every (B, C, H, W, eps, silu)
              recorded from one pass of each model on both paths, on real
              activations and in fp32 across the variants' boundary. Times:
              "ms" back-to-back calls between CUDA events (host work
              included), "device_ms" the replay of CUDA graphs of the same
              calls (device time alone; for SDPA's backward, its kernels'
              durations from torch.profiler); the host time a call of the
              flash forward and backward at (1, 8, 256, 160) and of the
              GroupNorm wrapper at (1, 1280, 8, 8) is logged, and whether the
              card schedules 16-block clusters. ("--phases build,flash" runs
              the flash part alone);
  3. e2e      full-width SD1.5 (seeded random weights): the kernels against
              the plain attention path, then against the plain GroupNorm
              path, inside one guided UNet pass, and that pass twice on the
              same inputs through each route (eps and gradient bit-identical:
              the package makes cuDNN deterministic on the card; PyTorch's
              warn-only deterministic mode lists any op left without a
              deterministic implementation); then a 512x512, 50-step
              sketch-guided request through ``SketchGuidedPipeline`` (after a
              4-step warm-up), launch counters zeroed just before and read
              just after (the flash forward's by tile against the rule on
              the calls it made), and again: the same image bit for bit; the same
              request with the DDIM solver at 10 steps and as text-to-image
              (no sketch), each twice, bit-identical;
  4. inject   the attention-injection path: ``ClipGuidedPipeline`` with the
              clip-injected UNet, the ViT-L/14 sketch encoder and a safety
              checker (seeded random weights, bf16), one 512x512 request at
              batch 8, 25 DPM-Solver++ steps, guidance 7.5, strength 0.5, one
              sketch, launch counters zeroed just before and read just after
              (by tile, as in e2e); run again, bit-identical;
  5. train_lgp     the LGP trainer (``apps/train_lgp.train_lgp``) on the
              full-width stack plus a full-width anime2sketch generator:
              batch 4 at 512^2 from a seeded folder of synthetic PNG images
              with captions, sketches made at 1024^2, uncached, AdamW, four
              steps (one warm-up, three counted), launch counters zeroed just
              before the call and read just after; finite losses, every LGP
              tensor moved, every frozen one bit-identical, the launch counts
              one step implies, a checkpoint save/restore round trip; then
              one step from the same fresh state and draws twice (AdamW):
              trainables and optimizer state bit-identical, with PyTorch's
              warn-only deterministic mode listing any op of the step that
              has no deterministic implementation;
  6. train_inject  the injection trainer (``apps/train_attn_inject``):
              fresh injection blocks and a ViT-L/14 trained (fp32 masters,
              bf16 compute) through the frozen UNet, sketches at 512^2, four
              steps as above and the same checks, then one step's gradient
              through the kernels against the plain attention and GroupNorm
              routes (cosine over every trainable gradient), and one step
              twice as in train_lgp;
  7. serve    the port's HTTP server (``apps/serve.make_server``) in-process
              on 127.0.0.1, around the sketch-guided pipeline and the
              injection pipeline over the same components, micro-batching
              on (batches of 2), warmed at 512^2: a 50-step sketch-guided
              PNG request in a handler thread (launch counters zeroed just
              before and read just after; timed against the direct call), a
              JSON prompt list with per-image seeds, two concurrent requests
              that merge into one batch-2 call, an SSE stream with previews,
              an inject request with strength and seed lists, a bad solver
              (400); every served image bit-identical to the direct pipeline
              call that makes the same call (the 50-step direct call run
              twice); how far a merged image is from its request run alone
              (uint8 levels) at the JAX test's setting (2 steps, 128^2,
              random sketches; its bound: at most 1 level and under 0.1% of
              pixels off), at 10 and at 50 steps; then a clean shutdown;
  8. apps     ``app.inference`` (25 steps, a uint8 sketchpad),
              ``evaluation.evaluate`` (one t=100 pass with taps) and
              ``pic2sketch`` (the full-width generator at load_size 512), at
              512^2, each timed with its launch counts and bit-identical to
              its warm-up call;
  9. remat    the UNet recomputed in the guided backward
              (``UNetConfig.remat``): one guided pass at 512^2 with remat on
              against off (eps bit-identical, the gradient within the e2e
              gate, the launch counts the recomputation implies, the peak
              memory of each), a 50-step sketch-guided request with
              ``remat=True`` (twice, bit-identical) timed against
              ``remat=False`` (bit-identical to the e2e request; its launch
              counts derived), the calibration rows of ``core/memory.py`` measured
              on this card (``measure_guided_gib``), and a few steps of a
              guided request at the smallest 512^2 batch the calibration
              flags, with ``remat=None``: remat chosen, no out-of-memory, its
              peak beside the budget;
 10. dist     ``torch.distributed`` on the card: the process group at world
              size 1 over NCCL; one step of each trainer through the
              data-parallel code against the step without a mesh, and
              ``SketchGuidedPipeline(mesh=make_mesh())`` against
              ``mesh=None`` for a short request, bit for bit (under the
              package's own setting); then tensor parallelism at m = 2 as two processes
              sharing the card over gloo: each rank's guided pass (flash at
              4 local heads) against the one-process pass;
 11. cost     what the deterministic setting costs: the 50-step
              sketch-guided request, the batch-8 injection request and one
              step of each trainer, timed with the setting in force and with
              cuDNN's flags turned back off, in three interleaved pairs
              (on, off, off, on, on, off);
 12. profile  (only when asked: --phases build,profile) device time by
              kernel over a 4-step sketch-guided request, a 5-step batch-8
              injection request and one step of each trainer, from
              torch.profiler. (``--phases build,calibrate`` measures the
              calibration cases alone.)

Then one JSON line listing the kernels, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when there is no CUDA device, when the port's package is missing, or
when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import traceback

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth (data sheet)
# H100 SXM special-function units: 16 ex2 a clock on each of 132 SMs at
# 1.83 GHz, the figure the FlashAttention-3 paper gives (~3.9e12 a second)
PEAK_EXP2 = 3.9e12
HEADS = 8
# the UNet self-attention sites (tokens, head dim), five of each per forward
MAIN_SHAPES = ((4096, 40), (1024, 80), (256, 160))
# Flash sites per batch-1 UNet pass, by token count: the forward runs all 15;
# the guided backward reaches the 12 that precede the last tap (up_2) — the
# last up block's three 64^2 sites feed only eps, which the LGP loss does not
# read, so autograd never differentiates them.
SITES = {"flash_fwd": {4096: 5, 1024: 5, 256: 5},
         "flash_bwd_dq": {4096: 2, 1024: 5, 256: 5},
         "flash_bwd_dkv": {4096: 2, 1024: 5, 256: 5}}
FWD_SITES, BWD_SITES = 15, 12
# GroupNorm calls per UNet forward (22 resnets x 2, 16 SpatialTransformer
# norms, conv_norm_out) and per VAE encode / decode
GN_UNET, GN_VAE_ENC, GN_VAE_DEC = 61, 22, 30
# the injection path: batch 8 (16 with the CFG pair); per UNet forward 15
# attn1 and 15 sketch_attn flash sites (the 8^2 mid block's two take the
# plain path); the CLIP part of sketch_attn's keys is 257 tokens padded to 384
INJ_BATCH, INJ_STEPS, INJ_FLASH_SITES, CLIP_PAD = 8, 25, 30, 384
VIT_LAYERS, VIT_HEADS, VIT_TOKENS, VIT_D = 24, 16, 257, 64
# the trainers (train.yaml): batch 4 at 512^2, four steps a phase (one
# warm-up, three counted); 225 token ids a caption, encoded in three windows
# of 77, so the text context has 231 tokens and every cross-attention at
# 64^2, 32^2 and 16^2 passes the flash gate (>= 128 keys)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CTX, TRAIN_IDS = 4, 4, 231, 225
# flash launches of one LGP step: the UNet forward's 15 attn1 and 15 attn2
# sites (the 8^2 mid block's take the plain path); no backward
LGP_FLASH_FWD = 30
# one injection step: the injected UNet adds 15 sketch_attn sites, the ViT
# 24 layers; the backward reaches every one but the first TransformerBlock's
# attn1, which runs before the first injection, on no trainable's output
INJ_TRAIN_FWD, INJ_TRAIN_BWD = 45 + VIT_LAYERS, 44 + VIT_LAYERS
# the trainers' gradient through the kernels against the plain routes
TRAIN_GRAD_COS = 0.99
# the server phase: micro-batch window, the steps of its requests other than
# the 50-step one, the image size of it and the apps phase (a served image is
# bit-identical to the direct pipeline call making the same call)
SERVE_WINDOW_MS, SERVE_STEPS, SERVE_PX = 200, 10, 512
# the JAX package's merge-isolation test (tests/test_serve.py): two merged
# 2-step 128^2 sketch-guided requests, each image against its solo run within
# 1 uint8 level, under 0.1% of its pixels off at all
MERGE_JAX_STEPS, MERGE_JAX_PX, MERGE_MAX_LEVELS, MERGE_MAX_SHARE = 2, 128, 1, 1e-3
# steps of the e2e phase's DDIM and text-to-image requests
REPEAT_STEPS = 10
# interleaved (on, off) pairs of the cost phase
COST_PAIRS = 3
# the demo's default steps (app.inference)
APP_STEPS = 25
# tensor parallelism over two ranks: each keeps half of the 8 heads
TP_RANKS = 2
# the guided backward under remat recomputes each block it reaches: the 12
# flash sites it differentiates, and every GroupNorm but the last up block's
# nine and conv_norm_out (their outputs feed only eps), the first 51 calls
# of a pass in execution order
REMAT_FWD_SITES, REMAT_GN = BWD_SITES, GN_UNET - 10
# steps of the request at the smallest batch the calibration flags
REMAT_STEPS = 3
REPLACES = {
    "flash_fwd": "sketch2img_tpu/ops/flash_attention.py:211 (_fwd_kernel; _fwd_kernel_t :331)",
    "flash_bwd_dq": "sketch2img_tpu/ops/flash_attention.py:601 (_bwd_dq_kernel; _bwd_dq_kernel_t :421)",
    "flash_bwd_dkv": "sketch2img_tpu/ops/flash_attention.py:640 (_bwd_dkv_kernel; _bwd_dkv_kernel_t :462)",
    "groupnorm_silu": "sketch2img_tpu/ops/groupnorm.py:54 (_kernel; _fused_forward :97, "
                      "pallas_call :112)",
    "groupnorm_silu_split": "sketch2img_tpu/ops/groupnorm.py:54 (_kernel; _fused_forward :97, "
                            "pallas_call :112)",
}
SOURCES = {
    "flash_fwd": "sketch2img_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "sketch2img_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "sketch2img_torch/csrc/flash_bwd_dkv.cu",
    "groupnorm_silu": "sketch2img_torch/csrc/groupnorm_silu.cu",
    "groupnorm_silu_split": "sketch2img_torch/csrc/groupnorm_silu.cu",
}
# the GroupNorm kernel's two variants (one pass on thread-block clusters; two
# passes for groups larger than 16 blocks' shared memory)
GN_KERNELS = ("groupnorm_silu", "groupnorm_silu_split")
# the split variant's own path shape: the VAE decoder's (B, 256, 512^2) norm
GN_SPLIT_SHAPE = (1, 256, 512, 512)
# bf16 outputs carry 2^-9 relative rounding and the kernel accumulates in a
# different order than the plain version (both round P and dS to bf16 before
# their products): each of O, dQ, dK, dV may be off by this share of its own
# largest reference value. The LSE is fp32 from exact bf16 products, so it is
# held to an absolute limit.
TOL_REL = 2e-2
TOL_LSE_ABS = 1e-3
# delta = rowsum(dO * O) in fp32 from exact products of bf16 values: only
# the summation order differs from the plain version's
TOL_DELTA_REL = 1e-4
# GroupNorm: one bf16 rounding of the output (2^-9 relative) plus another
# summation order of the statistics; max error within 1% of max|plain|, mean
# error within 0.1% of it
GN_TOL_MAX, GN_TOL_MEAN = 1e-2, 1e-3
# fp32 GroupNorm: the plain version and the kernel differ in summation order
# only (both take fp32 statistics and an fp32 output)
GN_TOL_FP32 = 1e-4


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Back-to-back calls between two CUDA events: device time plus
    whatever host work a call adds when the host is the slower side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one call: ``reps`` calls captured into a CUDA graph
    and replayed (best of three replays), so no host work is in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def profiled_device_ms(fn, reps: int = 5) -> float:
    """Device time of one call as torch.profiler sees it: the summed
    durations of the kernels the calls launched, over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def host_us(fn, reps: int = 200) -> float:
    """Host time a call: the calls are timed on the host clock without a
    synchronise (meaningful where the device is the faster side)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def bound_ms(kind: str, b: int, h: int, nq: int, nk: int, kv_len: int, d: int) -> tuple:
    """Least time on the card, the largest of tensor-core flops / peak, bytes
    / HBM rate and exponentials / special-function rate -> (ms, bound_by,
    term): bound_by "operations" or "bytes", term "tensor", "exp" or
    "bytes". The forward, dQ and dK/dV each exponentiate every logit once
    (b h nq kv_len); keys past kv_len are neither read nor computed."""
    bh = b * h
    e = 2  # bf16
    if kind == "flash_fwd":
        flops = 4 * bh * nq * kv_len * d
        nbytes = bh * (2 * nq * d + 2 * kv_len * d) * e + bh * nq * 4
    elif kind == "flash_bwd_dq":
        # reads Q, dO, O, K, V and the LSE; writes dQ and delta
        flops = 6 * bh * nq * kv_len * d
        nbytes = bh * (3 * nq * d + 2 * kv_len * d + nq * d) * e + bh * nq * 8
    else:
        # reads Q, dO, K, V, the LSE and delta; writes dK and dV
        flops = 8 * bh * nq * kv_len * d
        nbytes = bh * (2 * nq * d + 2 * kv_len * d + 2 * nk * d) * e + bh * nq * 8
    terms = {"tensor": flops / PEAK_BF16_FLOPS * 1e3, "bytes": nbytes / PEAK_HBM_BYTES * 1e3,
             "exp": bh * nq * kv_len / PEAK_EXP2 * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def gn_bound_ms(numel: int, channels: int, elem_bytes: int = 2) -> tuple:
    """GroupNorm+SiLU moves x in and y out once plus gamma and beta; its ~10
    fp32 operations an element are far below the byte time."""
    return (2 * numel + 2 * channels) * elem_bytes / PEAK_HBM_BYTES * 1e3, "bytes"


def new_entry() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "library_device_ms": 0.0, "bound_ms": 0.0, "bound_by": None, "bound_term": None,
            "shapes": []}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# one shape of every head-dim bucket the kernels are compiled for (d = 24 ->
# 32, 40 -> 48, 64, 72 -> 80, 96, 112 -> 128, 160, 176 -> 192, 256)
BUCKET_DIMS = (24, 40, 64, 72, 96, 112, 160, 176, 256)


def flash_cases():
    """(tag, B, H, nq, nk, kv_len, d, with_backward, layout) at every flash
    shape of the two paths, with q/k/v laid out as the model passes them
    ("heads": (B, H, N, d) views of (B, N, H*d) projections), plus a ragged
    and a kv_len case, every head-dim bucket, and a head dim TMA cannot read
    in place ("bhnd": contiguous (B, H, N, d))."""
    cases = []
    for n, d in MAIN_SHAPES:
        for b in (1, 2):
            cases.append(("main", b, HEADS, n, n, None, d, b == 1, "heads"))
    for n, d in MAIN_SHAPES:  # tensor parallelism at m = 2: one rank's local heads
        cases.append(("tp_attn1", 1, HEADS // TP_RANKS, n, n, None, d, True, "heads"))
        cases.append(("tp_inject_attn1", 2 * INJ_BATCH, HEADS // TP_RANKS, n, n, None, d, False,
                      "heads"))
    cases.append(("ragged", 1, HEADS, 300, 300, None, 40, True, "heads"))
    cases.append(("kv_len", 1, HEADS, 4096, 4480, 4353, 40, True, "heads"))
    for n, d in MAIN_SHAPES:
        cases.append(("inject_attn1", 2 * INJ_BATCH, HEADS, n, n, None, d, False, "heads"))
        cases.append(("inject_sketch_attn", 2 * INJ_BATCH, HEADS, n, n + CLIP_PAD,
                      n + VIT_TOKENS, d, False, "heads"))
    cases.append(("vit_sketch", 1, VIT_HEADS, VIT_TOKENS, VIT_TOKENS, None, VIT_D, False, "heads"))
    for n, d in MAIN_SHAPES:  # the trainers' batch-4 sites, forward and backward
        cases.append(("train_attn1", TRAIN_BATCH, HEADS, n, n, None, d, True, "heads"))
        cases.append(("train_cross", TRAIN_BATCH, HEADS, n, TRAIN_CTX, None, d, True, "heads"))
        cases.append(("train_sketch_attn", TRAIN_BATCH, HEADS, n, n + CLIP_PAD, n + VIT_TOKENS, d,
                      True, "heads"))
    cases.append(("train_vit", TRAIN_BATCH, VIT_HEADS, VIT_TOKENS, VIT_TOKENS, None, VIT_D, True,
                  "heads"))
    cases.append(("vit_safety", INJ_BATCH, VIT_HEADS, VIT_TOKENS, VIT_TOKENS, None, VIT_D,
                  False, "heads"))
    for d in BUCKET_DIMS:
        cases.append(("bucket", 1, 2, 256, 333, 301, d, True, "bhnd"))
    cases.append(("tma_copy", 1, 2, 200, 200, None, 36, True, "bhnd"))
    return cases


def check_flash(fa, torch) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {k: new_entry() for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    failures = []

    def make(b, h, n, d, layout):
        if layout == "heads":
            x = torch.randn(b, n, h * d, generator=gen, device="cuda").to(torch.bfloat16)
            return x.view(b, n, h, d).transpose(1, 2)
        return torch.randn(b, h, n, d, generator=gen, device="cuda").to(torch.bfloat16)

    for tag, b, h, nq, nk, kv_len, d, with_bwd, layout in flash_cases():
        q, k, v = make(b, h, nq, d, layout), make(b, h, nk, d, layout), make(b, h, nk, d, layout)
        do = make(b, h, nq, d, layout)
        scale = d ** -0.5
        kvl = nk if kv_len is None else kv_len
        ks, vs = k[:, :, :kvl], v[:, :, :kvl]

        o, lse = fa.flash_forward(q, k, v, scale, kv_len)
        o_ref, lse_ref = fa.flash_forward_plain(q, k, v, scale, kv_len)
        torch.cuda.synchronize()
        results = {"flash_fwd": [("O", o, o_ref), ("LSE", lse, lse_ref)]}
        again = {"flash_fwd": [(o, lse), fa.flash_forward(q, k, v, scale, kv_len)]}
        sdpa = lambda: F.scaled_dot_product_attention(q, ks, vs, scale=scale)  # noqa: E731
        fwd = lambda: fa.flash_forward(q, k, v, scale, kv_len)  # noqa: E731
        times = {"flash_fwd": (
            time_ms(fwd), graph_ms(fwd),
            time_ms(lambda: fa.flash_forward_plain(q, k, v, scale, kv_len), reps=5),
            time_ms(sdpa), graph_ms(sdpa))}
        if (b, h, nq, d) == (1, HEADS, 256, 160) and tag == "main":
            log(f"  flash_forward host time a call at (1, 8, 256, 160): {host_us(fwd):.2f} us")
        if d <= 64 and hasattr(fa, "FWD_TILES"):
            failures += check_forward_tiles(fa, torch, q, k, v, scale, kv_len, o_ref, lse_ref,
                                            f"case={tag} (B={b},H={h},nq={nq},kv_len={kvl},"
                                            f"d={d})", times["flash_fwd"][4])
        if with_bwd:
            dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, scale, kv_len)
            # the reference takes the plain forward's O and LSE, so an error in
            # the kernel's LSE cannot cancel out of both sides
            rq, rk, rv = fa.flash_backward_plain(q, k, v, o_ref, lse_ref, do, scale, kv_len)
            torch.cuda.synchronize()
            results["flash_bwd_dkv"] = [("dK", dk, rk), ("dV", dv, rv)]
            dq2, dk2, dv2 = fa.flash_backward(q, k, v, o, lse, do, scale, kv_len)
            again["flash_bwd_dkv"] = [(dk, dv), (dk2, dv2)]
            qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, ks, vs))
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                          retain_graph=True))
            # SDPA's backward on the device alone (its kernels' durations; a
            # graph would have to hold autograd's work too)
            lib_bwd_dev = profiled_device_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True))
            bwd = lambda: fa.flash_backward(q, k, v, o, lse, do, scale, kv_len)  # noqa: E731
            t_bwd = time_ms(bwd)
            if (b, h, nq, d) == (1, HEADS, 256, 160) and tag == "main":
                log(f"  flash_backward host time a call at (1, 8, 256, 160): {host_us(bwd):.2f} us")
            t_plain = time_ms(lambda: fa.flash_backward_plain(q, k, v, o, lse, do, scale,
                                                              kv_len), reps=5)
            # one flash_backward call launches both kernels; split its time by
            # timing each kernel alone through the C entry points
            run_dq, run_dkv, delta, _ = split_backward(fa, torch, q, k, v, o, lse, do, scale,
                                                       kvl)
            torch.cuda.synchronize()
            results["flash_bwd_dq"] = [("dQ", dq, rq),
                                       ("delta", delta, (do.float() * o.float()).sum(-1))]
            delta1 = delta.clone()
            run_dq()  # delta written again
            again["flash_bwd_dq"] = [(dq, delta1), (dq2, delta)]
            t_dq, t_dkv = time_ms(run_dq), time_ms(run_dkv)
            g_dq, g_dkv = graph_ms(run_dq), graph_ms(run_dkv)
            if tag == "main" and hasattr(fa, "backward_operands"):
                # both block shapes of the dQ kernel (buckets up to 160 have two)
                for variant, label in ((1, "128-query blocks"), (2, "64-query blocks")):
                    run_v, _, _, dq_v = split_backward(fa, torch, q, k, v, o, lse, do, scale,
                                                       kvl, variant)
                    torch.cuda.synchronize()
                    v_err = float((dq_v.float() - rq.float()).abs().max())
                    v_tol = TOL_REL * float(rq.float().abs().max())
                    dq_v1 = dq_v.clone()
                    run_v()
                    v_same = bool(dq_v1.equal(dq_v))
                    log(f"  dq variant {variant} ({label}) B={b} nq={nq} d={d}:"
                        f" device_ms={graph_ms(run_v):.4f} ms={time_ms(run_v):.4f}"
                        f" err={v_err:.3e} tol={v_tol:.3e} twice bit-identical={v_same}")
                    if not v_err <= v_tol or not v_same:
                        failures.append(f"flash_bwd_dq variant {variant} B={b} nq={nq} d={d}:"
                                        f" err={v_err:.3e} (tol {v_tol:.3e}), twice"
                                        f" bit-identical {v_same}")
            times["flash_bwd_dq"] = (t_dq, g_dq, t_plain, lib_bwd, lib_bwd_dev)
            times["flash_bwd_dkv"] = (t_dkv, g_dkv, t_plain, lib_bwd, lib_bwd_dev)
            log(f"  backward pair {t_bwd:.4f} ms = dq {t_dq:.4f} + dkv {t_dkv:.4f} (alone);"
                f" device dq {g_dq:.4f} + dkv {g_dkv:.4f} against SDPA's backward"
                f" {lib_bwd_dev:.4f}")

        for name, outs in results.items():
            checks = []
            for label, a, r in outs:
                t_err = float((a.float() - r.float()).abs().max())
                t_ref = float(r.float().abs().max())
                t_tol = (TOL_LSE_ABS if label == "LSE" else
                         TOL_DELTA_REL * t_ref if label == "delta" else TOL_REL * t_ref)
                t_ok = bool(torch.isfinite(a).all()) and t_err <= t_tol
                checks.append((label, t_err, t_ref, t_tol, t_ok))
            err = max(c[1] for c in checks)
            first, second = again[name]
            same = all(a.equal(a2) for a, a2 in zip(first, second))
            ok = all(c[4] for c in checks) and same
            kms, dms, pms, lms, ldms = times[name]
            bms, bby, bterm = bound_ms(name, b, h, nq, nk, kvl, d)
            detail = " ".join(f"{lb}:err={e:.3e},max|ref|={m:.3e},tol={t:.3e}"
                              for lb, e, m, t, _ in checks) + f" twice_bit_identical={same}"
            log(f"kernel={name} case={tag} shape=(B={b},H={h},nq={nq},nk={nk},d={d}) {layout}"
                f" kv_len={kvl} {detail} ok={ok}"
                f" ms={kms:.4f} device_ms={dms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f}"
                f" library_device_ms={ldms:.4f} bound_ms={bms:.4f} ({bterm})")
            if not ok:
                failures.append(f"{name} {tag} B={b} nq={nq} d={d}: {detail}")
            pk = per_kernel[name]
            pk["max_abs_err"] = max(pk["max_abs_err"], err)
            if tag == "main" and b == 1:
                # summed over the kernel's sites in one batch-1 UNet pass
                n_sites = SITES[name][nq]
                for key, val in (("ms", kms), ("device_ms", dms), ("plain_ms", pms),
                                 ("library_ms", lms), ("library_device_ms", ldms),
                                 ("bound_ms", bms)):
                    pk[key] += n_sites * val
                pk["bound_by"] = pk["bound_by"] or bby
                pk["bound_term"] = pk["bound_term"] or bterm
            pk["shapes"].append({"case": tag, "B": b, "H": h, "nq": nq, "nk": nk,
                                 "kv_len": kvl, "d": d, "layout": layout, "ms": kms,
                                 "device_ms": dms, "plain_ms": pms, "library_ms": lms,
                                 "library_device_ms": ldms, "bound_ms": bms,
                                 "bound_term": bterm})
        del q, k, v, do, o, lse, results, again
        torch.cuda.empty_cache()
    if failures:
        raise PhaseError("; ".join(failures))
    return per_kernel


def check_forward_tiles(fa, torch, q, k, v, scale, kv_len, o_ref, lse_ref, label,
                        library_device_ms) -> list:
    """Each forward tile forced at one d <= 64 case: against the plain
    version (``TOL_REL`` of max|O|, ``TOL_LSE_ABS``), bit-identical on a
    second launch, and its device ms beside the library's and the tile the
    rule picks. -> the failures."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    b, h, nq, d = q.shape
    kvl = k.shape[2] if kv_len is None else min(kv_len, k.shape[2])
    picked = fa.FWD_TILES[fa.forward_variant(b, h, nq, kvl, d, sms)]
    failures = []
    for variant, tile in enumerate(fa.FWD_TILES):
        def run(variant=variant):
            return fa.flash_forward(q, k, v, scale, kv_len, variant=variant)

        (o, lse), (o2, lse2) = run(), run()
        torch.cuda.synchronize()
        err = float((o.float() - o_ref.float()).abs().max())
        tol = TOL_REL * float(o_ref.float().abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        same = bool(o.equal(o2) and lse.equal(lse2))
        ok = bool(torch.isfinite(o).all()) and err <= tol and lse_err <= TOL_LSE_ABS and same
        log(f"  forward tile {tile} {label}: device_ms={graph_ms(run):.4f}"
            f" library_device_ms={library_device_ms:.4f} O:err={err:.3e},tol={tol:.3e}"
            f" LSE:err={lse_err:.3e} twice_bit_identical={same} ok={ok} rule={picked}")
        if not ok:
            failures.append(f"forward tile {tile} {label}: O err {err:.3e} (tol {tol:.3e}),"
                            f" LSE err {lse_err:.3e}, twice bit-identical {same}")
    return failures


def record_forward_shapes(fa):
    """Wrap the module's ``flash_forward`` so that each call's (B, H, nq,
    keys, d) is recorded, keys past kv_len left out. -> (the list it fills,
    a function that unwraps it)."""
    shapes, real = [], fa.flash_forward

    def recorder(q, k, v, scale, kv_len=None, **kw):
        b, h, nq, d = q.shape
        keys = k.shape[2] if kv_len is None else min(kv_len, k.shape[2])
        shapes.append((b, h, nq, keys, d))
        return real(q, k, v, scale, kv_len, **kw)

    fa.flash_forward = recorder
    return shapes, lambda: setattr(fa, "flash_forward", real)


def check_tile_counts(fa, torch, path: str, shapes) -> None:
    """The forward's launches by tile (``FWD_VARIANTS``) are the rule's
    choice on each call the path made (a package without the counter: none
    to check)."""
    if not hasattr(fa, "FWD_VARIANTS"):
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = dict.fromkeys(fa.FWD_TILES, 0)
    for shape in shapes:
        want[fa.FWD_TILES[fa.forward_variant(*shape, sms)]] += 1
    got = dict(fa.FWD_VARIANTS)
    log(f"  {path}: flash forward launches by tile {got} (the rule on its calls: {want})")
    if got != want:
        raise PhaseError(f"{path}: forward launches by tile {got} != the rule's {want}")


def split_backward(fa, torch, q, k, v, o, lse, do, scale, kvl, variant: int = 0):
    """The dQ and dK/dV launches of one flash_backward, each callable alone
    through the C entry points (on the stream current at the call), and the
    delta they share. The dQ kernel writes delta (run once here, so that
    the dK/dV launch has it); ``variant`` picks its block shape (0 as the
    wrapper does, 1: 128-query blocks, 2: 64-query blocks splitting the key
    tiles). Against a package whose dQ kernel takes delta (a parent tree),
    delta is computed here as that wrapper did."""
    lib = fa.load_library()
    in_kernel = hasattr(fa, "backward_operands")
    if in_kernel:
        q, k, v, do, o = fa.backward_operands(q, k, v, o, do)
    else:
        q, k, v, do = (fa.prepare_operand(x)[0] for x in (q, k, v, do))
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if in_kernel:
        delta = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    else:
        delta = (do.float() * o.float()).sum(-1).contiguous()
    lse = lse.float().contiguous()
    dq = fa._heads_merged(b, h, nq, d, q)
    dk, dv = fa._heads_merged(b, h, nk, d, q), fa._heads_merged(b, h, nk, d, q)
    view = fa._view
    tail = (b, h, nq, nk, d, kvl, float(scale), 0)

    def qkvd():
        return (q.device.index, torch.cuda.current_stream().cuda_stream, *view(q), *view(k),
                *view(v), *view(do))

    def run_dq():
        if in_kernel:
            fa._launch("flash_bwd_dq", lib.flash_bwd_dq, *qkvd(), *view(o), lse.data_ptr(),
                       delta.data_ptr(), *view(dq), *tail, variant)
        else:
            fa._launch("flash_bwd_dq", lib.flash_bwd_dq, *qkvd(), lse.data_ptr(),
                       delta.data_ptr(), *view(dq), *tail)

    def run_dkv():
        fa._launch("flash_bwd_dkv", lib.flash_bwd_dkv, *qkvd(), lse.data_ptr(), delta.data_ptr(),
                   *view(dk), *view(dv), *tail)

    run_dq()
    return run_dq, run_dkv, delta, dq


def record_gn_calls(stack, gn, torch) -> tuple:
    """One pass of each model of the four paths with a recorder on the
    GroupNorm op -> ({pass: [((B, C, H, W), eps, silu), ...]}, {tag: real
    input}). The real inputs: a 64^2 norm1 of the UNet's up path (C=960) at
    t=500, and the VAE decoder's conv_norm_out input at 512^2."""
    comps, inj = stack.comps, stack.inject
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    def unet(b, injected=False):
        t = torch.full((b,), 500, dtype=torch.long, device="cuda")
        if not injected:
            return comps.unet(randn(b, 4, 64, 64), t, randn(b, 77, 768))
        state = randn(b, VIT_TOKENS, inj.clip_config.hidden_size)
        scale = torch.full((b, 1, 1), 0.5, device="cuda")
        return inj.unet(randn(b, 4, 64, 64), t, randn(b, 77, 768),
                        injection_states=[state] * 16, injection_scale=scale)

    passes = {
        "unet_b1": lambda: unet(1),                      # sketch-guided, guided steps
        "unet_b2": lambda: unet(2),                      # sketch-guided, plain steps
        "unet_inj_b16": lambda: unet(2 * INJ_BATCH, True),  # injection path
        "unet_b4": lambda: unet(TRAIN_BATCH),            # LGP trainer
        "unet_inj_b4": lambda: unet(TRAIN_BATCH, True),  # injection trainer
        "vae_enc_b1": lambda: comps.vae.encode(randn(1, 3, 512, 512)),
        "vae_enc_b4": lambda: comps.vae.encode(randn(TRAIN_BATCH, 3, 512, 512)),  # trainers
        "vae_dec_b1": lambda: comps.vae.decode(randn(1, 4, 64, 64)),
        "vae_dec_b8": lambda: comps.vae.decode(randn(INJ_BATCH, 4, 64, 64)),
    }
    real = gn._forward
    calls, inputs = [], {}

    def recorder(x, w, b, groups, eps, silu):
        calls.append((tuple(x.shape), float(eps), bool(silu)))
        if name == "unet_b1" and x.shape[1:] == (960, 64, 64) and "unet_norm1" not in inputs:
            inputs["unet_norm1"] = x.detach().clone()
        if name == "vae_dec_b1" and x.shape[1:] == (128, 512, 512):
            inputs["vae_norm_out"] = x.detach().clone()  # the last one wins
        return real(x, w, b, groups, eps, silu)

    per_pass = {}
    gn._forward = recorder
    try:
        with torch.no_grad():
            for name, fn in passes.items():
                calls.clear()
                fn()
                per_pass[name] = list(calls)
    finally:
        gn._forward = real
    want = {"unet_b1": GN_UNET, "unet_b2": GN_UNET, "unet_inj_b16": GN_UNET,
            "unet_b4": GN_UNET, "unet_inj_b4": GN_UNET, "vae_enc_b1": GN_VAE_ENC,
            "vae_enc_b4": GN_VAE_ENC, "vae_dec_b1": GN_VAE_DEC, "vae_dec_b8": GN_VAE_DEC}
    got = {k: len(v) for k, v in per_pass.items()}
    log(f"  GroupNorm calls per pass {got} expected {want}")
    if got != want:
        raise PhaseError(f"GroupNorm calls per pass {got} != {want}")
    return per_pass, inputs


def gn_kernel_of(gn, shape, dtype_bytes: int = 2) -> str:
    """The variant the wrapper's plan takes at a (B, C, H, W) shape (a
    package without plans has the one kernel)."""
    if not hasattr(gn, "launch_plan"):
        return "groupnorm_silu"
    b, c, h, w = shape
    return gn.launch_plan(b, c, h * w, 32, dtype_bytes).kernel


def gn_fits_one_pass(gn, x) -> bool:
    """Can the one-pass variant take x's groups (forced where the plan
    prefers the split one)?"""
    b, c, h, w = x.shape
    try:
        gn.launch_plan(b, c, h * w, 32, x.element_size(), "groupnorm_silu")
    except ValueError:
        return False
    return True


def gn_launches(gn, passes) -> dict:
    """Expected GroupNorm launches by variant over ``passes``, a list of
    (recorded calls of one model pass, times run)."""
    out = {}
    for calls, times in passes:
        for shape, _, _ in calls:
            name = gn_kernel_of(gn, shape)
            out[name] = out.get(name, 0) + times
    return {name: out.get(name, 0) for name in gn.LAUNCHES}


def check_groupnorm(stack, gn, torch) -> dict:
    """Each variant of the kernel against the plain version at every
    distinct (B, C, H, W, eps, silu) the passes gave it (random inputs, mean
    0.5, and a random affine; the one-pass variant forced where the plan
    prefers the split one and a group fits 16 blocks), on the real
    activations, and in fp32 on both sides of the variants' boundary; times of each variant, the plain version and the
    yardstick F.silu(F.group_norm(x)) (two PyTorch calls); the wrapper's
    host time a call."""
    import torch.nn.functional as F

    per_pass, inputs = stack.gn_calls(gn, torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = {}
    for calls in per_pass.values():
        for shape, eps, silu in calls:
            cases.setdefault((shape, eps, silu), None)
    bf16, fp32 = torch.bfloat16, torch.float32
    work = [("shape", shape, eps, silu, bf16, None) for shape, eps, silu in cases]
    work += [("real_unet_norm1", tuple(inputs["unet_norm1"].shape), 1e-5, True, bf16,
              inputs["unet_norm1"]),
             ("real_vae_norm_out", tuple(inputs["vae_norm_out"].shape), 1e-6, True, bf16,
              inputs["vae_norm_out"]),
             # fp32: 2 MB groups (split, or one pass forced on 16 blocks of
             # 128 KB), 4 MB groups (split only), 160 KB groups (one pass)
             ("fp32", (1, 256, 256, 256), 1e-6, True, fp32, None),
             ("fp32", (1, 128, 512, 512), 1e-6, True, fp32, None),
             ("fp32", (2, 320, 64, 64), 1e-5, False, fp32, None)]
    variants = GN_KERNELS if hasattr(gn, "launch_plan") else GN_KERNELS[:1]
    entries = {name: new_entry() for name in variants}
    failures, timed, split_sums = [], {}, {}
    for tag, shape, eps, silu, dt, x in work:
        c = shape[1]
        if x is None:
            x = (torch.randn(*shape, generator=gen, device="cuda") + 0.5).to(dt)
        w = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dt)
        b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dt)
        p = gn.group_norm_silu_plain(x, w, b, 32, eps, silu)
        ref = float(p.float().abs().max())
        big = x.numel() > 2 ** 26

        def library():
            out = F.group_norm(x, 32, w, b, eps)
            return F.silu(out) if silu else out

        pms = time_ms(lambda: gn.group_norm_silu_plain(x, w, b, 32, eps, silu),
                      reps=3 if big else 5)
        lms, ldms = time_ms(library), graph_ms(library, reps=3 if big else 10)
        bms, bby = gn_bound_ms(x.numel(), c, x.element_size())
        planned = gn_kernel_of(gn, shape, x.element_size())
        for name in variants:
            if name == "groupnorm_silu" and planned != name and not gn_fits_one_pass(gn, x):
                continue  # the group does not fit 16 blocks' shared memory
            kw = {"kernel": name} if len(variants) > 1 else {}
            kernel = lambda: gn.group_norm_silu_kernel(x, w, b, 32, eps, silu, **kw)  # noqa: E731
            y = kernel()
            same = bool(y.equal(kernel()))  # launched twice: bit-identical
            torch.cuda.synchronize()
            diff = (y.float() - p.float()).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            tol_max, tol_mean = ((GN_TOL_MAX, GN_TOL_MEAN) if dt == bf16
                                 else (GN_TOL_FP32, GN_TOL_FP32))
            ok = (bool(torch.isfinite(y).all()) and err <= tol_max * ref
                  and mean_err <= tol_mean * ref and same)
            kms, dms = time_ms(kernel), graph_ms(kernel, reps=3 if big else 10)
            log(f"kernel={name} case={tag} shape={shape} {str(dt)[6:]} eps={eps:g} silu={silu}"
                f" planned={planned == name} err={err:.3e} mean_err={mean_err:.3e}"
                f" max|plain|={ref:.3e} tol={tol_max * ref:.3e}/{tol_mean * ref:.3e}"
                f" twice_bit_identical={same} ok={ok}"
                f" ms={kms:.4f} device_ms={dms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f}"
                f" library_device_ms={ldms:.4f} bound_ms={bms:.4f} ({bby})")
            if not ok:
                failures.append(f"{name} {tag} {shape} {dt} eps={eps} silu={silu}: err={err:.3e}"
                                f" mean={mean_err:.3e} max|plain|={ref:.3e}, twice"
                                f" bit-identical {same}")
            entry = entries[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["bound_by"] = entry["bound_term"] = bby
            vals = (kms, dms, pms, lms, ldms, bms)
            if tag == "shape" and name == planned:
                timed[(shape, eps, silu)] = vals
            if tag == "shape" and name == "groupnorm_silu_split":
                split_sums[(shape, eps, silu)] = vals
            if name == "groupnorm_silu_split" and shape == GN_SPLIT_SHAPE and tag == "shape":
                entry.update(zip(("ms", "device_ms", "plain_ms", "library_ms",
                                  "library_device_ms", "bound_ms"), vals))
            entry["shapes"].append({"case": tag, "shape": list(shape), "dtype": str(dt)[6:],
                                    "eps": eps, "silu": silu, "planned": planned == name,
                                    "ms": kms, "device_ms": dms, "plain_ms": pms,
                                    "library_ms": lms, "library_device_ms": ldms,
                                    "bound_ms": bms})
            del y, diff
        del x, p
        torch.cuda.empty_cache()
    if failures:
        raise PhaseError("; ".join(failures))
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")
    for name, calls in per_pass.items():
        tot = dict(zip(keys, (sum(timed[call][i] for call in calls) for i in range(6))))
        n_split = sum(gn_kernel_of(gn, call[0]) != "groupnorm_silu" for call in calls)
        log(f"  groupnorm planned variants summed over one {name} pass ({len(calls)} calls,"
            f" {n_split} split): " + " ".join(f"{k_}={v_:.4f}" for k_, v_ in tot.items()))
        if all(call in split_sums for call in calls):
            alt = sum(split_sums[call][1] for call in calls)
            log(f"  the split variant over the same {name} pass: device_ms={alt:.4f}")
        if name == "unet_b1":  # the flash kernels' convention: one batch-1 UNet pass
            entries["groupnorm_silu"].update(tot)
    # the wrapper's host time a call at a batch-1 UNet shape, where the
    # device takes a few microseconds
    x = torch.randn(1, 1280, 8, 8, device="cuda").to(bf16)
    w, b = torch.ones(1280, device="cuda", dtype=bf16), torch.zeros(1280, device="cuda", dtype=bf16)
    log(f"  group_norm_silu_kernel host time a call at (1, 1280, 8, 8): "
        f"{host_us(lambda: gn.group_norm_silu_kernel(x, w, b, 32, 1e-5, True)):.2f} us")
    if hasattr(gn, "load_library") and hasattr(gn.load_library(), "groupnorm_max_active_clusters"):
        lib = gn.load_library()
        for cluster, kb in ((16, 128), (16, 64), (8, 64)):
            n = lib.groupnorm_max_active_clusters(torch.cuda.current_device(), cluster, kb * 1024)
            log(f"  clusters of {cluster} one-pass blocks with {kb} KB the card holds at once: {n}")
            if n < 1:
                raise PhaseError(f"the card cannot schedule clusters of {cluster} blocks "
                                 f"with {kb} KB of shared memory")
    return entries


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,e2e,inject,train_lgp,train_inject,serve,apps,remat,"
                            "dist,cost")
    ap.add_argument("--steps", type=int, default=50, help="sampling steps of the e2e request")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas register/smem use")
    ap.add_argument("--tp-worker", nargs=3, metavar=("RANK", "INIT_FILE", "OUT"),
                    help=argparse.SUPPRESS)  # one rank of the dist phase's TP run
    args = ap.parse_args(argv)
    if args.tp_worker:
        return tp_worker(*args.tp_worker)
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from sketch2img_torch.ops import flash_attention as fa
        from sketch2img_torch.ops import groupnorm as gn
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    stack = Stack(torch)
    per_kernel = None
    launches = {}
    try:
        if phases:
            from concurrent.futures import ThreadPoolExecutor

            t0 = time.time()
            with ThreadPoolExecutor(2) as pool:  # every nvcc process starts at once
                for f in [pool.submit(m.load_library, verbose=args.ptxas) for m in (fa, gn)]:
                    f.result()
            log(f"phase build: ok, {time.time() - t0:.2f} s")
            if args.ptxas:
                from sketch2img_torch.utils.cuda_build import LAST_BUILD_LOG

                for chunk in LAST_BUILD_LOG:
                    log(chunk)
        if "kernels" in phases or "flash" in phases:
            t0 = time.time()
            per_kernel = check_flash(fa, torch)
            log(f"  flash kernels checked, {time.time() - t0:.2f} s")
            if "kernels" in phases:
                per_kernel.update(check_groupnorm(stack, gn, torch))
            log(f"phase kernels: ok, {time.time() - t0:.2f} s")
        if "e2e" in phases:
            t0 = time.time()
            launches["sketch_guided"] = run_e2e(stack, fa, gn, torch, args.steps)
            log(f"phase e2e: ok, {time.time() - t0:.2f} s")
        if "inject" in phases:
            t0 = time.time()
            launches["inject"] = run_inject(stack, fa, gn, torch)
            log(f"phase inject: ok, {time.time() - t0:.2f} s")
        if "train_lgp" in phases:
            t0 = time.time()
            launches["train_lgp"] = run_train_lgp(stack, fa, gn, torch)
            log(f"phase train_lgp: ok, {time.time() - t0:.2f} s")
        if "train_inject" in phases:
            t0 = time.time()
            launches["train_inject"] = run_train_inject(stack, fa, gn, torch)
            log(f"phase train_inject: ok, {time.time() - t0:.2f} s")
        if "serve" in phases:
            t0 = time.time()
            launches["serve"] = run_serve(stack, fa, gn, torch)
            log(f"phase serve: ok, {time.time() - t0:.2f} s")
        if "apps" in phases:
            t0 = time.time()
            launches.update({f"apps_{k}": v for k, v in run_apps(stack, fa, gn, torch).items()})
            log(f"phase apps: ok, {time.time() - t0:.2f} s")
        if "remat" in phases:
            t0 = time.time()
            launches["remat"] = run_remat(stack, fa, gn, torch)
            log(f"phase remat: ok, {time.time() - t0:.2f} s")
        if "calibrate" in phases:
            t0 = time.time()
            calibration_rows(stack, torch)
            log(f"phase calibrate: ok, {time.time() - t0:.2f} s")
        if "dist" in phases:
            t0 = time.time()
            launches["dist"] = run_dist(stack, fa, gn, torch)
            log(f"phase dist: ok, {time.time() - t0:.2f} s")
        if "cost" in phases:
            t0 = time.time()
            run_cost(stack, torch)
            log(f"phase cost: ok, {time.time() - t0:.2f} s")
        if "profile" in phases:
            t0 = time.time()
            run_profile(stack, torch)
            log(f"phase profile: ok, {time.time() - t0:.2f} s")
    except Exception as e:  # every failed phase ends the run with a non-zero exit
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    if per_kernel is not None:
        # launches are counted only in the paths' counted runs (summed over
        # the paths that ran); without one there is no count
        entries = []
        for name in REPLACES:
            if name not in per_kernel:
                continue
            pk = per_kernel[name]
            by_path = {path: per_path[name] for path, per_path in launches.items()}
            entries.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(by_path.values()) if by_path else None,
                "launches_by_path": by_path,
                "max_abs_err": pk["max_abs_err"], "ms": pk["ms"], "device_ms": pk["device_ms"],
                "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
                "bound_by": pk["bound_by"], "bound_term": pk["bound_term"],
                "library_ms": pk["library_ms"], "library_device_ms": pk["library_device_ms"],
                "shapes": pk["shapes"],
            })
        log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the full-width models, shared by the phases
# ---------------------------------------------------------------------------


class StandInTokenizer:
    """Deterministic stand-in for the CLIP BPE tokenizer (no vocab ships with
    the repository): [bos] + byte-derived ids + [eos], eos-padded to 77."""

    pad_token_id = 49407

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, padding=None, truncation=None, max_length=77):
        def encode(s):
            ids = [49406] + [256 + (ord(ch) % 1000) for ch in s][: max_length - 2] + [49407]
            return ids + [self.pad_token_id] * (max_length - len(ids))

        return self._Out(encode(text) if isinstance(text, str) else [encode(s) for s in text])


def guided_pass(comps, torch, x, t, ctx, target, remat=False):
    """The differentiated half of a guided step: cond UNet forward with taps,
    fused LGP head, MSE against the sketch latent, gradient w.r.t. x."""
    from sketch2img_torch.core.schedulers import get_noise_level
    from sketch2img_torch.models.lgp import lgp_fused_apply

    xc = x.detach().requires_grad_(True)
    eps, taps = comps.unet(xc, t, ctx, capture_taps=True, remat=remat)
    out = lgp_fused_apply(comps.lgp, taps, get_noise_level(comps.schedule, x, t),
                          x.shape[2], x.shape[3])
    loss = torch.mean((target - out.float()) ** 2)
    (g,) = torch.autograd.grad(loss, xc)
    return eps.detach(), g


class Stack:
    """SD1.5 at full published width on seeded random weights (bf16, LGP
    fp32), and the injection pipeline over the same components; each built
    at first use."""

    def __init__(self, torch):
        self.torch = torch
        self._comps = self._inject = self._gn_calls = self._gan = self._images = None
        self.guided_image = None  # the e2e phase's 50-step request

    @property
    def comps(self):
        if self._comps is None:
            from sketch2img_torch.runtime import SDComponents

            torch = self.torch
            t0 = time.perf_counter()
            self._comps = c = SDComponents.random_init(seed=0, compute_dtype=torch.bfloat16,
                                                       random_weights=True, device="cuda")
            c.tokenizer = StandInTokenizer()
            torch.cuda.synchronize()
            log(f"  the package's setting after random_init: cudnn.deterministic"
                f" {torch.backends.cudnn.deterministic}, benchmark"
                f" {torch.backends.cudnn.benchmark}, deterministic algorithms"
                f" {torch.are_deterministic_algorithms_enabled()}")
            if not torch.backends.cudnn.deterministic or torch.backends.cudnn.benchmark:
                raise PhaseError("SDComponents.random_init did not make cuDNN deterministic")
            n_params = {name: sum(p.numel() for p in m.parameters())
                        for name, m in (("unet", c.unet), ("vae", c.vae),
                                        ("text_encoder", c.text_encoder), ("lgp", c.lgp))}
            log(f"  random_init (full SD1.5 width, bf16, LGP fp32 {c.lgp.layers[0].in_features}"
                f" inputs): {time.perf_counter() - t0:.2f} s, params {n_params}")
        return self._comps

    def gn_calls(self, gn, torch):
        """``record_gn_calls``, once: the GroupNorm calls of one pass of each
        model of the two paths, and two real inputs."""
        if self._gn_calls is None:
            self._gn_calls = record_gn_calls(self, gn, torch)
        return self._gn_calls

    @property
    def inject(self):
        if self._inject is None:
            from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline

            t0 = time.perf_counter()
            self._inject = p = ClipGuidedPipeline(components=self.comps)
            self.torch.cuda.synchronize()
            log(f"  ClipGuidedPipeline (clip-injected UNet over the shared base weights, "
                f"ViT-L/14 {sum(q.numel() for q in p.clip.parameters())} params, injection "
                f"blocks {sum(q.numel() for q in p.unet.sat.parameters())} params): "
                f"{time.perf_counter() - t0:.2f} s")
        return self._inject


    @property
    def gan(self):
        """The anime2sketch generator at its published width (8 downs, ngf
        64), seeded random weights, fp32, frozen."""
        if self._gan is None:
            from sketch2img_torch.models.anime2sketch import create_anime2sketch

            torch = self.torch
            with torch.random.fork_rng(devices=[torch.cuda.current_device()]), \
                    torch.device("cuda"):
                torch.manual_seed(5)
                self._gan = create_anime2sketch().eval().requires_grad_(False)
            log(f"  anime2sketch (8 downs, ngf 64, fp32): "
                f"{sum(p.numel() for p in self._gan.parameters())} params")
        return self._gan

    def vit(self, seed: int = 6):
        """A fresh ViT-L/14 (fp32) for the injection trainer."""
        from sketch2img_torch.models.clip_vision import VIT_L14_CONFIG, CLIPVisionEncoder

        torch = self.torch
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]), torch.device("cuda"):
            torch.manual_seed(seed)
            return CLIPVisionEncoder(VIT_L14_CONFIG)

    @property
    def images(self) -> str:
        """A folder of 16 seeded synthetic PNG images (smooth colour fields
        with strokes, 520-672 px on a side) with ``.txt`` captions, made once
        under build/chip_smoke/ (the trainers' dataset: one epoch is the
        ``TRAIN_STEPS`` steps of a phase)."""
        if self._images is None:
            import numpy as np
            from PIL import Image

            folder = os.path.join(SMOKE_DIR, "images")
            os.makedirs(folder, exist_ok=True)
            rng = np.random.RandomState(1138)
            for i in range(TRAIN_BATCH * TRAIN_STEPS):
                h, w = 520 + 8 * i, 672 - 6 * i
                coarse = rng.rand(h // 64 + 2, w // 64 + 2, 3)
                img = np.kron(coarse, np.ones((64, 64, 1)))[:h, :w]
                for _ in range(12):  # dark strokes for the generator to find
                    r0, c0 = rng.randint(0, h - 40), rng.randint(0, w - 200)
                    img[r0:r0 + 4, c0:c0 + 200] = 0.05
                Image.fromarray((img * 255).astype(np.uint8)).save(f"{folder}/im{i:02d}.png")
                with open(f"{folder}/im{i:02d}.txt", "w") as f:
                    f.write(f"1girl, solo, sketch, lineart, flower_{i}, sky, tree_{i % 3}")
            self._images = folder
        return self._images


SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def sketch_image(np, px: int = 512):
    """A cross of two 12/512-wide strokes on a px^2 pad."""
    sketch = np.zeros((px, px), np.float32)
    lo, hi, a, b = (px * v // 512 for v in (100, 412, 250, 262))
    sketch[lo:hi, a:b] = 1.0
    sketch[a:b, lo:hi] = 1.0
    return sketch


def counts(fa, gn) -> dict:
    return {**fa.LAUNCHES, **gn.LAUNCHES}


def check_no_copies(fa, path: str) -> None:
    """The flash wrapper copied no operand for TMA on the path's counted run
    (every q/k/v/dO there is a heads-view TMA reads in place)."""
    copies = dict(getattr(fa, "TMA_COPIES", {}))
    log(f"  {path}: operand copies for TMA {copies} (expected all 0)")
    if any(copies.values()):
        raise PhaseError(f"{path}: the flash wrapper copied operands for TMA: {copies}")


def reset_counts(fa, gn) -> None:
    fa.reset_launch_counts()
    gn.reset_launch_counts()


def compare_guided(comps, torch, x, t, ctx, target, label, plain_route):
    """Guided UNet pass with the kernels against one with ``plain_route``
    (a context manager) in force: eps relative error and gradient cosine."""
    eps_k, g_k = guided_pass(comps, torch, x, t, ctx, target)
    with plain_route():
        eps_p, g_p = guided_pass(comps, torch, x, t, ctx, target)
    eps_rel = float((eps_k - eps_p).abs().max() / eps_p.abs().max())
    g_cos = float(torch.nn.functional.cosine_similarity(g_k.flatten(), g_p.flatten(), dim=0))
    ok = eps_rel <= 5e-2 and g_cos >= 0.98
    log(f"  guided UNet pass, kernels vs {label} (bf16, 512^2): eps max err / max|eps|"
        f" = {eps_rel:.3e} (tol 5e-2), grad cosine = {g_cos:.5f} (tol 0.98) ok={ok}")
    if not ok:
        raise PhaseError(f"kernels disagree with the {label} in the guided pass")


def repeatability(comps, torch, x, t, ctx, target, gn) -> None:
    """The guided pass run twice on the same inputs, through the kernels and
    through each plain route: eps and the gradient must come out
    bit-identical (the package's deterministic setting on the card); then
    the pass under PyTorch's warn-only deterministic mode (``probe``)."""
    routes = {"kernels": contextlib.nullcontext, "plain attention": plain_attention_route,
              "plain GroupNorm": functools.partial(plain_groupnorm_route, gn),
              "plain attention and GroupNorm": lambda: _both_plain(gn)}
    notes, differ = [], []
    for label, route in routes.items():
        with route():
            (e1, g1), (e2, g2) = (guided_pass(comps, torch, x, t, ctx, target) for _ in range(2))
        notes.append(f"{label}: eps {same_note(torch, e1, e2)}, gradient"
                     f" {same_note(torch, g1, g2)}")
        if not (e1.equal(e2) and g1.equal(g2)):
            differ.append(label)
    log(f"  guided pass twice on the same inputs (cudnn.deterministic"
        f" {torch.backends.cudnn.deterministic}, benchmark {torch.backends.cudnn.benchmark}):"
        f" {'; '.join(notes)}")
    if differ:
        raise PhaseError(f"the guided pass is not bit-repeatable through {differ}")
    probe(torch, "guided pass", lambda: guided_pass(comps, torch, x, t, ctx, target))


def batch_gap(comps, torch, pipe) -> None:
    """The guided pass at batch 2 against each image's pass alone (a
    measurement: where a merged request's distance from its solo run
    starts). The loss is a mean over the batch, so the gradients are
    compared by direction."""
    x, t, ctx, target = guided_inputs(pipe, torch, batch=2, seed=2)
    eps_b, g_b = guided_pass(comps, torch, x, t, ctx, target)
    notes = []
    for i in range(2):
        one = slice(i, i + 1)
        eps_s, g_s = guided_pass(comps, torch, x[one], t[one], ctx[one], target[one])
        e_rel = float((eps_b[one] - eps_s).abs().max() / eps_s.abs().max())
        gb, gs = g_b[one].flatten().float(), g_s.flatten().float()
        cos = float(torch.nn.functional.cosine_similarity(gb, gs, dim=0))
        apart = float((gb / gb.norm() - gs / gs.norm()).norm())
        notes.append(f"image {i}: eps max diff {e_rel:.3e} of max|eps|, gradient cosine"
                     f" {cos:.6f}, unit gradients {apart:.3e} apart")
    log(f"  guided pass 512^2 at batch 2 against each image alone: {'; '.join(notes)}")


def stock_resize_repeat(torch, runs: int = 20) -> None:
    """PyTorch's own bilinear backward (``F.interpolate``'s, which the port's
    ``resize_bilinear`` replaces with an adjoint of fixed order) at the LGP
    head's upsamplings of 512 channels to 64^2, run ``runs`` times on the
    same gradient, as PyTorch runs by default and under
    ``use_deterministic_algorithms(True)``: how many runs equal the first,
    or the error the mode raises (a measurement)."""
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    notes = []
    for strict in (False, True):
        torch.use_deterministic_algorithms(strict)
        try:
            for side in (8, 16, 32):
                x = torch.randn(1, 512, side, side, device="cuda", requires_grad=True)
                dy = torch.randn(1, 512, 64, 64, device="cuda")
                y = torch.nn.functional.interpolate(x, size=(64, 64), mode="bilinear",
                                                    align_corners=False)
                try:
                    grads = [torch.autograd.grad(y, x, dy, retain_graph=True)[0]
                             for _ in range(runs)]
                    got = f"{sum(g.equal(grads[0]) for g in grads)} of {runs}"
                except RuntimeError as e:
                    got = f"raises ({str(e)[:80]})"
                notes.append(f"{'deterministic mode' if strict else 'default'} {side}^2: {got}")
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    log(f"  PyTorch's bilinear backward, (1, 512) to 64^2 fp32, runs equal to the first:"
        f" {', '.join(notes)}")


def same_note(torch, a, b) -> str:
    if a.equal(b):
        return "equal"
    return "differs by %.3e of its max" % float((a - b).abs().max() / b.abs().max())


def probe(torch, label: str, fn) -> list:
    """``fn`` run under PyTorch's deterministic mode in its warn-only form (a
    measurement; the package never sets it): the ops that report having no
    deterministic implementation. Three ops PyTorch documents as having
    none on CUDA run first as controls that such reports are seen: one in
    a forward (``histc``) and two in a backward, which runs on autograd's
    device thread (adaptive average pooling, bilinear upsampling)."""
    import warnings

    def reports(caught):
        return sorted({str(w.message).split(" does not have")[0][:120] for w in caught
                       if "determinis" in str(w.message)})

    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            xc = torch.randn(1, 1, 8, 8, device="cuda", requires_grad=True)
            torch.histc(xc.detach())
            torch.nn.functional.adaptive_avg_pool2d(xc, 3).sum().backward()
            torch.nn.functional.interpolate(xc, size=(16, 16), mode="bilinear").sum().backward()
            torch.cuda.synchronize()
            control = reports(caught)
            caught.clear()
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    ops = reports(caught)
    log(f"  {label} in PyTorch's warn-only deterministic mode: ops reported without a"
        f" deterministic implementation {ops} (the controls, histc and the backward of an"
        f" adaptive average pool and a bilinear upsample: {control})")
    return ops


@contextlib.contextmanager
def _both_plain(gn):
    with plain_attention_route(), plain_groupnorm_route(gn):
        yield


@contextlib.contextmanager
def plain_attention_route():
    """Every attention site on the plain path while in force."""
    from sketch2img_torch.ops.attention import set_default_attention_backend

    set_default_attention_backend("plain")
    try:
        yield
    finally:
        set_default_attention_backend("auto")


@contextlib.contextmanager
def plain_groupnorm_route(gn):
    """Every GroupNorm through the plain version while in force (flash kept)."""
    real = gn._forward
    gn._forward = gn.group_norm_silu_plain
    try:
        yield
    finally:
        gn._forward = real


def guided_expected(stack, gn, torch, steps: int, remat: bool = False) -> dict:
    """Launches of one batch-1 512^2 sketch-guided request of ``steps``
    DPM-Solver++ steps: each guided step an uncond forward and a cond
    forward with the backward (12 flash sites), each plain step one forward
    at batch 2; the sketch's VAE encode and the decode. With ``remat`` each
    guided backward runs the forward of every block it reaches again
    (``REMAT_FWD_SITES`` flash sites, the first ``REMAT_GN`` GroupNorms)."""
    from sketch2img_torch.pipelines.sketch_guided import num_guided_steps

    n_guided = num_guided_steps(steps)
    n_plain = steps - n_guided
    per_pass, _ = stack.gn_calls(gn, torch)
    again = n_guided if remat else 0
    return {"flash_fwd": FWD_SITES * (2 * n_guided + n_plain) + REMAT_FWD_SITES * again,
            "flash_bwd_dq": BWD_SITES * n_guided, "flash_bwd_dkv": BWD_SITES * n_guided,
            **gn_launches(gn, [(per_pass["unet_b1"], 2 * n_guided),
                               (per_pass["unet_b1"][:REMAT_GN], again),
                               (per_pass["unet_b2"], n_plain), (per_pass["vae_enc_b1"], 1),
                               (per_pass["vae_dec_b1"], 1)])}


def run_e2e(stack, fa, gn, torch, steps: int) -> dict:
    import numpy as np

    from sketch2img_torch.pipelines.sketch_guided import num_guided_steps
    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps = stack.comps
    pipe = SketchGuidedPipeline(comps)
    sketch = sketch_image(np)

    # the kernels against the plain paths inside one guided UNet pass
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1, 4, 64, 64, generator=gen, device="cuda")
    target = torch.randn(1, 4, 64, 64, generator=gen, device="cuda") * 0.2
    t = torch.full((1,), 801, dtype=torch.long, device="cuda")
    _, ctx = pipe.encode_prompt("a house")
    compare_guided(comps, torch, x, t, ctx, target, "plain attention path", plain_attention_route)
    compare_guided(comps, torch, x, t, ctx, target, "plain GroupNorm path",
                   functools.partial(plain_groupnorm_route, gn))
    repeatability(comps, torch, x, t, ctx, target, gn)
    batch_gap(comps, torch, pipe)
    stock_resize_repeat(torch)

    def run(n_steps, count, per_step=True):
        marks = []

        def cb(i, t_, lat):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        if count:
            reset_counts(fa, gn)
            shapes, unwrap = record_forward_shapes(fa)
        start = time.perf_counter()
        try:
            img = pipe("a sketch of a house", num_inference_steps=n_steps, width=512,
                       height=512, seed=1234, sketch_image=sketch,
                       callback=cb if per_step else None)
            torch.cuda.synchronize()
        finally:
            if count:
                unwrap()
        launches = counts(fa, gn) if count else None
        if count:
            check_no_copies(fa, "sketch-guided request")
            check_tile_counts(fa, torch, "sketch-guided request", shapes)
        return img, launches, start, marks, time.perf_counter()

    run(4, False)  # warm-up: cuDNN plans for both batch sizes, allocator
    torch.cuda.reset_peak_memory_stats()
    img, launches, start, marks, end = run(steps, True)  # the counted main-path run
    again, _, r_start, _, r_end = run(steps, False, per_step=False)  # no per-step syncs
    log(f"  request (sketch-guided 512x512 B=1, {steps} steps, no callback): "
        f"{r_end - r_start:.3f} s on {card_line()}; the same image as the counted run:"
        f" {image_note(np, again, img)}")
    if not np.array_equal(again, img):
        raise PhaseError("the sketch-guided request is not bit-repeatable")
    stack.guided_image = img
    for label, kw in (("DDIM", dict(solver="ddim", sketch_image=sketch)),
                      ("text-to-image (no sketch)", {})):
        outs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe("a sketch of a house", num_inference_steps=REPEAT_STEPS, width=512,
                             height=512, seed=1234, **kw))
            torch.cuda.synchronize()
            outs.append(time.perf_counter() - t0)
        a, s_a, b, s_b = outs
        log(f"  {label} 512x512 B=1 {REPEAT_STEPS} steps, twice: {s_a:.3f} s, {s_b:.3f} s;"
            f" second against first: {image_note(np, b, a)}; std {a.std():.4f}")
        if a.shape != (512, 512, 3) or not np.isfinite(a).all() or a.std() == 0:
            raise PhaseError(f"{label}: not a finite, non-constant (512, 512, 3) image")
        if not np.array_equal(a, b):
            raise PhaseError(f"{label} request is not bit-repeatable")
    n_guided = num_guided_steps(steps)
    n_plain = steps - n_guided
    forwards = 2 * n_guided + n_plain
    expected = guided_expected(stack, gn, torch, steps)
    gn_total = sum(launches[k] for k in gn.LAUNCHES)
    log(f"  GroupNorm launches summed over variants {gn_total}"
        f" (expected {GN_UNET * forwards + GN_VAE_ENC + GN_VAE_DEC})")
    step_s = [b - a for a, b in zip(marks[:-1], marks[1:])]
    guided_s = step_s[: n_guided - 1]
    plain_s = step_s[n_guided - 1:]
    log(f"  sketch-guided 512x512 B=1 dpm++ {steps} steps ({n_guided} guided + {n_plain} plain):"
        f" total {end - start:.3f} s, to first step end {marks[0] - start:.3f} s,"
        f" guided step s median {np.median(guided_s):.4f} min {min(guided_s):.4f}"
        f" max {max(guided_s):.4f}, plain step s median {np.median(plain_s):.4f}"
        f" min {min(plain_s):.4f} max {max(plain_s):.4f}, decode {end - marks[-1]:.3f} s,"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finite = bool(np.isfinite(img).all())
    log(f"  image shape {img.shape} finite={finite} min={img.min():.4f} max={img.max():.4f}"
        f" mean={img.mean():.4f} std={img.std():.4f}")
    log(f"  launches {launches} expected {expected}")
    if img.shape != (512, 512, 3) or not finite or img.min() < 0 or img.max() > 1:
        raise PhaseError("e2e image is not a finite (512, 512, 3) image in [0, 1]")
    if launches != expected:
        raise PhaseError(f"launch counts {launches} != expected {expected}")
    if img.std() == 0:
        raise PhaseError("e2e image is constant")
    return launches


def run_inject(stack, fa, gn, torch) -> dict:
    """Batch-8 attention-injection request (config 5 of the JAX package's
    bench) with the safety checker on; its launch counts."""
    import numpy as np

    comps = stack.comps
    pipe = stack.inject
    comps.random_safety_checker(seed=2)
    try:
        prompts = [f"a sketch of a house, take {i}" for i in range(INJ_BATCH)]
        kw = dict(width=512, height=512, guidance_scale=7.5, strength=0.5,
                  spimg=sketch_image(np), seed=1234)
        pipe(prompts, num_inference_steps=2, **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gn)
        shapes, unwrap = record_forward_shapes(fa)
        start = time.perf_counter()
        try:
            img = pipe(prompts, num_inference_steps=INJ_STEPS, **kw)  # the counted run
            torch.cuda.synchronize()
        finally:
            unwrap()
        end = time.perf_counter()
        launches = counts(fa, gn)
        check_no_copies(fa, "injection request")
        check_tile_counts(fa, torch, "injection request", shapes)
        peak = torch.cuda.max_memory_allocated() / 2**30
        start2 = time.perf_counter()
        img2 = pipe(prompts, num_inference_steps=INJ_STEPS, **kw)
        torch.cuda.synchronize()
        end2 = time.perf_counter()
        flags = pipe.last_nsfw_flags
        b2 = 2 * INJ_BATCH
        with torch.no_grad():
            args = (torch.randn(b2, 4, 64, 64, device="cuda"),
                    torch.full((b2,), 500, dtype=torch.long, device="cuda"),
                    torch.randn(b2, 77, 768, device="cuda"))
            state = torch.randn(b2, VIT_TOKENS, pipe.clip_config.hidden_size, device="cuda")
            scale = torch.full((b2, 1, 1), 0.5, device="cuda")
            unet_ms = time_ms(lambda: pipe.unet(*args, injection_states=[state] * 16,
                                                injection_scale=scale), reps=5, warmup=1)
    finally:
        comps.safety_checker = None
    log(f"  inject request (clip injection 512x512 B={INJ_BATCH}, dpm++ {INJ_STEPS} steps,"
        f" guidance 7.5, strength 0.5, safety checker on): {end - start:.3f} s and"
        f" {end2 - start2:.3f} s ({(end2 - start2) / INJ_STEPS:.4f} s per step, encode and"
        f" decode included); injected UNet forward at B={b2}: {unet_ms:.2f} ms; peak memory"
        f" {peak:.2f} GiB; nsfw flags {flags.tolist()}; on {card_line()}")
    per_pass, _ = stack.gn_calls(gn, torch)
    expected = {"flash_fwd": INJ_STEPS * INJ_FLASH_SITES + 2 * VIT_LAYERS,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                **gn_launches(gn, [(per_pass["unet_inj_b16"], INJ_STEPS),
                                   (per_pass["vae_dec_b8"], 1)])}
    gn_total = sum(launches[k] for k in gn.LAUNCHES)
    log(f"  GroupNorm launches summed over variants {gn_total}"
        f" (expected {INJ_STEPS * GN_UNET + GN_VAE_DEC})")
    finite = bool(np.isfinite(img).all())
    log(f"  images shape {img.shape} finite={finite} min={img.min():.4f} max={img.max():.4f}"
        f" mean={img.mean():.4f} std={img.std():.4f}; the second run against the counted one:"
        f" {image_note(np, img2, img)}")
    log(f"  launches {launches} expected {expected}")
    if not np.array_equal(img, img2):
        raise PhaseError("the injection request is not bit-repeatable")
    if img.shape != (INJ_BATCH, 512, 512, 3) or not finite or img.min() < 0 or img.max() > 1:
        raise PhaseError(f"inject images are not finite ({INJ_BATCH}, 512, 512, 3) in [0, 1]")
    if img.std() == 0:
        raise PhaseError("inject images are constant")
    if launches != expected:
        raise PhaseError(f"launch counts {launches} != expected {expected}")
    return launches


# ---------------------------------------------------------------------------
# phases 5 and 6: the trainers
# ---------------------------------------------------------------------------


def train_config(stack, name: str) -> dict:
    """train.yaml's schema for a smoke run of one trainer: batch 4 at 512^2
    over the synthetic folder, AdamW at 2e-4, one epoch, its checkpoints
    and exports in a fresh build/chip_smoke/<name>/."""
    import shutil

    folder = os.path.join(SMOKE_DIR, name)
    shutil.rmtree(folder, ignore_errors=True)
    return {"name": name, "train_epochs": 1, "batch_size": TRAIN_BATCH, "resolution": 512,
            "seed": 1138,
            "dataset": {"img_path": [stack.images], "center_crop": False, "max_length": TRAIN_IDS,
                        "ucg": 0.0, "process_tags": True, "cache_latents": False},
            "optimizer": {"name": "adamw", "params": {"lr": 2e-4, "weight_decay": 1e-2,
                                                      "eps": 1e-8}},
            "checkpoint_dir": os.path.join(folder, "checkpoints"),
            "output_dir": os.path.join(folder, "out"), "checkpoint_every": 500, "log_every": 1}


def snapshot(modules) -> list:
    """Copies of every parameter and buffer of ``modules``."""
    return [t.detach().clone() for m in modules for t in m.state_dict().values()]


def check_frozen(modules, before, what: str) -> None:
    after = [t for m in modules for t in m.state_dict().values()]
    same = len(after) == len(before) and all(a.equal(b) for a, b in zip(after, before))
    log(f"  {what}: {len(before)} frozen tensors bit-identical after training: {same}")
    if not same:
        raise PhaseError(f"{what}: a frozen tensor changed")


def check_moved(named_before: dict, named_after: dict, what: str) -> None:
    still = [n for n, t in named_after.items() if t.equal(named_before[n])]
    log(f"  {what}: {len(named_after) - len(still)} of {len(named_after)} trainable tensors moved")
    if still or set(named_before) != set(named_after):
        raise PhaseError(f"{what}: tensors did not move: {still[:5]}")


def report_training(torch, what: str, result, launches: dict, expected: dict,
                    resident: int) -> None:
    """Losses finite, per-step times (the first step is the warm-up),
    images/s and the trainer's own peak memory (the peak less the
    ``resident`` bytes allocated before the call: models of earlier
    phases); launch counts against ``expected``."""
    import numpy as np

    losses, secs = result.losses, result.step_seconds
    counted = secs[1:]
    med = float(np.median(counted))
    log(f"  {what} losses {[round(x, 6) for x in losses]}; s/step (3 counted, after a"
        f" {secs[0]:.3f} s warm-up) median {med:.4f} min {min(counted):.4f} max"
        f" {max(counted):.4f}; images/s {TRAIN_BATCH / med:.2f}; peak memory of the trainer"
        f" {(torch.cuda.max_memory_allocated() - resident) / 2**30:.2f} GiB (above"
        f" {resident / 2**30:.2f} GiB resident before it); on {card_line()}")
    log(f"  launches {launches} expected {expected}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise PhaseError(f"{what}: {len(losses)} steps, losses {losses}")
    if launches != expected:
        raise PhaseError(f"{what}: launch counts {launches} != expected {expected}")


class TrainerStep:
    """One step of a trainer at batch 4, 512^2 (its library step function,
    as the app runs it) from the same start every call: seeded fresh
    trainables, a fresh AdamW (train.yaml's), a seeded random batch and
    the same draw generator. ``run()`` steps and returns the trainables'
    and the optimizer's state after it."""

    def __init__(self, stack, torch, which: str):
        from sketch2img_torch.apps.train_attn_inject import injected_unet
        from sketch2img_torch.models.lgp import LatentEdgePredictor
        from sketch2img_torch.models.unet import tap_channels
        from sketch2img_torch.train.train_attn_inject import inject_train_step, mark_trainables
        from sketch2img_torch.train.train_lgp import Frozen, lgp_train_step

        self.torch = torch
        comps, gan = stack.comps, stack.gan
        gen = torch.Generator(device="cuda").manual_seed(13)
        batch = {"input_ids": torch.randint(0, 49406, (TRAIN_BATCH, TRAIN_IDS), generator=gen,
                                            device="cuda"),
                 "pixels": torch.rand(TRAIN_BATCH, 3, 512, 512, generator=gen,
                                      device="cuda") * 2 - 1}
        if which == "lgp":
            with torch.random.fork_rng(devices=[torch.cuda.current_device()]), \
                    torch.device("cuda"):
                torch.manual_seed(7)
                lgp = LatentEdgePredictor(input_dim=tap_channels(comps.unet.config) + 4 + 36)
            self.state = lgp.state_dict()  # parameters and BatchNorm statistics
            frozen = Frozen(comps.unet, comps.vae, comps.text_encoder, gan, comps.schedule)
            self.params = list(lgp.parameters())
            self.step = lambda opt, g: lgp_train_step(lgp, opt, frozen, batch, generator=g,
                                                      sketch_fixed_size=1024)
        else:
            clip = stack.vit()
            unet = injected_unet(comps, clip.config.hidden_size, 0)
            self.state = mark_trainables(unet, clip)
            frozen = Frozen(None, comps.vae, comps.text_encoder, gan, comps.schedule)
            self.params = list(self.state.values())
            self.step = lambda opt, g: inject_train_step(unet, clip, opt, frozen, batch,
                                                         generator=g, sketch_fixed_size=512)
        self.start = {k: v.detach().clone() for k, v in self.state.items()}

    def run(self) -> dict:
        from sketch2img_torch.train.optim import make_optimizer

        torch = self.torch
        with torch.no_grad():
            for k, v in self.state.items():
                v.copy_(self.start[k])
        opt = make_optimizer("adamw", self.params, 2e-4, weight_decay=1e-2, eps=1e-8)
        loss = self.step(opt, torch.Generator(device="cuda").manual_seed(33))
        return {"loss": loss, "trainables": {k: v.detach().clone() for k, v in self.state.items()},
                "optimizer": opt.state_dict()}


def step_twice(stack, torch, which: str, label: str) -> None:
    """One step of the trainer twice from the same state and draws: loss,
    trainables and optimizer state bit-identical; then the step under
    PyTorch's warn-only deterministic mode (``probe``)."""
    trainer = TrainerStep(stack, torch, which)
    a, b = trainer.run(), trainer.run()
    same = {key: same_state(torch, a[key], b[key]) for key in a}
    log(f"  {label} step (B={TRAIN_BATCH}, AdamW) twice from the same state and draws, bit for"
        f" bit: {same}; loss {float(a['loss']):.6f}")
    if not all(same.values()):
        raise PhaseError(f"{label} step is not bit-repeatable: {same}")
    del a, b
    probe(torch, f"{label} step", trainer.run)
    del trainer
    torch.cuda.empty_cache()


def run_train_lgp(stack, fa, gn, torch) -> dict:
    """The LGP trainer for four steps through ``train_lgp``, from LGP
    weights saved here (so that every LGP tensor can be held to its start);
    then the last checkpoint restored and held to the trained state."""
    from sketch2img_torch.apps.train_lgp import train_lgp
    from sketch2img_torch.models.lgp import LatentEdgePredictor
    from sketch2img_torch.models.unet import tap_channels
    from sketch2img_torch.train.checkpoint import restore_train_state

    comps, gan = stack.comps, stack.gan
    cfg = train_config(stack, "train_lgp")
    frozen = [comps.unet, comps.vae, comps.text_encoder, gan]
    before = snapshot(frozen)
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]), torch.device("cuda"):
        torch.manual_seed(7)
        lgp0 = LatentEdgePredictor(input_dim=tap_channels(comps.unet.config) + 4 + 36)
    start = {n: t.detach().clone() for n, t in lgp0.state_dict().items()}
    weights = os.path.join(SMOKE_DIR, "train_lgp", "lgp0.pt")
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    torch.save(lgp0.state_dict(), weights)
    del lgp0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_counts(fa, gn)
    result = train_lgp(cfg, comps, gan, max_steps=TRAIN_STEPS, network_weights=weights,
                       sketch_fixed_size=1024, device="cuda", log=lambda m: log("  " + m))
    torch.cuda.synchronize()
    launches = counts(fa, gn)  # the counted run: the trainer's four steps
    check_no_copies(fa, "LGP trainer")
    per_pass, _ = stack.gn_calls(gn, torch)
    expected = {"flash_fwd": LGP_FLASH_FWD * TRAIN_STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                **gn_launches(gn, [(per_pass["unet_b4"], TRAIN_STEPS),
                                   (per_pass["vae_enc_b4"], 2 * TRAIN_STEPS)])}
    report_training(torch, "LGP trainer (SD1.5 512^2 B=4, sketches at 1024^2, uncached)",
                    result, launches, expected, resident)
    lgp, opt = result.modules["lgp"], result.modules["optimizer"]
    check_moved(start, lgp.state_dict(), "LGP (parameters and BatchNorm buffers)")
    check_frozen(frozen, before, "UNet, VAE, text encoder, anime2sketch")
    saved = restore_train_state(result.checkpoint, map_location="cuda")
    same = (saved["step"] == TRAIN_STEPS
            and all(saved["lgp"][n].equal(t) for n, t in lgp.state_dict().items())
            and same_state(torch, saved["optimizer"], opt.state_dict()))
    log(f"  checkpoint {os.path.basename(result.checkpoint)} restored equal to the trained"
        f" state (step, LGP, optimizer): {same}; exports"
        f" {[os.path.basename(e) for e in result.exports]}")
    if not same:
        raise PhaseError("the LGP checkpoint does not restore the trained state")
    if [os.path.basename(e) for e in result.exports] != ["edge_predictor.npz"]:
        raise PhaseError(f"the LGP trainer's one epoch exported {result.exports}")
    from sketch2img_torch.core.convert import lgp_from_jax, load_params_npz

    tree = load_params_npz(result.exports[0])
    back = lgp_from_jax(tree["params"], tree["batch_stats"])
    same = all(back[n].equal(t.cpu()) for n, t in lgp.state_dict().items()
               if not n.endswith("num_batches_tracked"))
    log(f"  edge_predictor.npz (the JAX package's tree) read back equal to the trained LGP: {same}")
    if not same:
        raise PhaseError("edge_predictor.npz does not hold the trained LGP")
    del result, lgp, opt, saved
    step_twice(stack, torch, "lgp", "LGP trainer")
    return launches


def same_state(torch, a, b) -> bool:
    """Nested dicts/lists of tensors and numbers, equal leaf for leaf."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_state(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.cpu().equal(b.cpu())
    return a == b


def run_train_inject(stack, fa, gn, torch) -> dict:
    """The injection trainer for four steps through ``train_attn_inject``
    (fresh injection blocks and a fresh ViT-L/14), then one step's gradient
    through the kernels against the plain routes."""
    from sketch2img_torch.apps.train_attn_inject import injected_unet, train_attn_inject

    comps, gan = stack.comps, stack.gan
    cfg = train_config(stack, "train_inject")
    frozen = [comps.unet, comps.vae, comps.text_encoder, gan]
    before = snapshot(frozen)
    clip = stack.vit()
    start = {"clip." + n: t.detach().clone() for n, t in clip.state_dict().items()
             if not n.startswith("vision_model.post_layernorm.")}
    sat0 = injected_unet(comps, clip.config.hidden_size, cfg["seed"]).sat  # what the trainer draws
    start.update({"sat." + n: t.detach().clone() for n, t in sat0.state_dict().items()})
    del sat0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_counts(fa, gn)
    result = train_attn_inject(cfg, comps, gan, clip, max_steps=TRAIN_STEPS, sketch_fixed_size=512,
                               device="cuda", log=lambda m: log("  " + m))
    torch.cuda.synchronize()
    launches = counts(fa, gn)  # the counted run: the trainer's four steps
    check_no_copies(fa, "injection trainer")
    per_pass, _ = stack.gn_calls(gn, torch)
    expected = {"flash_fwd": INJ_TRAIN_FWD * TRAIN_STEPS,
                "flash_bwd_dq": INJ_TRAIN_BWD * TRAIN_STEPS,
                "flash_bwd_dkv": INJ_TRAIN_BWD * TRAIN_STEPS,
                **gn_launches(gn, [(per_pass["unet_inj_b4"], TRAIN_STEPS),
                                   (per_pass["vae_enc_b4"], TRAIN_STEPS)])}
    report_training(torch, "injection trainer (SD1.5 512^2 B=4, ViT-L/14 and injection blocks"
                    " trained, sketches at 512^2)", result, launches, expected, resident)
    unet, clip = result.modules["unet"], result.modules["clip"]
    after = {"clip." + n: t for n, t in clip.state_dict().items()
             if not n.startswith("vision_model.post_layernorm.")}
    after.update({"sat." + n: t for n, t in unet.sat.state_dict().items()})
    check_moved(start, after, "injection blocks and ViT-L/14")
    check_frozen(frozen, before, "base UNet, VAE, text encoder, anime2sketch")
    del before, start, after
    inject_grad_check(stack, gn, torch, unet, clip)
    del result, unet, clip
    step_twice(stack, torch, "inject", "injection trainer")
    return launches


def inject_grad_check(stack, gn, torch, unet, clip, batch: int = 2) -> None:
    """One step's gradient of the injection loss w.r.t. every trainable,
    through the kernels and through the plain attention and GroupNorm routes
    on the same inputs (``batch`` images: the plain attention keeps its
    (B, 8, 4096, 4480) weights for the backward), held by their cosine."""
    from sketch2img_torch.train.train_attn_inject import inject_inputs, inject_loss
    from sketch2img_torch.train.train_lgp import Frozen

    comps = stack.comps
    frozen = Frozen(None, comps.vae, comps.text_encoder, stack.gan, comps.schedule)
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = {"input_ids": torch.randint(0, 49406, (batch, TRAIN_IDS), generator=gen, device="cuda"),
            "pixels": torch.rand(batch, 3, 512, 512, generator=gen, device="cuda") * 2 - 1}
    inputs = inject_inputs(frozen, data, generator=gen)
    params = [p for p in list(unet.sat.parameters()) + list(clip.parameters()) if p.requires_grad]

    def grads():
        loss = inject_loss(unet, clip, *inputs)
        flat = torch.cat([g.flatten().float() for g in torch.autograd.grad(loss, params)])
        return float(loss.detach()), flat

    loss_k, g_k = grads()
    with plain_attention_route(), plain_groupnorm_route(gn):
        loss_p, g_p = grads()
    cos = float(torch.nn.functional.cosine_similarity(g_k, g_p, dim=0))
    rel = float((g_k - g_p).norm() / g_p.norm())
    ok = cos >= TRAIN_GRAD_COS and abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    log(f"  injection step at B={batch}, kernels vs plain attention and GroupNorm: loss"
        f" {loss_k:.6f} vs {loss_p:.6f}, gradient cosine over {g_k.numel()} trainable values"
        f" {cos:.5f} (tol {TRAIN_GRAD_COS}), relative L2 difference {rel:.3e} ok={ok}")
    if not ok:
        raise PhaseError("the injection step's gradient through the kernels disagrees with the "
                         "plain routes")


# ---------------------------------------------------------------------------
# phases 7 and 8: the HTTP server and the apps
# ---------------------------------------------------------------------------


def png_b64(np, img) -> str:
    """A uint8 image, or a [0, 1] one, as a base64 PNG."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img if img.dtype == np.uint8 else to_uint8(np, img)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def decode_png(np, data: bytes):
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def to_uint8(np, img01):
    """A [0, 1] image as the server encodes it."""
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


def image_diff(np, got, want01) -> tuple:
    """uint8 image against a [0, 1] one: (max and mean |difference| in uint8
    levels, share of values off at all, share more than 16 levels off)."""
    d = np.abs(got.astype(np.int16) - to_uint8(np, want01).astype(np.int16))
    return int(d.max()), float(d.mean()), float((d > 0).mean()), float((d > 16).mean())


def image_note(np, got01, want01) -> str:
    """Two [0, 1] images: bit-identical, or how far apart in uint8 levels."""
    if np.array_equal(got01, want01):
        return "bit-identical"
    mx, mean, off, far = image_diff(np, to_uint8(np, got01), want01)
    return f"max {mx}, mean {mean:.4f} levels, {100 * off:.4f}% off, {100 * far:.4f}% > 16"


def check_served_image(np, got, want01, what: str) -> None:
    """A served uint8 image: SERVE_PX^2 RGB (or the size asked), not
    constant, and bit-identical to the direct pipeline call that makes the
    same call (same prompts, seeds, sketches, batch)."""
    if got.shape != want01.shape or got.dtype != np.uint8 or got.std() == 0:
        raise PhaseError(f"{what}: served image {got.shape} {got.dtype} std {got.std()}")
    if not np.array_equal(got, to_uint8(np, want01)):
        mx, mean, off, far = image_diff(np, got, want01)
        raise PhaseError(f"{what}: served image differs from the direct call: max {mx}, mean"
                         f" {mean:.4f} levels, {100 * off:.4f}% off, {100 * far:.4f}% > 16")


def merge_gap(np, got, solo01) -> tuple:
    """How far a merged request's image is from its request run alone (batch
    1): (note, within the JAX test's bound)."""
    mx, mean, off, _ = image_diff(np, got, solo01)
    within = mx <= MERGE_MAX_LEVELS and off < MERGE_MAX_SHARE
    return (f"max {mx}, mean {mean:.4f} levels, {100 * off:.4f}% of values off (within the"
            f" JAX bound of {MERGE_MAX_LEVELS} level and {100 * MERGE_MAX_SHARE:g}%: {within})",
            within)


def run_serve(stack, fa, gn, torch) -> dict:
    """The port's HTTP server in-process on 127.0.0.1 (a free port), with
    the sketch-guided pipeline and the injection pipeline over the same
    components, micro-batching on (window ``SERVE_WINDOW_MS``, batches of
    2), warmed at SERVE_PX^2: a 50-step sketch-guided PNG request (counted,
    and timed against the direct call), a JSON prompt list with per-image
    seeds, two concurrent requests that merge (at the JAX test's setting,
    at SERVE_STEPS and at 50 steps), an SSE stream with previews, an inject
    request with strength and seed lists and a bad solver; every image
    bit-identical to the direct call that makes the same pipeline call; each
    merged one against its request alone (a measurement, and the JAX
    bound at its own setting)."""
    import http.client
    import json as _json
    import threading

    import numpy as np

    from sketch2img_torch.apps import serve
    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps, inj = stack.comps, stack.inject
    pipe = SketchGuidedPipeline(comps)
    px = SERVE_PX
    sketch = sketch_image(np, px)
    other = np.zeros((px, px), np.float32)
    for k in range(-px // 80, px // 80 + 1):  # a diagonal stroke
        idx = np.arange(px // 12, px - px // 12)
        other[idx, np.clip(idx + k, 0, px - 1)] = 1.0
    srv = serve.make_server(pipe, "127.0.0.1", 0, batch_window_ms=SERVE_WINDOW_MS, max_batch=2,
                            inject_pipe=inj)
    thread = threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True)
    thread.start()

    def post(body, path="/generate"):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port, timeout=600)
        conn.request("POST" if body is not None else "GET", path,
                     body=_json.dumps(body) if body is not None else None)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        if resp.getheader("Content-Type") == "application/json":
            data = _json.loads(data)
        return resp.status, resp.getheader("Content-Type"), data

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def direct(prompt, seed, sk, steps=SERVE_STEPS, size=px):
        return pipe(prompt, num_inference_steps=steps, width=size, height=size, seed=seed,
                    sketch_image=sk)

    def direct_inj(prompt, seed, strength, steps=SERVE_STEPS):
        return inj(prompt, num_inference_steps=steps, width=px, height=px, seed=seed,
                   strength=strength, spimg=sketch)

    def merged(bodies):
        """Two concurrent single-prompt requests -> (their images, seconds),
        checked to have merged into one batcher call."""
        calls0, results = srv.handler_class.batcher.calls, [None, None]

        def fire(i):
            results[i] = post(bodies[i])

        def pair():
            threads = [threading.Thread(target=fire, args=(i,)) for i in range(2)]
            threads[0].start()
            time.sleep(0.02)
            threads[1].start()
            for t in threads:
                t.join(600)

        _, secs = timed(pair)
        n_calls = srv.handler_class.batcher.calls - calls0
        if [r[0] for r in results] != [200, 200] or n_calls != 1:
            raise PhaseError(f"the two requests did not merge: statuses {[r[0] for r in results]},"
                             f" {n_calls} batcher calls")
        return [decode_png(np, _b64(r[2]["images"][0])) for r in results], secs

    try:
        _, warm_s = timed(lambda: serve.warmup(srv, [(px, px, 2)]))
        log(f"  server up on 127.0.0.1:{srv.server_port} (window {SERVE_WINDOW_MS} ms, batches of"
            f" 2, inject route on); warmup at {px}^2 (2 steps, batch 1 and 2, text, sketch and"
            f" inject): {warm_s:.2f} s")
        sk_b64, other_b64 = png_b64(np, sketch), png_b64(np, other)
        base = {"width": px, "height": px, "prompt": "a sketch of a house"}

        # 1. the 50-step request, in a handler thread (a seed list bypasses the batcher)
        body = {**base, "num_inference_steps": 50, "seed": [1234], "sketch_png_b64": sk_b64}
        reset_counts(fa, gn)
        (status, kind, data), served_s = timed(lambda: post(body))
        launches = counts(fa, gn)
        check_no_copies(fa, "served 50-step request")
        if status != 200 or kind != "image/png":
            raise PhaseError(f"50-step request: {status} {kind} {data!r:.200}")
        want, direct_s = timed(lambda: direct(base["prompt"], [1234], sketch, 50))
        first50 = want
        (_, _, data2), served2_s = timed(lambda: post(body))
        again, direct2_s = timed(lambda: direct(base["prompt"], [1234], sketch, 50))
        check_served_image(np, decode_png(np, data), want, "50-step request")
        check_served_image(np, decode_png(np, data2), want, "50-step request, again")
        if not np.array_equal(again, want):
            raise PhaseError(f"the direct 50-step call is not bit-repeatable:"
                             f" {image_note(np, again, want)}")
        expected = guided_expected(stack, gn, torch, 50)
        log(f"  served 50-step sketch-guided {px}x{px} request (PNG, handler thread), served then"
            f" direct, twice: {served_s:.3f} s, {direct_s:.3f} s, {served2_s:.3f} s,"
            f" {direct2_s:.3f} s (served less direct {served_s - direct_s:+.3f} /"
            f" {served2_s - direct2_s:+.3f} s: HTTP, PNG and handler); both served images"
            f" bit-identical to the direct call, the direct call to itself; on {card_line()}")
        log(f"  served request launches {launches} expected {expected}")
        if launches != expected:
            raise PhaseError(f"served request launch counts {launches} != expected {expected}")

        # 2. a prompt list with per-image seeds, JSON, one sketch for both
        body = {**base, "prompt": ["a house", "a tree"], "seed": [11, 22], "response": "json",
                "num_inference_steps": SERVE_STEPS, "sketch_png_b64": sk_b64}
        (status, _, data), list_s = timed(lambda: post(body))
        if status != 200 or len(data["images"]) != 2:
            raise PhaseError(f"prompt-list request: {status} {str(data)[:200]}")
        want = direct(body["prompt"], body["seed"], sketch)
        for i, im in enumerate(data["images"]):
            check_served_image(np, decode_png(np, _b64(im)), want[i], f"prompt list image {i}")
        log(f"  served prompt list (B=2, seeds [11, 22], {SERVE_STEPS} steps, JSON):"
            f" {list_s:.3f} s; nsfw {data['nsfw']}; both images bit-identical to the direct call")

        # 3. two concurrent single-prompt requests with different sketches merge into
        # one batch-2 call: at the JAX test's setting, at SERVE_STEPS and at 50 steps
        rng = np.random.default_rng(0)
        noise = [rng.integers(0, 256, (MERGE_JAX_PX, MERGE_JAX_PX), dtype=np.uint8)
                 for _ in range(2)]
        settings = {
            MERGE_JAX_STEPS: (MERGE_JAX_PX, [("a cat", 11, noise[0]), ("a dog", 22, noise[1])]),
            SERVE_STEPS: (px, [("a house", 31, sketch), ("a tree", 32, other)]),
            50: (px, [(base["prompt"], 1234, sketch), ("a tree", 32, other)]),
        }
        for steps, (size, reqs) in settings.items():
            sketches = [k.astype(np.float32) / 255.0 if k.dtype == np.uint8 else k
                        for _, _, k in reqs]
            bodies = [{"prompt": p, "seed": sd, "width": size, "height": size, "response": "json",
                       "num_inference_steps": steps, "sketch_png_b64": png_b64(np, k)}
                      for (p, sd, k) in reqs]
            got, pair_s = merged(bodies)
            held = "not held to the direct batch-2 call (the shorter settings are)"
            if steps != 50:
                want = direct([p for p, _, _ in reqs], [sd for _, sd, _ in reqs], sketches,
                              steps, size)
                for i, g in enumerate(got):
                    check_served_image(np, g, want[i], f"merged image {i} ({steps} steps)")
                held = "both bit-identical to the direct batch-2 call"
            solo = [timed(lambda p=p, sd=sd, k=k: direct(p, [sd], [k], steps, size))
                    if (steps, sd) != (50, 1234) else (first50, direct_s)
                    for (p, sd, _), k in zip(reqs, sketches)]
            gaps = [merge_gap(np, g, so[0]) for g, (so, _) in zip(got, solo)]
            log(f"  two concurrent requests ({steps} steps, {size}^2, different sketches) merged"
                f" into one batch-2 call: {pair_s:.3f} s for both, {pair_s / 2:.3f} s an image,"
                f" against solo direct calls of {solo[0][1]:.3f} and {solo[1][1]:.3f} s; {held};"
                f" each against its request alone: {[note for note, _ in gaps]}"
                f"{'; the JAX test setting' if steps == MERGE_JAX_STEPS else ''}")
        _, _, metrics = post(None, "/metrics")
        if "2" not in metrics["batch_sizes"]:
            raise PhaseError(f"no batch of 2 in /metrics: {metrics['batch_sizes']}")

        # 4. an SSE stream with latent previews
        body = {**base, "seed": 41, "stream": True, "preview": True, "progress_every": 2,
                "num_inference_steps": SERVE_STEPS, "sketch_png_b64": sk_b64}
        (status, kind, raw), sse_s = timed(lambda: post(body))
        events = [dict(line.split(": ", 1) for line in block.split("\n"))
                  for block in raw.decode().strip().split("\n\n")]
        kinds = [e["event"] for e in events]
        progress = [_json.loads(e["data"]) for e in events if e["event"] == "progress"]
        if (status != 200 or kind != "text/event-stream"
                or kinds != ["progress"] * (SERVE_STEPS // 2) + ["result"]):
            raise PhaseError(f"SSE stream: {status} {kind} events {kinds}")
        sizes = {decode_png(np, _b64(p["previews"][0])).shape for p in progress}
        if (sizes != {(px // 8, px // 8, 3)}
                or [p["step"] for p in progress] != list(range(1, SERVE_STEPS, 2))):
            raise PhaseError(f"SSE progress events: steps {[p['step'] for p in progress]},"
                             f" preview shapes {sizes}")
        result = _json.loads(events[-1]["data"])
        check_served_image(np, decode_png(np, _b64(result["images"][0])),
                           direct(base["prompt"], 41, sketch), "SSE result")
        log(f"  SSE stream ({SERVE_STEPS} steps, progress every 2, previews): {sse_s:.3f} s,"
            f" {len(progress)} progress events (steps {[p['step'] for p in progress]}, previews"
            f" {sorted(sizes)}), result bit-identical to the direct call")

        # 5. the inject route, strength and seed lists
        body = {**base, "mode": "inject", "prompt": ["a house", "a tree"], "seed": [51, 52],
                "strength": [0.3, 0.8], "response": "json", "num_inference_steps": SERVE_STEPS,
                "sketch_png_b64": sk_b64}
        (status, _, data), inj_s = timed(lambda: post(body))
        if status != 200 or len(data["images"]) != 2 or data["nsfw"] is not None:
            raise PhaseError(f"inject request: {status} {str(data)[:200]}")
        got = [decode_png(np, _b64(im)) for im in data["images"]]
        want = direct_inj(body["prompt"], body["seed"], body["strength"])
        for i, g in enumerate(got):
            check_served_image(np, g, want[i], f"inject image {i}")
        notes = [merge_gap(np, g, direct_inj(p, [sd], [st]))[0]
                 for g, p, sd, st in zip(got, body["prompt"], body["seed"], body["strength"])]
        log(f"  served inject request (B=2, strengths [0.3, 0.8], seeds [51, 52], {SERVE_STEPS}"
            f" steps): {inj_s:.3f} s; nsfw null; both images bit-identical to the direct call;"
            f" each against its image alone: {notes}")

        # 6. a bad solver
        status, _, data = post({**base, "solver": "euler", "num_inference_steps": 2})
        _, _, metrics = post(None, "/metrics")
        log(f"  bad solver: {status} {data}; /metrics {metrics}")
        if status != 400 or metrics["errors"] != 0 or metrics["pending"] != 0:
            raise PhaseError(f"bad solver answered {status}; metrics {metrics}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    log(f"  server shut down (serving thread alive: {thread.is_alive()})")
    if thread.is_alive():
        raise PhaseError("the serving thread did not stop")
    return launches


def _b64(text: str) -> bytes:
    import base64

    return base64.b64decode(text)


def run_apps(stack, fa, gn, torch) -> dict:
    """The apps' library entry points at 512^2 on the full-width stack:
    ``app.inference`` (the demo's callback, a uint8 sketchpad,
    ``APP_STEPS`` steps), ``evaluation.evaluate`` (one t=100 pass with taps
    on a synthetic picture) and ``pic2sketch`` (the full-width generator at
    load_size 512); each one's time and launch counts."""
    import numpy as np
    from PIL import Image

    from sketch2img_torch.apps import app, evaluation, pic2sketch
    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps = stack.comps
    per_pass, _ = stack.gn_calls(gn, torch)
    picture = Image.open(sorted(os.path.join(stack.images, f) for f in os.listdir(stack.images)
                                if f.endswith(".png"))[0]).convert("RGB")
    pad = (sketch_image(np, SERVE_PX) * 255).astype(np.uint8)
    px = SERVE_PX
    square = np.asarray(picture.resize((px, px), Image.LANCZOS), np.float32) / 255.0
    runs = {
        "app": (lambda: app.inference(SketchGuidedPipeline(comps), "a sketch of a house", 7.5,
                                      APP_STEPS, px, px, 77, 0.5, "", pad),
                guided_expected(stack, gn, torch, APP_STEPS)),
        "evaluate": (lambda: evaluation.evaluate(comps, "1girl, masterpiece", "bad quality",
                                                 square, 100, seed=5),
                     {"flash_fwd": FWD_SITES, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                      **gn_launches(gn, [(per_pass["vae_enc_b1"], 1), (per_pass["unet_b1"], 1),
                                         (per_pass["vae_dec_b1"], 1)])}),
        "pic2sketch": (lambda: pic2sketch.pic2sketch(stack.gan, picture, load_size=px),
                       {name: 0 for name in counts(fa, gn)}),
    }
    def pixels(result):
        return np.asarray(result[0] if isinstance(result, tuple) else result)

    out = {}
    for name, (fn, expected) in runs.items():
        first = pixels(fn())  # warm-up
        torch.cuda.synchronize()
        reset_counts(fa, gn)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = launches = counts(fa, gn)
        if name == "app":
            img, err = result
            ok = img.shape == (px, px, 3) and img.dtype == np.uint8 and err is None
            what = f"uint8 image {img.shape}, mean {img.mean():.2f}, std {img.std():.2f}"
            ok = ok and img.std() > 0
        elif name == "evaluate":
            img = result
            kept = img[img > 0]
            ok = (img.shape == (px, px, 3) and img.dtype == np.uint8
                  and (kept.size == 0 or kept.min() >= 127))
            what = f"edge image {img.shape}, {100 * (img > 0).mean():.2f}% kept (>= 0.5)"
        else:
            arr = np.asarray(result)
            ok = result.size == picture.size and result.mode == "RGB" and arr.std() > 0
            what = f"sketch {result.size} {result.mode}, {100 * (arr < 128).mean():.2f}% strokes"
        same = bool(np.array_equal(pixels(result), first))
        log(f"  apps {name}: {secs:.3f} s ({what}); bit-identical to the warm-up call: {same};"
            f" launches {launches} expected {expected}; on {card_line()}")
        if not ok:
            raise PhaseError(f"apps {name}: {what}")
        if not same:
            raise PhaseError(f"apps {name}: not bit-repeatable")
        if launches != expected:
            raise PhaseError(f"apps {name}: launch counts {launches} != expected {expected}")
    return out

# ---------------------------------------------------------------------------
# phase 9: remat
# ---------------------------------------------------------------------------


def guided_inputs(pipe, torch, batch: int = 1, px: int = 512, seed: int = 1):
    """Seeded inputs of one guided UNet pass at ``batch`` x ``px``^2: the
    latent, t = 801, the prompt's context and an LGP target."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = px // 8
    x = torch.randn(batch, 4, h, h, generator=gen, device="cuda")
    target = torch.randn(batch, 4, h, h, generator=gen, device="cuda") * 0.2
    t = torch.full((batch,), 801, dtype=torch.long, device="cuda")
    _, ctx = pipe.encode_prompt(["a house"] * batch)
    return x, t, ctx, target


def calibration_rows(stack, torch) -> list:
    """``core/memory.CALIBRATION_CASES`` measured on this card: one guided
    step of the sampling call each (``measure_guided_gib``), printed as
    calibration rows beside the committed row and the fitted estimate."""
    from sketch2img_torch.core import memory
    from sketch2img_torch.runtime import SketchGuidedPipeline

    pipe = SketchGuidedPipeline(stack.comps)
    committed = {(s, b, r): t for s, b, r, t in memory.CALIBRATION}
    rows = []
    for size, batch, remat in memory.CALIBRATION_CASES:
        t0 = time.perf_counter()
        try:
            total = memory.measure_guided_gib(pipe, size, batch, remat)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            log(f"  calibration case ({size}, {batch}, {remat}): out of memory")
            continue
        rows.append((size, batch, remat, round(total, 3)))
        log(f"  calibration row ({size}, {batch}, {remat}, {total:.3f}),  # "
            f"{time.perf_counter() - t0:.1f} s; committed {committed.get((size, batch, remat))},"
            f" estimate {memory.estimate_guided_gib(batch, size, size, remat):.3f} GiB")
    if rows:
        bases, slopes = memory.fit_from_calibration(rows)
        log(f"  fit of the measured rows: base {bases} slope {slopes} (GiB, GiB per latent"
            f" megapixel); on {card_line()}, total memory {memory.device_hbm_gib():.2f} GiB")
    torch.cuda.empty_cache()
    return rows


def run_remat(stack, fa, gn, torch) -> dict:
    """Remat against no remat in one guided pass and a 50-step request, the
    calibration rows, and a request the calibration flags."""
    import numpy as np

    from sketch2img_torch.core import memory
    from sketch2img_torch.pipelines.sketch_guided import num_guided_steps
    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps = stack.comps
    pipe = SketchGuidedPipeline(comps)
    per_pass, _ = stack.gn_calls(gn, torch)
    x, t, ctx, target = guided_inputs(pipe, torch)

    def one_pass(remat):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_counts(fa, gn)
        eps, g = guided_pass(comps, torch, x, t, ctx, target, remat=remat)
        torch.cuda.synchronize()
        return eps, g, counts(fa, gn), (torch.cuda.max_memory_allocated() - resident) / 2**30

    for remat in (False, True):  # warm-up: cuDNN's plans
        guided_pass(comps, torch, x, t, ctx, target, remat=remat)
    e0, g0, c0, m0 = one_pass(False)
    e1, g1, c1, m1 = one_pass(True)
    want = {}
    for remat in (False, True):
        want[remat] = {"flash_fwd": FWD_SITES + (REMAT_FWD_SITES if remat else 0),
                       "flash_bwd_dq": BWD_SITES, "flash_bwd_dkv": BWD_SITES,
                       **gn_launches(gn, [(per_pass["unet_b1"], 1),
                                          (per_pass["unet_b1"][:REMAT_GN], int(remat))])}
    g_cos = float(torch.nn.functional.cosine_similarity(g0.flatten(), g1.flatten(), dim=0))
    g_rel = float((g0 - g1).abs().max() / g0.abs().max())
    log(f"  guided pass 512^2 B=1, remat on vs off: eps bit-identical {e0.equal(e1)}, gradient"
        f" bit-identical {g0.equal(g1)}, cosine {g_cos:.6f} (gate 0.98, the e2e phase's), max"
        f" diff {g_rel:.3e} of max|grad|;"
        f" peak memory above resident {m0:.3f} GiB off, {m1:.3f} GiB on;"
        f" launches off {c0} (expected {want[False]}), on {c1} (expected {want[True]})")
    if not e0.equal(e1) or g_cos < 0.98:
        raise PhaseError("remat changes the guided pass's eps or gradient")
    if c0 != want[False] or c1 != want[True]:
        raise PhaseError(f"guided pass launches {c0} / {c1} != {want[False]} / {want[True]}")

    sketch = sketch_image(np)

    def request(steps, remat, count=False, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        if count:
            reset_counts(fa, gn)
        t0 = time.perf_counter()
        img = pipe(kw.pop("prompt", "a sketch of a house"), num_inference_steps=steps,
                   sketch_image=sketch, remat=remat, **{"seed": 1234, "width": 512,
                                                         "height": 512, **kw})
        torch.cuda.synchronize()
        return (img, time.perf_counter() - t0, counts(fa, gn) if count else None,
                (torch.cuda.max_memory_allocated() - resident) / 2**30)

    request(2, True)  # warm-up
    steps = 50
    img0, s0, _, p0 = request(steps, False)
    img1, s1, c_req, p1 = request(steps, True, count=True)
    img2, s2, _, _ = request(steps, True)
    expected = guided_expected(stack, gn, torch, steps, remat=True)
    n_guided = num_guided_steps(steps)
    e2e = stack.guided_image
    log(f"  sketch-guided 512x512 B=1 {steps} steps: remat=False {s0:.3f} s (peak {p0:.3f} GiB"
        f" above resident), remat=True {s1:.3f} s and {s2:.3f} s (peak {p1:.3f} GiB): remat"
        f" costs {s1 - s0:+.3f} s, {(s1 - s0) / n_guided * 1e3:+.2f} ms a guided step; remat=True"
        f" twice: {image_note(np, img2, img1)}; remat=False against the e2e request:"
        f" {image_note(np, img0, e2e) if e2e is not None else 'no e2e run'};"
        f" remat on against off: {image_note(np, img1, img0)}; on {card_line()}")
    log(f"  remat request launches {c_req} expected {expected}")
    if c_req != expected:
        raise PhaseError(f"remat request launches {c_req} != expected {expected}")
    if not np.array_equal(img1, img2) or (e2e is not None and not np.array_equal(img0, e2e)):
        raise PhaseError("the 50-step request is not bit-repeatable with or without remat")
    if img1.shape != (512, 512, 3) or not np.isfinite(img1).all():
        raise PhaseError("remat request image is not a finite (512, 512, 3) image")

    calibration_rows(stack, torch)

    budget = memory.device_hbm_gib()
    batch = next(b for b in range(1, 1025) if memory.choose_remat(b, 512, 512, budget_gib=budget))
    seeds = list(range(1, batch + 1))
    img, secs, _, peak = request(REMAT_STEPS, None, prompt=["a sketch of a house"] * batch,
                                 seed=seeds)
    log(f"  smallest 512^2 batch the calibration flags on {budget:.2f} GiB: {batch}"
        f" (estimate without remat {memory.estimate_guided_gib(batch, 512, 512, False):.2f} GiB"
        f" > {0.92 * budget:.2f}, with {memory.estimate_guided_gib(batch, 512, 512, True):.2f});"
        f" {REMAT_STEPS}-step request with remat=None: last_remat {pipe.last_remat}, {secs:.2f} s,"
        f" peak {peak:.2f} GiB above {torch.cuda.memory_allocated() / 2**30:.2f} resident,"
        f" images {img.shape} finite {bool(np.isfinite(img).all())}")
    if pipe.last_remat is not True:
        raise PhaseError("remat=None did not choose remat at a batch the calibration flags")
    if img.shape != (batch, 512, 512, 3) or not np.isfinite(img).all():
        raise PhaseError("the flagged request's images are not finite")
    del img
    torch.cuda.empty_cache()
    return c_req


# ---------------------------------------------------------------------------
# phase 10: dist
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_train_steps(stack, torch, mesh) -> dict:
    """One LGP step and one injection step at batch 2, 512^2, SGD, from
    seeded fresh trainables and draw generators, through the data-parallel
    code when ``mesh`` is given. -> loss and state of each."""
    from sketch2img_torch.apps.train_attn_inject import injected_unet
    from sketch2img_torch.models.lgp import LatentEdgePredictor, sync_batch_stats
    from sketch2img_torch.models.unet import tap_channels
    from sketch2img_torch.train.train_attn_inject import inject_train_step, mark_trainables
    from sketch2img_torch.train.train_lgp import Frozen, lgp_train_step

    comps, gan = stack.comps, stack.gan
    gen = torch.Generator(device="cuda").manual_seed(31)
    batch = {"input_ids": torch.randint(0, 49406, (2, TRAIN_IDS), generator=gen, device="cuda"),
             "pixels": torch.rand(2, 3, 512, 512, generator=gen, device="cuda") * 2 - 1}
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]), torch.device("cuda"):
        torch.manual_seed(32)
        lgp = LatentEdgePredictor(input_dim=tap_channels(comps.unet.config) + 4 + 36)
    if mesh is not None:
        sync_batch_stats(lgp, mesh.data_group)
    opt = torch.optim.SGD(lgp.parameters(), lr=1e-2)
    frozen = Frozen(comps.unet, comps.vae, comps.text_encoder, gan, comps.schedule)
    lgp_loss = lgp_train_step(lgp, opt, frozen, batch, mesh=mesh, sketch_fixed_size=1024,
                              generator=torch.Generator(device="cuda").manual_seed(33))
    out = {"lgp_loss": lgp_loss, "lgp": {k: v.clone() for k, v in lgp.state_dict().items()}}
    del lgp, opt
    clip = stack.vit(seed=34).float()
    unet = injected_unet(comps, clip.config.hidden_size, 35)
    trainables = mark_trainables(unet, clip)
    opt = torch.optim.SGD(trainables.values(), lr=1e-2)
    out["inject_loss"] = inject_train_step(
        unet, clip, opt, Frozen(None, comps.vae, comps.text_encoder, gan, comps.schedule), batch,
        mesh=mesh, sketch_fixed_size=512,
        generator=torch.Generator(device="cuda").manual_seed(36))
    out["inject"] = {k: v.detach().clone() for k, v in trainables.items()}
    return out


def run_dist(stack, fa, gn, torch) -> dict:
    """World size 1 over NCCL against no process group; then TP over two
    processes on the card."""
    import numpy as np
    import torch.distributed as dist

    from sketch2img_torch.parallel.mesh import initialize_distributed, make_mesh
    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps = stack.comps
    log(f"  devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}; data"
        f" parallelism over more than one GPU cannot run on this machine")
    t0 = time.perf_counter()
    initialize_distributed("cuda", init_method=f"tcp://localhost:{free_port()}", rank=0,
                           world_size=1)
    try:
        mesh = make_mesh()
        log(f"  process group: backend {dist.get_backend()}, world size"
            f" {dist.get_world_size()}, {mesh} ({time.perf_counter() - t0:.2f} s)")
        plain = dist_train_steps(stack, torch, None)  # under the package's own setting
        dp = dist_train_steps(stack, torch, mesh)
        same = {"lgp_loss": bool(plain["lgp_loss"].equal(dp["lgp_loss"])),
                "inject_loss": bool(plain["inject_loss"].equal(dp["inject_loss"])),
                "lgp": all(plain["lgp"][k].equal(dp["lgp"][k]) for k in plain["lgp"]),
                "inject": all(plain["inject"][k].equal(dp["inject"][k])
                              for k in plain["inject"])}
        log(f"  trainer steps (B=2, 512^2) through the data-parallel code at world size 1"
            f" (NCCL) against no mesh, bit for bit: {same}; losses LGP"
            f" {float(plain['lgp_loss']):.6f}, injection {float(plain['inject_loss']):.6f}")
        if not all(same.values()):
            raise PhaseError(f"data-parallel trainer steps differ at world size 1: {same}")
        del plain, dp
        sketch = sketch_image(np)
        kw = dict(num_inference_steps=3, width=512, height=512, seed=[5, 6],
                  sketch_image=[sketch, sketch[::-1].copy()])
        img0 = SketchGuidedPipeline(comps)(["a house", "a tree"], **kw)
        reset_counts(fa, gn)
        img1 = SketchGuidedPipeline(comps, mesh=make_mesh())(["a house", "a tree"], **kw)
        launches = counts(fa, gn)
        log(f"  SketchGuidedPipeline(mesh=make_mesh()) against mesh=None, B=2 3 steps 512^2:"
            f" bit-identical {bool(np.array_equal(img0, img1))}; launches {launches}")
        if not np.array_equal(img0, img1):
            raise PhaseError("the pipeline under a world-size-1 mesh differs from mesh=None")
    finally:
        dist.destroy_process_group()
    run_tp_pair(stack, torch)
    return launches


def tp_recorded_heads(fa):
    """Record the head count of every flash forward call (a wrapper around
    the module's ``flash_forward``). -> the set it fills."""
    heads, real = set(), fa.flash_forward

    def recorder(q, *args, **kw):
        heads.add(q.shape[1])
        return real(q, *args, **kw)

    fa.flash_forward = recorder
    return heads


def tp_worker(rank: str, init: str, out: str) -> int:
    """One rank of the TP pair: full-width SD1.5 on seeded weights, its
    UNet's attention sliced to this rank's heads, one guided pass on the
    phase's seeded inputs; eps, gradient, launches and the flash calls'
    head counts saved to ``out``."""
    import torch

    from sketch2img_torch.ops import flash_attention as fa
    from sketch2img_torch.ops import groupnorm as gn
    from sketch2img_torch.parallel.mesh import initialize_distributed, make_mesh
    from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline

    initialize_distributed("cuda", backend="gloo", init_method="file://" + init,
                           rank=int(rank), world_size=TP_RANKS)
    comps = SDComponents.random_init(seed=0, compute_dtype=torch.bfloat16, random_weights=True,
                                     device="cuda")
    comps.tokenizer = StandInTokenizer()
    mesh = make_mesh(model_parallel=TP_RANKS)
    pipe = SketchGuidedPipeline(comps, mesh=mesh)
    local = sorted({m.heads for m in comps.unet.modules() if hasattr(m, "tp_size")})
    x, t, ctx, target = guided_inputs(pipe, torch, seed=21)
    guided_pass(comps, torch, x, t, ctx, target)  # warm-up
    torch.cuda.synchronize()
    heads = tp_recorded_heads(fa)
    reset_counts(fa, gn)
    t0 = time.perf_counter()
    eps, g = guided_pass(comps, torch, x, t, ctx, target)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    torch.save({"eps": eps.cpu(), "grad": g.cpu(), "launches": counts(fa, gn),
                "module_heads": local, "flash_heads": sorted(heads), "seconds": secs}, out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_tp_pair(stack, torch) -> None:
    """Tensor parallelism at m = 2 as two processes sharing the card over
    gloo (NCCL takes one rank a device): each rank's guided pass against the
    one-process pass on the same weights and inputs (the e2e gates: eps
    within 5e-2 of max|eps|, gradient cosine 0.98); flash launched at the
    local heads, 15 / 12 / 12 times."""
    import shutil

    from sketch2img_torch.runtime import SketchGuidedPipeline

    folder = os.path.join(SMOKE_DIR, "tp")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    init = os.path.join(folder, "rdzv")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
                               init, os.path.join(folder, f"rank{r}.pt")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(TP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(out[-4000:])
            raise PhaseError(f"TP rank {r} over gloo on the card failed (exit {p.returncode})")
    pipe = SketchGuidedPipeline(stack.comps)
    x, t, ctx, target = guided_inputs(pipe, torch, seed=21)
    guided_pass(stack.comps, torch, x, t, ctx, target)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eps, g = guided_pass(stack.comps, torch, x, t, ctx, target)
    torch.cuda.synchronize()
    log(f"  one process, all 8 heads: the same guided pass in {time.perf_counter() - t1:.3f} s")
    want = {"flash_fwd": FWD_SITES, "flash_bwd_dq": BWD_SITES, "flash_bwd_dkv": BWD_SITES}
    for r in range(TP_RANKS):
        got = torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
        e_rel = float((got["eps"].cuda() - eps).abs().max() / eps.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(got["grad"].cuda().flatten(),
                                                          g.flatten(), dim=0))
        flash = {k: got["launches"][k] for k in want}
        log(f"  TP rank {r} of {TP_RANKS} (gloo, the card shared): guided pass 512^2 B=1 in"
            f" {got['seconds']:.3f} s; attention modules at {got['module_heads']} heads, flash"
            f" forward calls at {got['flash_heads']} heads, launches {flash}; eps max err /"
            f" max|eps| {e_rel:.3e} (tol 5e-2), gradient cosine {cos:.5f} (tol 0.98) against"
            f" one process; {time.perf_counter() - t0:.1f} s for the pair")
        if e_rel > 5e-2 or cos < 0.98:
            raise PhaseError(f"TP rank {r}: eps or gradient disagree with one process")
        if flash != want or got["flash_heads"] != [HEADS // TP_RANKS]:
            raise PhaseError(f"TP rank {r}: launches {flash} at heads {got['flash_heads']}")



# ---------------------------------------------------------------------------
# phase 11: what the deterministic setting costs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def cudnn_flags_off(torch):
    """cuDNN's flags as PyTorch has them by default (deterministic off) while
    in force; the package's setting back after."""
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was


def run_cost(stack, torch) -> None:
    """Each route timed with the package's setting in force ("on") and with
    cuDNN's flags turned back off ("off"), ``COST_PAIRS`` interleaved pairs
    in the order on, off, off, on, ...: the 50-step sketch-guided request,
    the batch-8 injection request (safety checker on) and one step of each
    trainer; each after a warm-up in both settings (the requests at a few
    steps: the same shapes, so the same cuDNN plans)."""
    import numpy as np

    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps, inj = stack.comps, stack.inject
    if not torch.backends.cudnn.deterministic:
        raise PhaseError("the package's setting is not in force (cudnn.deterministic False)")
    pipe = SketchGuidedPipeline(comps)
    sketch = sketch_image(np)
    trainers = {which: TrainerStep(stack, torch, which) for which in ("lgp", "inject")}

    def guided(steps=50):
        return pipe("a sketch of a house", num_inference_steps=steps, width=512, height=512,
                    seed=1234, sketch_image=sketch)

    def injection(steps=INJ_STEPS):
        return inj([f"a sketch of a house, take {i}" for i in range(INJ_BATCH)],
                   num_inference_steps=steps, width=512, height=512, guidance_scale=7.5,
                   strength=0.5, spimg=sketch, seed=1234)

    routes = {  # label: (timed call, warm-up call)
        "sketch-guided 512^2 B=1 50 steps": (guided, lambda: guided(4)),
        f"injection 512^2 B={INJ_BATCH} {INJ_STEPS} steps": (injection, lambda: injection(2)),
        f"LGP train step B={TRAIN_BATCH}": (trainers["lgp"].run,) * 2,
        f"injection train step B={TRAIN_BATCH}": (trainers["inject"].run,) * 2,
    }
    comps.random_safety_checker(seed=2)
    try:
        for label, (fn, warm_up) in routes.items():
            times = {"on": [], "off": []}
            for mode in ("on", "off"):  # each setting's cuDNN plans
                with (cudnn_flags_off(torch) if mode == "off" else contextlib.nullcontext()):
                    warm_up()
            for i in range(COST_PAIRS):
                for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                    with (cudnn_flags_off(torch) if mode == "off" else contextlib.nullcontext()):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times[mode].append(time.perf_counter() - t0)
            on, off = (float(np.median(times[m])) for m in ("on", "off"))
            log(f"  cost of the deterministic setting, {label}: on {times['on']} s, off"
                f" {times['off']} s (in order on, off, off, on, on, off); median on {on:.4f} s,"
                f" off {off:.4f} s, on / off {on / off:.4f}; on {card_line()}")
    finally:
        comps.safety_checker = None
        del trainers
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: profile (only when asked)
# ---------------------------------------------------------------------------

def run_profile(stack, torch, steps: int = 4, inject_steps: int = 5) -> None:
    """Device time by kernel over one short request of each path and one
    step of each trainer (torch.profiler): the device's busy share of the
    wall time, and the shares of the flash kernels, the GroupNorm kernel
    and copies/casts."""
    import numpy as np

    from sketch2img_torch.runtime import SketchGuidedPipeline

    pipe = SketchGuidedPipeline(stack.comps)
    sketch = np.zeros((512, 512), np.float32)
    sketch[:, 250:262] = 1.0
    profile_request(torch, f"{steps}-step sketch-guided request", lambda: pipe(
        "a sketch of a house", num_inference_steps=steps, width=512, height=512, seed=1234,
        sketch_image=sketch))
    inj = stack.inject
    profile_request(torch, f"{inject_steps}-step injection request, B={INJ_BATCH}", lambda: inj(
        [f"a sketch of a house, take {i}" for i in range(INJ_BATCH)],
        num_inference_steps=inject_steps, width=512, height=512, strength=0.5, spimg=sketch,
        seed=1234))
    profile_train_steps(stack, torch)


def profile_train_steps(stack, torch) -> None:
    """One step of each trainer at B=4, 512^2 (the library step functions
    on modules made as the apps make them, a random batch), profiled after
    one unprofiled step."""
    from sketch2img_torch.apps.train_attn_inject import injected_unet
    from sketch2img_torch.models.lgp import LatentEdgePredictor
    from sketch2img_torch.models.unet import tap_channels
    from sketch2img_torch.train.optim import make_optimizer
    from sketch2img_torch.train.train_attn_inject import inject_train_step, mark_trainables
    from sketch2img_torch.train.train_lgp import Frozen, lgp_train_step

    comps, gan = stack.comps, stack.gan
    gen = torch.Generator(device="cuda").manual_seed(13)
    batch = {"input_ids": torch.randint(0, 49406, (TRAIN_BATCH, TRAIN_IDS), generator=gen,
                                        device="cuda"),
             "pixels": torch.rand(TRAIN_BATCH, 3, 512, 512, generator=gen, device="cuda") * 2 - 1}
    frozen = Frozen(comps.unet, comps.vae, comps.text_encoder, gan, comps.schedule)
    with torch.device("cuda"):
        lgp = LatentEdgePredictor(input_dim=tap_channels(comps.unet.config) + 4 + 36)
    opt = make_optimizer("adamw", lgp.parameters(), 2e-4)
    profile_request(torch, f"LGP train step, B={TRAIN_BATCH} (sketches at 1024^2)", lambda: float(
        lgp_train_step(lgp, opt, frozen, batch, generator=gen, sketch_fixed_size=1024)))
    del lgp, opt
    clip = stack.vit()
    unet = injected_unet(comps, clip.config.hidden_size, 0)
    opt = make_optimizer("adamw", mark_trainables(unet, clip).values(), 2e-4)
    profile_request(torch, f"injection train step, B={TRAIN_BATCH} (sketches at 512^2)",
                    lambda: float(inject_train_step(unet, clip, opt, frozen, batch, generator=gen,
                                                    sketch_fixed_size=512)))


def profile_request(torch, label: str, request) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        request()
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():  # device-side kernels only (ops and annotated ranges would count twice)
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)

    def share(pred):
        us = sum(r[0] for r in rows if pred(r[2]))
        return f"{us / 1e3:.2f} ms ({100 * us / max(busy, 1e-9):.1f}% of device time)"

    log(f"  profile of a {label}: wall {wall_us / 1e3:.2f} ms, kernels "
        f"{sum(r[1] for r in rows)} launches, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of wall, idle {100 * (1 - busy / wall_us):.1f}%), "
        f"flash kernels {share(lambda k: 'flash_' in k)}, GroupNorm kernel "
        f"{share(lambda k: 'gn::' in k)}, PyTorch GroupNorm "
        f"{share(lambda k: 'RowwiseMoments' in k or 'group_norm' in k.lower())}, "
        f"copies and casts {share(lambda k: 'copy' in k.lower())}")
    for dev, count, key in rows[:25]:
        log(f"    {dev / 1e3:10.3f} ms  {count:6d}x  {key[:110]}")


if __name__ == "__main__":
    sys.exit(main())
