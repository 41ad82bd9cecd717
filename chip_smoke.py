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
              every shape the two paths give it and time the kernel, the
              plain version and one PyTorch call as a yardstick (the port
              never calls it): flash forward, backward dQ and dK/dV at the
              sketch-guided shapes (q/k/v as the model passes them: heads
              views of (B, N, H*d) projections) plus a ragged and a kv_len
              case, one shape of every head-dim bucket, a head dim TMA
              cannot take in place, the flash forward at the injection
              path's shapes (batch 16 self- and concat attention, the ViT's
              257 tokens), and the GroupNorm kernel at every (B, C, H, W,
              eps, silu) recorded from one pass of each model on both paths,
              plus real activations. Times: "ms" back-to-back calls between
              CUDA events (host work included), "device_ms" the replay of
              CUDA graphs of the same calls (device time alone; for SDPA's
              backward, its kernels' durations from torch.profiler); the flash
              forward's host time a call at (1, 8, 256, 160) is logged.
              ("--phases build,flash" runs the flash part alone);
  3. e2e      full-width SD1.5 (seeded random weights): the kernels against
              the plain attention path, then against the plain GroupNorm
              path, inside one guided UNet pass; then a 512x512, 50-step
              sketch-guided request through ``SketchGuidedPipeline`` (after a
              4-step warm-up), launch counters zeroed just before and read
              just after;
  4. inject   the attention-injection path: ``ClipGuidedPipeline`` with the
              clip-injected UNet, the ViT-L/14 sketch encoder and a safety
              checker (seeded random weights, bf16), one 512x512 request at
              batch 8, 25 DPM-Solver++ steps, guidance 7.5, strength 0.5, one
              sketch, launch counters zeroed just before and read just after;
  5. profile  (only when asked: --phases build,profile) device time by
              kernel over a 4-step sketch-guided request and a 5-step batch-8
              injection request, from torch.profiler.

Then one JSON line listing the kernels, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when there is no CUDA device, when the port's package is missing, or
when any phase fails.
"""

from __future__ import annotations

import argparse
import json
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
REPLACES = {
    "flash_fwd": "sketch2img_tpu/ops/flash_attention.py:211 (_fwd_kernel; _fwd_kernel_t :331)",
    "flash_bwd_dq": "sketch2img_tpu/ops/flash_attention.py:601 (_bwd_dq_kernel; _bwd_dq_kernel_t :421)",
    "flash_bwd_dkv": "sketch2img_tpu/ops/flash_attention.py:640 (_bwd_dkv_kernel; _bwd_dkv_kernel_t :462)",
    "groupnorm_silu": "sketch2img_tpu/ops/groupnorm.py:54 (_kernel; _fused_forward :97, "
                      "pallas_call :112)",
}
SOURCES = {
    "flash_fwd": "sketch2img_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "sketch2img_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "sketch2img_torch/csrc/flash_bwd_dkv.cu",
    "groupnorm_silu": "sketch2img_torch/csrc/groupnorm_silu.cu",
}
# bf16 outputs carry 2^-9 relative rounding and the kernel accumulates in a
# different order than the plain version (both round P and dS to bf16 before
# their products): each of O, dQ, dK, dV may be off by this share of its own
# largest reference value. The LSE is fp32 from exact bf16 products, so it is
# held to an absolute limit.
TOL_REL = 2e-2
TOL_LSE_ABS = 1e-3
# GroupNorm: one bf16 rounding of the output (2^-9 relative) plus another
# summation order of the statistics; max error within 1% of max|plain|, mean
# error within 0.1% of it
GN_TOL_MAX, GN_TOL_MEAN = 1e-2, 1e-3


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
    else:
        flops = (6 if kind == "flash_bwd_dq" else 8) * bh * nq * kv_len * d
        outs = nq * d if kind == "flash_bwd_dq" else 2 * nk * d
        nbytes = bh * (2 * nq * d + 2 * kv_len * d + outs) * e + bh * nq * 8
    terms = {"tensor": flops / PEAK_BF16_FLOPS * 1e3, "bytes": nbytes / PEAK_HBM_BYTES * 1e3,
             "exp": bh * nq * kv_len / PEAK_EXP2 * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def gn_bound_ms(numel: int, channels: int) -> tuple:
    """GroupNorm+SiLU moves x in and y out once (bf16) plus gamma and beta;
    its ~10 fp32 operations an element are far below the byte time."""
    return (2 * numel * 2 + 2 * channels * 2) / PEAK_HBM_BYTES * 1e3, "bytes"


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
    cases.append(("ragged", 1, HEADS, 300, 300, None, 40, True, "heads"))
    cases.append(("kv_len", 1, HEADS, 4096, 4480, 4353, 40, True, "heads"))
    for n, d in MAIN_SHAPES:
        cases.append(("inject_attn1", 2 * INJ_BATCH, HEADS, n, n, None, d, False, "heads"))
        cases.append(("inject_sketch_attn", 2 * INJ_BATCH, HEADS, n, n + CLIP_PAD,
                      n + VIT_TOKENS, d, False, "heads"))
    cases.append(("vit_sketch", 1, VIT_HEADS, VIT_TOKENS, VIT_TOKENS, None, VIT_D, False, "heads"))
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
        sdpa = lambda: F.scaled_dot_product_attention(q, ks, vs, scale=scale)  # noqa: E731
        fwd = lambda: fa.flash_forward(q, k, v, scale, kv_len)  # noqa: E731
        times = {"flash_fwd": (
            time_ms(fwd), graph_ms(fwd),
            time_ms(lambda: fa.flash_forward_plain(q, k, v, scale, kv_len), reps=5),
            time_ms(sdpa), graph_ms(sdpa))}
        if (b, h, nq, d) == (1, HEADS, 256, 160) and tag == "main":
            log(f"  flash_forward host time a call at (1, 8, 256, 160): {host_us(fwd):.2f} us")
        if with_bwd:
            dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, scale, kv_len)
            # the reference takes the plain forward's O and LSE, so an error in
            # the kernel's LSE cannot cancel out of both sides
            rq, rk, rv = fa.flash_backward_plain(q, k, v, o_ref, lse_ref, do, scale, kv_len)
            torch.cuda.synchronize()
            results["flash_bwd_dq"] = [("dQ", dq, rq)]
            results["flash_bwd_dkv"] = [("dK", dk, rk), ("dV", dv, rv)]
            qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, ks, vs))
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                          retain_graph=True))
            # SDPA's backward on the device alone (its kernels' durations; a
            # graph would have to hold autograd's work too)
            lib_bwd_dev = profiled_device_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True))
            t_bwd = time_ms(lambda: fa.flash_backward(q, k, v, o, lse, do, scale, kv_len))
            t_plain = time_ms(lambda: fa.flash_backward_plain(q, k, v, o, lse, do, scale,
                                                              kv_len), reps=5)
            # one flash_backward call launches both kernels; split its time by
            # timing each kernel alone through the C entry points
            run_dq, run_dkv = split_backward(fa, torch, q, k, v, o, lse, do, scale, kvl)
            t_dq, t_dkv = time_ms(run_dq), time_ms(run_dkv)
            g_dq, g_dkv = graph_ms(run_dq), graph_ms(run_dkv)
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
                t_tol = TOL_LSE_ABS if label == "LSE" else TOL_REL * t_ref
                t_ok = bool(torch.isfinite(a).all()) and t_err <= t_tol
                checks.append((label, t_err, t_ref, t_tol, t_ok))
            err = max(c[1] for c in checks)
            ok = all(c[4] for c in checks)
            kms, dms, pms, lms, ldms = times[name]
            bms, bby, bterm = bound_ms(name, b, h, nq, nk, kvl, d)
            detail = " ".join(f"{lb}:err={e:.3e},max|ref|={m:.3e},tol={t:.3e}"
                              for lb, e, m, t, _ in checks)
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
        del q, k, v, do, o, lse, results
        torch.cuda.empty_cache()
    if failures:
        raise PhaseError("; ".join(failures))
    return per_kernel


def split_backward(fa, torch, q, k, v, o, lse, do, scale, kvl):
    """The dQ and dK/dV launches of one flash_backward, each callable alone
    through the C entry points (on the stream current at the call)."""
    lib = fa.load_library()
    prepare = getattr(fa, "prepare_operand", lambda x: (x, False))
    q, k, v, do = (prepare(x)[0] for x in (q, k, v, do))
    b, h, nq, d = q.shape
    nk = k.shape[2]
    delta = (do.float() * o.float()).sum(-1).contiguous()
    lse = lse.float().contiguous()
    dq = fa._heads_merged(b, h, nq, d, q)
    dk, dv = fa._heads_merged(b, h, nk, d, q), fa._heads_merged(b, h, nk, d, q)
    view = fa._view
    tail = (b, h, nq, nk, d, kvl, float(scale), 0)

    def common():
        return (q.device.index, torch.cuda.current_stream().cuda_stream, *view(q), *view(k),
                *view(v), *view(do), lse.data_ptr(), delta.data_ptr())

    def run_dq():
        fa._launch("flash_bwd_dq", lib.flash_bwd_dq, *common(), *view(dq), *tail)

    def run_dkv():
        fa._launch("flash_bwd_dkv", lib.flash_bwd_dkv, *common(), *view(dk), *view(dv), *tail)

    return run_dq, run_dkv


def record_gn_calls(stack, gn, torch) -> tuple:
    """One pass of each model of the two paths with a recorder on the
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
        "vae_enc_b1": lambda: comps.vae.encode(randn(1, 3, 512, 512)),
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
            "vae_enc_b1": GN_VAE_ENC, "vae_dec_b1": GN_VAE_DEC, "vae_dec_b8": GN_VAE_DEC}
    got = {k: len(v) for k, v in per_pass.items()}
    log(f"  GroupNorm calls per pass {got} expected {want}")
    if got != want:
        raise PhaseError(f"GroupNorm calls per pass {got} != {want}")
    return per_pass, inputs


def check_groupnorm(stack, gn, torch) -> dict:
    """The kernel against its plain version at every distinct (B, C, H, W,
    eps, silu) the passes gave it (random inputs, mean 0.5, and a random
    affine) and on the real activations; times of the kernel, the plain
    version and the yardstick F.silu(F.group_norm(x)) (two PyTorch calls)."""
    import torch.nn.functional as F

    per_pass, inputs = record_gn_calls(stack, gn, torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = {}
    for calls in per_pass.values():
        for shape, eps, silu in calls:
            cases.setdefault((shape, eps, silu), None)
    work = [("shape", shape, eps, silu, None) for shape, eps, silu in cases]
    work += [("real_unet_norm1", tuple(inputs["unet_norm1"].shape), 1e-5, True,
              inputs["unet_norm1"]),
             ("real_vae_norm_out", tuple(inputs["vae_norm_out"].shape), 1e-6, True,
              inputs["vae_norm_out"])]
    entry, failures, timed = new_entry(), [], {}
    for tag, shape, eps, silu, x in work:
        c = shape[1]
        if x is None:
            x = (torch.randn(*shape, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        y = gn.group_norm_silu_kernel(x, w, b, 32, eps, silu)
        p = gn.group_norm_silu_plain(x, w, b, 32, eps, silu)
        torch.cuda.synchronize()
        diff = (y.float() - p.float()).abs()
        ref = float(p.float().abs().max())
        err, mean_err = float(diff.max()), float(diff.mean())
        ok = (bool(torch.isfinite(y).all()) and err <= GN_TOL_MAX * ref
              and mean_err <= GN_TOL_MEAN * ref)

        def library():
            out = F.group_norm(x, 32, w, b, eps)
            return F.silu(out) if silu else out

        big = x.numel() > 2 ** 26
        kernel = lambda: gn.group_norm_silu_kernel(x, w, b, 32, eps, silu)  # noqa: E731
        kms, dms = time_ms(kernel), graph_ms(kernel, reps=3 if big else 10)
        pms = time_ms(lambda: gn.group_norm_silu_plain(x, w, b, 32, eps, silu),
                      reps=3 if big else 5)
        lms, ldms = time_ms(library), graph_ms(library, reps=3 if big else 10)
        bms, bby = gn_bound_ms(x.numel(), c)
        log(f"kernel=groupnorm_silu case={tag} shape={shape} eps={eps:g} silu={silu}"
            f" err={err:.3e} mean_err={mean_err:.3e} max|plain|={ref:.3e}"
            f" tol={GN_TOL_MAX * ref:.3e}/{GN_TOL_MEAN * ref:.3e} ok={ok}"
            f" ms={kms:.4f} device_ms={dms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f}"
            f" library_device_ms={ldms:.4f} bound_ms={bms:.4f} ({bby})")
        if not ok:
            failures.append(f"groupnorm_silu {tag} {shape} eps={eps} silu={silu}: err={err:.3e}"
                            f" mean={mean_err:.3e} max|plain|={ref:.3e}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["bound_by"] = entry["bound_term"] = bby
        timed[(shape, eps, silu)] = (kms, dms, pms, lms, ldms, bms)
        entry["shapes"].append({"case": tag, "shape": list(shape), "eps": eps, "silu": silu,
                                "ms": kms, "device_ms": dms, "plain_ms": pms,
                                "library_ms": lms, "library_device_ms": ldms,
                                "bound_ms": bms})
        del x, y, p, diff
        torch.cuda.empty_cache()
    if failures:
        raise PhaseError("; ".join(failures))
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")
    for name, calls in per_pass.items():
        tot = dict(zip(keys, (sum(timed[call][i] for call in calls) for i in range(6))))
        log(f"  groupnorm_silu summed over one {name} pass ({len(calls)} calls): "
            + " ".join(f"{k_}={v_:.4f}" for k_, v_ in tot.items()))
        if name == "unet_b1":  # the flash kernels' convention: one batch-1 UNet pass
            entry.update(tot)
    return entry


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
    ap.add_argument("--phases", default="build,kernels,e2e,inject")
    ap.add_argument("--steps", type=int, default=50, help="sampling steps of the e2e request")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas register/smem use")
    args = ap.parse_args(argv)
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
                per_kernel["groupnorm_silu"] = check_groupnorm(stack, gn, torch)
            log(f"phase kernels: ok, {time.time() - t0:.2f} s")
        if "e2e" in phases:
            t0 = time.time()
            launches["sketch_guided"] = run_e2e(stack, fa, gn, torch, args.steps)
            log(f"phase e2e: ok, {time.time() - t0:.2f} s")
        if "inject" in phases:
            t0 = time.time()
            launches["inject"] = run_inject(stack, fa, gn, torch)
            log(f"phase inject: ok, {time.time() - t0:.2f} s")
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


def guided_pass(comps, torch, x, t, ctx, target):
    """The differentiated half of a guided step: cond UNet forward with taps,
    fused LGP head, MSE against the sketch latent, gradient w.r.t. x."""
    from sketch2img_torch.core.schedulers import get_noise_level
    from sketch2img_torch.models.lgp import lgp_fused_apply

    xc = x.detach().requires_grad_(True)
    eps, taps = comps.unet(xc, t, ctx, capture_taps=True)
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
        self._comps = self._inject = None

    @property
    def comps(self):
        if self._comps is None:
            from sketch2img_torch.runtime import SDComponents

            torch = self.torch
            t0 = time.perf_counter()
            self._comps = c = SDComponents.random_init(seed=0, compute_dtype=torch.bfloat16,
                                                       device="cuda")
            c.tokenizer = StandInTokenizer()
            torch.cuda.synchronize()
            n_params = {name: sum(p.numel() for p in m.parameters())
                        for name, m in (("unet", c.unet), ("vae", c.vae),
                                        ("text_encoder", c.text_encoder), ("lgp", c.lgp))}
            log(f"  random_init (full SD1.5 width, bf16, LGP fp32 {c.lgp.layers[0].in_features}"
                f" inputs): {time.perf_counter() - t0:.2f} s, params {n_params}")
        return self._comps

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


def sketch_image(np):
    sketch = np.zeros((512, 512), np.float32)
    sketch[100:412, 250:262] = 1.0
    sketch[250:262, 100:412] = 1.0
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


def run_e2e(stack, fa, gn, torch, steps: int) -> dict:
    import contextlib

    import numpy as np

    from sketch2img_torch.ops.attention import set_default_attention_backend
    from sketch2img_torch.pipelines.sketch_guided import num_guided_steps
    from sketch2img_torch.runtime import SketchGuidedPipeline

    comps = stack.comps
    pipe = SketchGuidedPipeline(comps)
    sketch = sketch_image(np)

    @contextlib.contextmanager
    def plain_attention():
        set_default_attention_backend("plain")
        try:
            yield
        finally:
            set_default_attention_backend("auto")

    @contextlib.contextmanager
    def plain_groupnorm():  # every GroupNorm through the plain version, flash kept
        real = gn._forward
        gn._forward = gn.group_norm_silu_plain
        try:
            yield
        finally:
            gn._forward = real

    # the kernels against the plain paths inside one guided UNet pass
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1, 4, 64, 64, generator=gen, device="cuda")
    target = torch.randn(1, 4, 64, 64, generator=gen, device="cuda") * 0.2
    t = torch.full((1,), 801, dtype=torch.long, device="cuda")
    _, ctx = pipe.encode_prompt("a house")
    compare_guided(comps, torch, x, t, ctx, target, "plain attention path", plain_attention)
    compare_guided(comps, torch, x, t, ctx, target, "plain GroupNorm path", plain_groupnorm)

    def run(n_steps, count, per_step=True):
        marks = []

        def cb(i, t_, lat):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        if count:
            reset_counts(fa, gn)
        start = time.perf_counter()
        img = pipe("a sketch of a house", num_inference_steps=n_steps, width=512, height=512,
                   seed=1234, sketch_image=sketch, callback=cb if per_step else None)
        torch.cuda.synchronize()
        launches = counts(fa, gn) if count else None
        if count:
            check_no_copies(fa, "sketch-guided request")
        return img, launches, start, marks, time.perf_counter()

    run(4, False)  # warm-up: cuDNN plans for both batch sizes, allocator
    torch.cuda.reset_peak_memory_stats()
    img, launches, start, marks, end = run(steps, True)  # the counted main-path run
    _, _, r_start, _, r_end = run(steps, False, per_step=False)  # no per-step syncs
    log(f"  request (sketch-guided 512x512 B=1, {steps} steps, no callback): "
        f"{r_end - r_start:.3f} s on {card_line()}")
    n_guided = num_guided_steps(steps)
    n_plain = steps - n_guided
    forwards = 2 * n_guided + n_plain
    expected = {"flash_fwd": FWD_SITES * forwards,
                "flash_bwd_dq": BWD_SITES * n_guided, "flash_bwd_dkv": BWD_SITES * n_guided,
                "groupnorm_silu": GN_UNET * forwards + GN_VAE_ENC + GN_VAE_DEC}
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
        start = time.perf_counter()
        img = pipe(prompts, num_inference_steps=INJ_STEPS, **kw)  # the counted run
        torch.cuda.synchronize()
        end = time.perf_counter()
        launches = counts(fa, gn)
        check_no_copies(fa, "injection request")
        peak = torch.cuda.max_memory_allocated() / 2**30
        start2 = time.perf_counter()
        pipe(prompts, num_inference_steps=INJ_STEPS, **kw)
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
    expected = {"flash_fwd": INJ_STEPS * INJ_FLASH_SITES + 2 * VIT_LAYERS,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "groupnorm_silu": INJ_STEPS * GN_UNET + GN_VAE_DEC}
    finite = bool(np.isfinite(img).all())
    log(f"  images shape {img.shape} finite={finite} min={img.min():.4f} max={img.max():.4f}"
        f" mean={img.mean():.4f} std={img.std():.4f}")
    log(f"  launches {launches} expected {expected}")
    if img.shape != (INJ_BATCH, 512, 512, 3) or not finite or img.min() < 0 or img.max() > 1:
        raise PhaseError(f"inject images are not finite ({INJ_BATCH}, 512, 512, 3) in [0, 1]")
    if img.std() == 0:
        raise PhaseError("inject images are constant")
    if launches != expected:
        raise PhaseError(f"launch counts {launches} != expected {expected}")
    return launches


def run_profile(stack, torch, steps: int = 4, inject_steps: int = 5) -> None:
    """Device time by kernel over one short request of each path
    (torch.profiler): the device's busy share of the wall time, and the
    shares of the flash kernels, the GroupNorm kernel and copies/casts."""
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
    for e in prof.events():  # device-side kernel events only (ops would count twice)
        if e.device_type == DeviceType.CUDA:
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
        f"{share(lambda k: 'gn_stats' in k or 'gn_apply' in k)}, PyTorch GroupNorm "
        f"{share(lambda k: 'RowwiseMoments' in k or 'group_norm' in k.lower())}, "
        f"copies and casts {share(lambda k: 'copy' in k.lower())}")
    for dev, count, key in rows[:25]:
        log(f"    {dev / 1e3:10.3f} ms  {count:6d}x  {key[:110]}")


if __name__ == "__main__":
    sys.exit(main())
