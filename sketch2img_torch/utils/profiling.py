"""Tracing and device timing — counterpart of
``sketch2img_tpu/utils/profiling.py``, over ``torch.profiler`` and CUDA
events."""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a GPU is
    present) and export a Chrome trace to ``logdir/trace.json`` (open it in
    chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` tabulates the ops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_timeit(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Mean seconds per call of ``fn(*args)``: on the card, between two CUDA
    events around ``iters`` back-to-back calls (host work of the calls
    included), ending in a synchronise; on the CPU, the host clock."""
    for _ in range(warmup):
        fn(*args)
    if not torch.cuda.is_available():
        import time

        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
