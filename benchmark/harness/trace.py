"""Tracing of the benchmark's traced runs: ``record_function`` ranges that
the benchmark opens around the port's kernel entry points, and the
reduction of a ``torch.profiler`` trace to device busy time, idle gaps,
top device operations and the device time spent inside each range.

Why it is here: the per-layer metrics must come from what the benchmark
observes, so that a change to the program cannot move the yardstick. The
ranges are set on module attributes (``ops.flash_attention.flash_forward``
/ ``flash_backward``, ``ops.groupnorm.group_norm_silu_kernel``), which every
caller reaches at call time, the guided backward's autograd thread too.
Device time goes to a range through each kernel's launch: the CPU-side
event the profiler links to the kernel starts inside the range, on the
range's thread. Kernel names play no part, so a renamed kernel still counts.
The shapes recorded at the entry points only cross-check the calls that
``counts`` derives from the configuration; no bound is taken from them.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

PREFIX = "bench/"


def _flash_shape(kind: str):
    def shape(q, k, v, *args, kv_len=None, **kw):
        if kind == "bwd" and len(args) >= 4:
            kv_len = args[4] if len(args) > 4 else kv_len
        elif kind == "fwd" and len(args) >= 2:
            kv_len = args[1]
        nk = k.shape[2]
        kv = nk if kv_len is None else min(int(kv_len), nk)
        b, h, nq, d = q.shape
        return (kind, b, h, nq, kv, d)
    return shape


def _gn_shape(x, weight, *args, **kw):
    return (x.shape[0], x.shape[1], x[0, 0].numel(), x.element_size())


class KernelRanges:
    """While installed, every call of the port's flash and GroupNorm entry
    points runs inside ``record_function("bench/<layer>")`` and its shape
    is recorded in ``calls[layer]``: flash (kind, B, H, nq, kv, d),
    GroupNorm (B, C, H*W, element bytes)."""

    def __init__(self):
        from sketch2img_torch.ops import flash_attention as fa
        from sketch2img_torch.ops import groupnorm as gn

        self._sites = [(fa, "flash_forward", "flash", _flash_shape("fwd")),
                       (fa, "flash_backward", "flash", _flash_shape("bwd")),
                       (gn, "group_norm_silu_kernel", "groupnorm", _gn_shape)]
        self.calls: Dict[str, List[Tuple]] = defaultdict(list)
        self._saved = []

    def _wrap(self, fn: Callable, layer: str, shape: Callable) -> Callable:
        calls = self.calls[layer]

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            calls.append(shape(*args, **kw))
            with torch.profiler.record_function(PREFIX + layer):
                return fn(*args, **kw)
        return wrapped

    def __enter__(self) -> "KernelRanges":
        for mod, attr, layer, shape in self._sites:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, layer, shape))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


@contextlib.contextmanager
def profiled(device: torch.device, cpu: bool):
    """A torch.profiler session around the block; yields a dict that gets
    ``prof`` and the window's bounds on the profiler's clock (Unix time in
    ns). ``cpu``: record host operations and the ranges as well, which
    costs the host time per operation; without it only the device's
    activity is recorded, and the idle share is the device's own."""
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out: Dict = {}
    prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    try:
        out["t0_ns"] = time.time_ns()
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["t1_ns"] = time.time_ns()
    finally:
        prof.stop()
        out["prof"] = prof


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(session: Dict, top: int = 10) -> Dict:
    """A ``profiled`` session -> window_s and busy_s (the union of device
    intervals inside the window), device seconds by range layer (kernels
    that ran inside a range's device-side span), device_ops and idle_gaps
    (each the ``top`` largest, in seconds, a gap labelled by the innermost
    host operation running at its middle when host operations were
    recorded) and the count of device events."""
    w0, w1 = session["t0_ns"], session["t1_ns"]
    host: List[Tuple[int, int, str]] = []
    ranges: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str]] = []
    for e in session["prof"].profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if not name.startswith(PREFIX):
                host.append((a, b, name))
        elif name.startswith(PREFIX):  # a range as the device ran it
            ranges.append((a, b, name[len(PREFIX):]))
        elif b > w0 and a < w1:
            device.append((max(a, w0), min(b, w1), name))
    busy = _union([(a, b) for a, b, _ in device])
    ranges.sort()
    starts = [r[0] for r in ranges]
    device_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in device:
        by_name[name] += (b - a) / 1e9
        i = bisect.bisect_right(starts, a) - 1  # the innermost range begun before it
        if i >= 0 and b <= ranges[i][1]:
            device_s[ranges[i][2]] += (b - a) / 1e9
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        inner = [(e - s, n) for s, e, n in host if s <= mid <= e]
        labelled.append([min(inner)[1] if inner else "host", (b - a) / 1e9])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(b - a for a, b in busy) / 1e9,
            "device_s": dict(device_s),
            "device_ops": [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": labelled, "device_events": len(device)}


def combine(device_only: Dict, with_host: Dict) -> Dict:
    """The device's busy time, idle share and top operations from a session
    without host recording; the kernels' range times and the idle gaps'
    labels from one with it."""
    out = dict(device_only)
    out["device_s"] = with_host["device_s"]
    out["idle_gaps"] = with_host["idle_gaps"]
    return out
