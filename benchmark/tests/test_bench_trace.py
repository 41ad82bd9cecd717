"""The trace reduction and the kernel ranges on the CPU, and one short
run of each cell on the card (marked ``cuda``)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.counts import flash
from benchmark.harness import core, trace
from benchmark.tests.tiny import tiny_cell


def test_union_and_gaps():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_summarize_a_cpu_session():
    with trace.profiled(torch.device("cpu"), cpu=True) as s:
        with torch.profiler.record_function(trace.PREFIX + "flash"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    out = trace.summarize(s)
    assert out["window_s"] > 0 and out["busy_s"] == 0 and out["device_events"] == 0
    assert out["idle_gaps"] and out["idle_gaps"][0][1] <= out["window_s"]


def test_kernel_ranges_record_logical_shapes_and_restore():
    from sketch2img_torch.ops import flash_attention as fa
    from sketch2img_torch.ops import groupnorm as gn

    before = (fa.flash_forward, fa.flash_backward, gn.group_norm_silu_kernel)
    q = torch.randn(1, 2, 8, 4)
    k = torch.randn(1, 2, 16, 4)
    with trace.KernelRanges() as kr:
        fa.flash_forward(q, k, k, 0.5, 12)
        o, lse = fa.flash_forward_plain(q, k, k, 0.5)
        fa.flash_backward(q, k, k, o, lse, torch.ones_like(o), 0.5, None)
    assert kr.calls["flash"] == [("fwd", 1, 2, 8, 12, 4), ("bwd", 1, 2, 8, 16, 4)]
    assert (fa.flash_forward, fa.flash_backward, gn.group_norm_silu_kernel) == before


TRACED = {  # tiny cells at a 16x16 latent, where the first level's attention is a flash site
    "sd15-lgp.guided-b1-512-50": dict(size=128, steps=3, check={
        "requests": 1, "guided_steps": 1, "plain_steps": 1}),
    "sd15-inject.clip-b8-512-25": dict(size=128, steps=2, batch=2, profiled_requests=1,
                                       check={"requests": 1, "steps": 1, "chunk": 2}),
    "sd15-lgp.train-b4-512": dict(size=128, images=200, batch=2, sketch_fixed_size=128,
                                  profiled_steps=2, check={"start_within": 1}),
}


@pytest.mark.parametrize("name", list(TRACED))
def test_derived_kernel_calls_are_the_programs(name, monkeypatch):
    """A traced run on the CPU, with GroupNorm sent through the kernel's
    entry point: the flash and GroupNorm calls derived from the
    configuration and the passes equal, row for row, those the port made."""
    from benchmark.metrics import _common
    from sketch2img_torch.ops import groupnorm as gn

    monkeypatch.setattr(gn, "group_norm_silu_kernel", gn.group_norm_silu_plain)
    monkeypatch.setattr(gn, "_forward", lambda *a: gn.group_norm_silu_kernel(*a))
    monkeypatch.setattr(_common, "range_device_s", lambda drv, layer: 1.0)
    cell = tiny_cell(name, **TRACED[name])
    res = core.run_cell(cell, 2 ** 32 + 5, 0.2, True, torch.device("cpu"), log=lambda m: None)
    got = {k.split(".")[0] for k in res["metrics"]}
    assert {"flash_roofline", "groupnorm_roofline"} <= got, res["metrics"]


def test_a_padded_call_fails_the_traced_run(monkeypatch):
    """A program that pads the head dim before the kernel's entry point
    cannot raise the bound: the traced run fails on the cross-check."""
    from sketch2img_torch.ops import flash_attention as fa

    def padded(q, k, v, scale, mask=None, kv_len=None):
        pad = lambda t: torch.nn.functional.pad(t, (0, 8))  # noqa: E731
        return fa.flash_forward(pad(q), pad(k), pad(v), scale, kv_len)[0][..., :-8].contiguous()

    monkeypatch.setattr(fa, "flash_attention", padded)
    cell = tiny_cell("sd15-inject.clip-b8-512-25", **TRACED["sd15-inject.clip-b8-512-25"])
    with pytest.raises(flash.CountMismatch, match=r"'fwd', 256, 256, 24\)"):
        core.run_cell(cell, 11, 0.2, True, torch.device("cpu"), log=lambda m: None)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(os.path.join(core.ROOT, "BENCHMARK.json")))["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2718281828", "--seconds", "3", "--trace", "0"], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
