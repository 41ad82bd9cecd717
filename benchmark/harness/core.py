"""The run of one cell: find its files by name, check the card, set up,
measure, check the outputs, read the per-layer metrics, print the result.

Why it is here: every cell runs through this one path, so that a later
change adds a configuration, a traffic mix, a driver or a metric reader as
files of its own and edits none. A cell ``<config>.<traffic>`` is found in
``BENCHMARK.json``; its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json``, the driver of its entry in
``drivers/<entry>.py``, its limits in ``limits/<cell>.json``, and each
per-layer metric's reader in ``metrics/<name before the first dot>.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "sketch2img_tpu")


class NoCard(RuntimeError):
    pass


def load_json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def refuse_jax() -> None:
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"JAX or the JAX package was loaded: {found}")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def find_cell(name: str, manifest: Optional[Dict] = None) -> Cell:
    m = manifest or json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(work)}")
    w = work[name]
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    moved = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if (name in x["workloads"] if "workloads" in x else x["moves"] in moved)]
    return Cell(name, load_json("configs", w["config"] + ".json"),
                load_json("traffic", w["traffic"] + ".json"),
                load_json("limits", name + ".json"), w["chips"], e2e, layer)


@dataclasses.dataclass
class Ctx:
    """What a driver is given: the cell, the seed, the device, and whether
    this is a traced run."""

    cell: Cell
    seed: int
    device: Any
    trace: bool
    control: bool = False

    @property
    def cfg(self) -> Dict:
        return self.cell.config

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic


def card(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"the cell needs {chips} CUDA device(s); this machine has {have}")
    return torch.device("cuda", 0)


def device_info(device, chips: int, peak_bytes: int) -> Dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def compare(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number passes at or under its limit."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = {"value": v, "limit": limit,
                     "ok": v is not None and not math.isnan(v) and v <= limit}
    return out


def read_metrics(specs: List[Dict], run: Any) -> Dict[str, Dict]:
    out = {}
    for spec in specs:
        base, _, suffix = spec["name"].partition(".")
        reader = importlib.import_module(f"benchmark.metrics.{base}")
        value = reader.read(run, suffix)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, log=None) -> Dict:
    """Set up, measure, check -> the result object (not printed)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    driver_mod = importlib.import_module(f"benchmark.drivers.{cell.traffic['entry']}")
    ctx = Ctx(cell, seed, device, trace, control)
    drv = driver_mod.Driver(ctx, log)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = process_age_s()
    window = drv.window(seconds)
    setup_s = getattr(drv, "setup_s", None) or setup_s  # a trainer's first steps are set-up
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    refuse_jax()
    if trace:
        drv.profile()
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, control_numbers = drv.check()
    if control:  # the control in the program's place decides ``correct``
        log(f"the program's own readings, beside the control's: {numbers}")
        numbers = control_numbers
    compared = compare(numbers, cell.limits["limits"])
    correct = all(c["ok"] for c in compared.values()) and drv.failed == 0
    e2e = {"setup_s": {"value": setup_s, "unit": "s"}}
    e2e.update({k: {"value": v, "unit": u} for k, (v, u) in window.items()})
    result = {"correct": correct, "attempted": drv.attempted, "failed": drv.failed}
    if trace:
        result["metrics"] = read_metrics(cell.per_layer, drv)
    else:
        result["metrics"] = {m["name"]: e2e[m["name"]] for m in cell.end_to_end
                             if m["name"] in e2e}
    result["device"] = device_info(device, cell.chips, peak)
    if trace:
        summary = drv.trace_summary or {}
        log(f"trace: {summary.get('device_events')} device events in {summary.get('window_s')} s, "
            f"busy {summary.get('busy_s')} s; device s by range {summary.get('device_s')}; "
            f"calls {({k: len(v) for k, v in drv.kernel_calls.items()})}")
        result["device"]["busy_s"] = summary.get("busy_s", 0.0)
        result["device"]["window_s"] = summary.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    result["compared"] = {k: [c["value"], c["limit"]] for k, c in compared.items()}
    refuse_jax()
    return result


def main(argv=None) -> int:
    from benchmark.harness import faults

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the lower-precision control, put in the program's place, "
                         "instead of the program (limit setting: it must come out not correct)")
    ap.add_argument("--fault", default=None,
                    help="plant this fault of harness/faults.py in the port (limit setting)")
    args = ap.parse_args(argv)
    cell = find_cell(args.workload)
    try:
        device = card(cell.chips)
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    with (faults.planted(cell.traffic["entry"], args.fault) if args.fault
          else contextlib.nullcontext()):
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                          bool(args.control))
    print(f"run took {time.perf_counter() - t0:.1f} s after the imports", file=sys.stderr)
    for k, (value, limit) in result["compared"].items():
        print(f"compared {k}: {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
