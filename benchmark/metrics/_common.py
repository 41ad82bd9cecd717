"""Helpers the readers share."""

from __future__ import annotations

from typing import Optional

from benchmark.counts import flash


def range_device_s(drv, layer: str) -> Optional[float]:
    """Device seconds of the kernels that ran inside ``layer``'s ranges
    (their device-side spans) in the profiled part."""
    summary = getattr(drv, "trace_summary", None) or {}
    return summary.get("device_s", {}).get(layer) or None


def roofline_pct(drv, layer: str, counts) -> Optional[float]:
    """A kernel layer's share of its roofline over the profiled part: the
    summed least time of the calls derived from the configuration and the
    passes (``drv.profiled_work``) over the device time inside the layer's
    ranges. Raises ``counts.flash.CountMismatch`` when the calls the
    program made, as rows of batch and heads, are not the derived ones."""
    work = getattr(drv, "profiled_work", None)
    if work is None:
        return None
    derived = getattr(work, layer)
    recorded = getattr(drv, "kernel_calls", {}).get(layer, [])
    flash.check_calls(layer, counts.rows(derived), counts.rows(recorded))
    spent = range_device_s(drv, layer)
    if not derived or not spent:
        return None
    return 100.0 * counts.total_bound_s(derived) / spent
