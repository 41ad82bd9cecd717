"""device_idle_pct.<cell>: the share of the profiled part's wall time in
which no kernel, copy or set ran on the device (the union of their
intervals, not their sum)."""


def read(drv, suffix):
    s = getattr(drv, "trace_summary", None) or {}
    if not s.get("window_s") or not s.get("device_events"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
