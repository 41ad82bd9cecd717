"""mfu.<cell>: the whole request's or step's share of the chip's peak.

Each unit of work (a request or a training step) is charged its FLOPs,
counted on the fp32 reference at the cell's shapes (``counts.flops``), at
the peak of the dtype the configuration states for each part; the share is
that least time over the measured time of the traced window's units. The
host's time counts, so a host-bound cell reads low. Moves the cell's own
end-to-end metric.
"""

from benchmark.counts.peaks import FLOPS


def read(drv, suffix):
    work, secs = getattr(drv, "work", None), getattr(drv, "unit_seconds", None)
    if work is None or not work.flops or not secs:
        return None
    least = sum(f / FLOPS[dtype] for dtype, f in work.flops.items())
    return 100.0 * least * len(secs) / sum(secs)
