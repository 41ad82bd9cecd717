"""flash_roofline.<cell>: the flash kernels' share of their roofline over
the profiled part: the summed least time of the flash calls derived from
the configuration's shapes and the passes the profiled units make
(``counts.flash``, ``counts.flops``) over the device time of the kernels
launched inside the benchmark's ranges. The run fails where the calls
the program made differ from the derived ones."""

from benchmark.counts import flash
from benchmark.metrics._common import roofline_pct


def read(drv, suffix):
    return roofline_pct(drv, "flash", flash)
