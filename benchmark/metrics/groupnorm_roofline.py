"""groupnorm_roofline.<cell>: the GroupNorm+SiLU kernels' share of their
(bytes) roofline over the profiled part, as ``flash_roofline``."""

from benchmark.counts import groupnorm
from benchmark.metrics._common import roofline_pct


def read(drv, suffix):
    return roofline_pct(drv, "groupnorm", groupnorm)
