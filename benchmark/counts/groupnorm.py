"""Least time of one GroupNorm(+SiLU) call: its bytes over HBM bandwidth.

Why it is here: the kernel is bound by memory; its ~10 fp32 operations an
element are far below the byte time. Bytes: x read once, y written once,
gamma and beta read once, in the call's element size. A call is
(B, C, H*W, element bytes), from the configuration's shapes
(``counts.flops``).
"""

from __future__ import annotations

import collections
from typing import Iterable, Tuple

from benchmark.counts.peaks import HBM_BYTES


def bound_s(b: int, c: int, spatial: int, elem_bytes: int) -> float:
    return (2 * b * c * spatial + 2 * c) * elem_bytes / HBM_BYTES


def total_bound_s(calls: Iterable[Tuple]) -> float:
    return sum(bound_s(*c) for c in calls)


def rows(calls: Iterable[Tuple]) -> collections.Counter:
    """Calls -> how many batch rows of each (C, H*W, element bytes)."""
    out: collections.Counter = collections.Counter()
    for b, c, spatial, elem in calls:
        out[(c, spatial, elem)] += b
    return out
