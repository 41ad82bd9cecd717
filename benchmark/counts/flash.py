"""Work and least time of one flash-attention call, from its logical shape
(batch, heads, queries, true key count, head dim), and the sites the
port's kernels take.

Why it is here: the roofline share of the port's flash kernels is this
bound over their measured device time; the bound is the algorithm's, not
the kernels'. Forward: 4·B·H·nq·kv·d tensor FLOPs (two products); backward:
10·B·H·nq·kv·d (five products, S recomputed once). Bytes: each input read
once and each output written once, bf16 tensors and fp32 LSE: forward
Q, K, V -> O, LSE; backward Q, K, V, O, dO, LSE -> dQ, dK, dV. Least time:
max(FLOPs / 989e12, bytes / 3.35e12), with no exponential term. The calls
come from the configuration's shapes and the passes a unit makes
(``counts.flops``); the calls the program makes only cross-check them.
"""

from __future__ import annotations

import collections
from typing import Iterable, Tuple

from benchmark.counts.peaks import FLOPS, HBM_BYTES

BF16 = 2
#: the attention calls the port's flash kernels take: no additive mask, at
#: least this many queries and keys, a head dim of at most MAX_HEAD_DIM
MIN_QUERIES = MIN_KEYS = 128
MAX_HEAD_DIM = 256


class CountMismatch(RuntimeError):
    """The kernel calls a traced run recorded are not the derived ones."""


def is_site(nq: int, nk: int, d: int, masked: bool) -> bool:
    return not masked and nq >= MIN_QUERIES and nk >= MIN_KEYS and d <= MAX_HEAD_DIM


def work(kind: str, b: int, h: int, nq: int, kv: int, d: int) -> Tuple[float, float]:
    """-> (tensor FLOPs, bytes) of one call; ``kind`` "fwd" or "bwd"."""
    bh = b * h
    if kind == "fwd":
        return 4.0 * bh * nq * kv * d, bh * ((2 * nq + 2 * kv) * d * BF16 + nq * 4)
    if kind == "bwd":
        return (10.0 * bh * nq * kv * d,
                bh * ((4 * nq + 4 * kv) * d * BF16 + nq * 4))
    raise ValueError(f"unknown flash call {kind!r}")


def bound_s(kind: str, b: int, h: int, nq: int, kv: int, d: int) -> float:
    flops, nbytes = work(kind, b, h, nq, kv, d)
    return max(flops / FLOPS["bfloat16"], nbytes / HBM_BYTES)


def total_bound_s(calls: Iterable[Tuple]) -> float:
    """Summed least time of calls (kind, B, H, nq, kv, d)."""
    return sum(bound_s(*c) for c in calls)


def rows(calls: Iterable[Tuple]) -> collections.Counter:
    """Calls (kind, B, H, nq, kv, d) -> how many (batch row x head) of each
    (kind, nq, kv, d): the same for one call at B=2 as for two at B=1."""
    out: collections.Counter = collections.Counter()
    for kind, b, h, nq, kv, d in calls:
        out[(kind, nq, kv, d)] += b * h
    return out


def check_calls(layer: str, derived: collections.Counter, recorded: collections.Counter) -> None:
    """Raise ``CountMismatch`` naming the rows that differ."""
    if derived != recorded:
        keys = sorted(set(derived) | set(recorded), key=str)
        diff = [(k, derived.get(k, 0), recorded.get(k, 0)) for k in keys
                if derived.get(k, 0) != recorded.get(k, 0)]
        raise CountMismatch(f"{layer}: the calls derived from the configuration and the "
                            f"passes (shape, derived, recorded) differ from the program's "
                            f"calls: {diff[:8]}")
