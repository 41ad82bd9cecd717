"""Aspect-ratio bucketing (ARB) — a copy of ``sketch2img_tpu/data/arb.py``
(the port imports nothing of the JAX package); the ``arb:`` block of
``train.yaml``. NovelAI-style scheme:

  * generate bucket resolutions (w, h), both divisible by ``divisible``,
    with area <= base_res area, dims within [min_dim, dim_limit]
    (plus the max_size resolution itself);
  * assign each image to the bucket with the closest log-aspect-ratio,
    skipping images whose AR error exceeds ``max_ar_error``;
  * batch within a bucket — each distinct bucket shape is one batch
    shape for the train step.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple


def generate_buckets(
    base_res: Sequence[int] = (512, 512),
    max_size: Sequence[int] = (768, 512),
    divisible: int = 64,
    min_dim: int = 256,
    dim_limit: int = 1024,
) -> List[Tuple[int, int]]:
    """-> sorted list of (width, height) buckets."""
    max_area = base_res[0] * base_res[1]
    buckets = {tuple(base_res), (int(max_size[0]), int(max_size[1])),
               (int(max_size[1]), int(max_size[0]))}
    w = min_dim
    while w <= dim_limit:
        h = (max_area // w) // divisible * divisible
        h = min(h, dim_limit)
        if h >= min_dim:
            buckets.add((w, h))
            buckets.add((h, w))
        w += divisible
    return sorted(buckets)


def assign_bucket(
    width: int,
    height: int,
    buckets: Sequence[Tuple[int, int]],
    max_ar_error: float = 4.0,
) -> Optional[Tuple[int, int]]:
    """Closest-log-AR bucket, or None when the AR error exceeds the cap."""
    ar = math.log(width / height)
    best, best_err = None, float("inf")
    for bw, bh in buckets:
        err = abs(ar - math.log(bw / bh))
        if err < best_err:
            best, best_err = (bw, bh), err
    if best is None or best_err > max_ar_error:
        return None
    return best


class BucketBatcher:
    """Groups dataset indices by bucket and yields (bucket, index-batch)
    pairs in shuffled order; incomplete tails are dropped (static shapes)."""

    def __init__(self, assignments: Dict[int, Tuple[int, int]], batch_size: int,
                 seed: int = 0):
        self.assignments = assignments
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int) -> None:
        """Position the next ``__iter__`` at ``epoch`` (deterministic
        epoch-seeded shuffle — same resume contract as data.Loader)."""
        self._epoch = int(epoch)

    def skip_batches(self, n: int) -> None:
        """Skip the first ``n`` batches of the NEXT ``__iter__`` only
        (resume-to-position; the skipped batches are never loaded)."""
        self._skip = int(n)

    def __iter__(self):
        rng = random.Random(self.seed + self._epoch)
        self._epoch += 1
        skip, self._skip = self._skip, 0
        by_bucket: Dict[Tuple[int, int], List[int]] = {}
        for idx, bucket in self.assignments.items():
            by_bucket.setdefault(bucket, []).append(idx)
        batches = []
        for bucket, idxs in by_bucket.items():
            rng.shuffle(idxs)
            for i in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
                batches.append((bucket, idxs[i : i + self.batch_size]))
        rng.shuffle(batches)
        return iter(batches[skip:])

    def __len__(self):
        by_bucket: Dict[Tuple[int, int], int] = {}
        for bucket in self.assignments.values():
            by_bucket[bucket] = by_bucket.get(bucket, 0) + 1
        return sum(n // self.batch_size for n in by_bucket.values())
