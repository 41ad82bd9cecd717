"""Host-side data loader: shuffled epochs, per-process sharding and
background prefetch — a copy of ``sketch2img_tpu/data/loader.py`` (the port
imports nothing of the JAX package).

Per-process sharding takes (process_index, process_count) the way a per-rank
DistributedSampler would: every process shuffles the same epoch permutation
and keeps every process_count-th index from its own offset, so batch b of
all processes together holds the examples of a one-process batch b of
process_count x batch_size, interleaved. Every process runs ``len(self)``
batches an epoch (the JAX copy counts each process's own indices, which can
differ by one between processes and leave a collective waiting).
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Iterator, Optional

import numpy as np


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        pad_to: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_to = pad_to
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self._epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int) -> None:
        """Position the next ``__iter__`` at ``epoch`` (the epoch-seeded
        shuffle is deterministic, so a resumed run re-creates exactly the
        permutation the interrupted run was walking)."""
        self._epoch = int(epoch)

    def skip_batches(self, n: int) -> None:
        """Skip the first ``n`` batches of the NEXT ``__iter__`` only —
        resume-to-position: the skipped batches are never loaded from disk."""
        self._skip = int(n)

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = random.Random(self.seed + self._epoch)
            perm = list(idx)
            rng.shuffle(perm)
            idx = np.asarray(perm)
        return idx[self.process_index :: self.process_count]

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        self._epoch += 1
        skip, self._skip = self._skip, 0  # one-shot (resume positioning)
        n_batches = len(self)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def producer():
            try:
                for b in range(skip, n_batches):
                    sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    examples = [self.dataset[int(i)] for i in sel]
                    q.put(self.dataset.collate_fn(examples, pad_to=self.pad_to))
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
