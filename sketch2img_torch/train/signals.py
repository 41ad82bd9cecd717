"""Checkpoint-on-signal — a copy of ``sketch2img_tpu/train/signals.py`` (the
port imports nothing of the JAX package).

A SIGTERM/SIGINT (the preemption notice of most schedulers) sets a flag;
the training loop observes it at the next step boundary, saves one final
checkpoint and exits cleanly. Handlers only flag: all saving happens on the
main thread at a step boundary.
"""

from __future__ import annotations

import signal
from typing import Callable, Iterable, Optional


class GracefulShutdown:
    """Context manager: install handlers that record a shutdown request.

    Usage::

        with GracefulShutdown() as stop:
            for batch in loader:
                ...
                if stop.requested:
                    save_checkpoint(...)
                    break

    A second signal while shutdown is pending re-raises the default
    behavior (so a stuck save can still be killed).
    """

    def __init__(
        self,
        signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
        on_signal: Optional[Callable[[int], None]] = None,
    ):
        self._signals = tuple(signals)
        self._on_signal = on_signal
        self._previous = {}
        self.requested = False
        self.signum: Optional[int] = None

    def _handler(self, signum, frame):
        if self.requested:  # second signal: restore + re-raise default
            signal.signal(signum, self._previous.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = signum
        if self._on_signal is not None:
            self._on_signal(signum)

    def __enter__(self) -> "GracefulShutdown":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return False
