"""Recording of what the timed path's own calls received and produced.

Why it is here: the output check compares what the window computed, not a
second run. The recorder wraps module attributes that the port's entry
points call at call time and keeps references to their arguments and
results, one dict per request, for the steps drawn for checking. While a
request runs nothing is copied or synchronised; once it has returned (its
time taken), ``to_host`` moves what it kept to host memory, so the device's
memory does not grow over the window.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List

import torch


class Recorder:
    """Module-attribute wrappers that keep references to what the timed
    path's calls received and produced, per request."""

    def __init__(self):
        self.requests: List[Dict] = []
        self.current: Dict = {}
        self._saved = []

    def start(self, want: Iterable[int] = ()) -> None:
        """A new request whose steps ``want`` are kept."""
        self.current = {"steps": {}, "want": set(int(i) for i in want)}

    def finish(self) -> Dict:
        self.requests.append(self.current)
        return self.current

    def to_host(self) -> None:
        cur = self.current
        for k, v in cur.items():
            if isinstance(v, torch.Tensor):
                cur[k] = v.cpu()
        cur["steps"] = {i: tuple(t.cpu() for t in v) for i, v in cur["steps"].items()}

    def wrap(self, module, attr: str, record) -> None:
        fn = getattr(module, attr)
        self._saved.append((module, attr, fn))

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            record(self.current, args, kw, out)
            return out
        setattr(module, attr, wrapped)

    def remove(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()
