"""Faults planted in the port underneath a whole run, to read what the
output check gives when the timed path is broken: the upper readings of a
training cell's limits (``run.py --fault <name>``) and the tests that see
``correct`` come out false.

Why it is here: a limit is set between what sound runs read and what a
broken path reads; this module is the one place that breaks the path, the
same way on the card and in the CPU tests. Each fault swaps one module
attribute of the port for the duration of the run.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch


def _guided_unchanged():
    from sketch2img_torch.pipelines import sketch_guided
    return sketch_guided, "guided_step", lambda fn: (lambda *a, **k: (a[6], a[7]))


def _guided_altered():
    from sketch2img_torch import runtime
    return runtime, "latents_to_image", lambda fn: (lambda vae, z: 1.0 - fn(vae, z))


def _sampler(change):
    from sketch2img_torch.pipelines import attn_injected

    def patch(make):
        def made(*a):
            ts, step = make(*a)
            return ts, change(step)
        return made
    return attn_injected, "make_sampler_step", patch


def _inject_unchanged():
    return _sampler(lambda step: (lambda i, x, eps, x0_prev: (x, x0_prev)))


def _inject_half():
    def change(step):
        def f(i, x, eps, x0_prev):  # half of the batch's eps left out, the rest's mean in its place
            n = eps.shape[0] // 2
            rest = eps[:n].mean(0, keepdim=True).expand(eps.shape[0] - n, -1, -1, -1)
            return step(i, x, torch.cat([eps[:n], rest]), x0_prev)
        return f
    return _sampler(change)


def _inject_altered():
    from sketch2img_torch.apps import clip_guided_inf
    return clip_guided_inf, "latents_to_image", lambda fn: (lambda vae, z: 1.0 - fn(vae, z))


def _train_unchanged():
    from sketch2img_torch.train import optim
    return optim.AdamW, "step", lambda fn: (lambda self, closure=None: None)


def _train_half():
    from sketch2img_torch.apps import train_lgp

    def patch(step):
        def half(lgp, opt, frozen, batch, **kw):  # the loss and update from half the rows
            n = batch["pixels"].shape[0] // 2
            return step(lgp, opt, frozen, {k: v[:n] for k, v in batch.items()}, **kw)
        return half
    return train_lgp, "lgp_train_step", patch


def _train_half_late():
    """Half the batch from the first step after the set-up's three on: a
    fault that only the window's steps can show."""
    from sketch2img_torch.apps import train_lgp

    def patch(step):
        seen = [0]

        def late(lgp, opt, frozen, batch, **kw):
            seen[0] += 1
            if seen[0] > 3:
                n = batch["pixels"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
            return step(lgp, opt, frozen, batch, **kw)
        return late
    return train_lgp, "lgp_train_step", patch


def _train_altered():
    from sketch2img_torch.apps import train_lgp
    return train_lgp, "lgp_train_step", lambda fn: (lambda *a, **k: fn(*a, **k) * 1.5)


FAULTS: Dict[str, Dict[str, Callable]] = {
    "guided": {"unchanged": _guided_unchanged, "altered": _guided_altered},
    "inject": {"unchanged": _inject_unchanged, "half": _inject_half,
               "altered": _inject_altered},
    "train_lgp": {"unchanged": _train_unchanged, "half": _train_half,
                  "half_late": _train_half_late, "altered": _train_altered},
}


@contextlib.contextmanager
def planted(entry: str, name: str):
    """The fault ``name`` of a cell whose traffic's entry is ``entry``, set
    for the block and taken out after it."""
    owner, attr, patch = FAULTS[entry][name]()
    fn = getattr(owner, attr)
    setattr(owner, attr, patch(fn))
    try:
        yield
    finally:
        setattr(owner, attr, fn)
