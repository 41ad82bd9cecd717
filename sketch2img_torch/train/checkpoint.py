"""Training checkpoints — counterpart of ``sketch2img_tpu/train/checkpoint.py``.

A checkpoint is one ``torch.save`` file, ``<dir>/step_<N>.pt``, holding a
dict: the step, the trainables' state dicts (the LGP's includes its
BatchNorm buffers), the optimizer's state dict (its schedule count too) and
the step generator's state, so that a run resumed from it continues the
uninterrupted run exactly (``apps/train_lgp.py``). The newest ``keep`` are
kept. (The JAX package writes Orbax directories; the two do not read each
other's.)

``export_params_npz`` writes a model-only export in the JAX package's npz
format: a flat npz whose keys are the ``/``-joined paths of a parameter
tree (``core/convert.py``'s ``*_to_jax`` make the trees).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(f for f in os.listdir(directory) if _NAME.match(f))


def save_train_state(directory: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    """Write ``state`` (a dict of tensors, state dicts and numbers) to
    ``directory/step_<step>.pt`` (through a temporary file, so a killed save
    leaves the last good checkpoint) and delete all but the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for stale in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, stale))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest ``step_<N>.pt`` in ``directory``, or None."""
    steps = _steps(directory)
    return os.path.join(directory, steps[-1]) if steps else None


def restore_train_state(path: str, map_location="cpu") -> Dict[str, Any]:
    """The dict ``save_train_state`` wrote (tensors on ``map_location``); a
    directory reads its newest checkpoint."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no step_<N>.pt checkpoint in {path}")
        path = found
    return torch.load(path, map_location=map_location, weights_only=True)


def _flat(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def export_params_npz(path: str, params: Mapping) -> None:
    """A nested parameter tree -> a flat npz at ``path`` ("a/b/c" keys), as
    the JAX package's ``export_params_npz`` writes it and its
    ``load_params_npz`` reads it."""
    np.savez(path, **dict(_flat(params)))
