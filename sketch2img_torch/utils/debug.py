"""Numeric tripwires — counterpart of ``sketch2img_tpu/utils/debug.py``."""

from __future__ import annotations

import torch


def enable_nan_checks() -> None:
    """``torch.autograd.set_detect_anomaly(True)``, for debug runs: each
    autograd op's backward raises when it returns NaN, and the error names
    the forward op that made it. It checks the backward of autograd-recorded
    ops (and keeps their forward traces), not the output of every op as
    ``jax_debug_nans`` does; ``assert_tree_finite`` checks values."""
    torch.autograd.set_detect_anomaly(True)


def _leaves(tree, path):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over nested dicts, lists, tuples, tensors and
    modules (their state dicts): raises ``FloatingPointError`` naming the
    first leaf with a NaN or an infinity, as the JAX package's does."""
    for path, leaf in _leaves(tree, ()):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            continue
        if not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}:{'/'.join(path)}")
