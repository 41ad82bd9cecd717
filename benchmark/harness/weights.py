"""Seeded weights, made on the device in the dtype they are served in.

Why it is here: the benchmark makes the inputs of both sides itself, the
port's weights included, so the reference can work them out again from
the seed and take nothing the port made. Each module tree is drawn in one
call (``uniform_`` into one flat buffer), then each leaf is scaled in
place as PyTorch's initialisers scale it: a Linear, convolution or
transposed convolution weight and its bias to +-1/sqrt(fan_in) (the bound
of ``kaiming_uniform_(a=sqrt(5))``), a tree listed as ``kaiming`` (the
published LGP's initialiser) to +-sqrt(6/fan_in) with zero biases, norm
scales 1 and shifts 0, embeddings and free parameters to unit variance,
and the safety checker's thresholds to ``THRESHOLD``. Activations then
keep their scale through the UNet. Leaves are views into the flat buffer.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

_LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)
_NORMS = (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm1d, nn.InstanceNorm2d)
#: the safety checker's concept thresholds (cosine), near the published ones
THRESHOLD = 0.2


def _fan_in(w: torch.Tensor) -> int:
    return nn.init._calculate_fan_in_and_fan_out(w)[0]


def leaf_rules(module: nn.Module, kaiming: bool = False) -> List[Tuple[str, tuple, str, float]]:
    """(state-dict key, shape, "uniform" | "fill", bound or value) per leaf."""
    rules = []
    for mname, m in module.named_modules():
        prefix = mname + "." if mname else ""
        for name, t in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
            key, shape = prefix + name, tuple(t.shape)
            if isinstance(m, _LAYERS):
                fan = _fan_in(m.weight)
                if kaiming:
                    rule = ("uniform", math.sqrt(6.0 / fan)) if name == "weight" else ("fill", 0.0)
                else:
                    rule = ("uniform", 1.0 / math.sqrt(fan))
            elif isinstance(m, _NORMS):
                rule = ("fill", 1.0 if name in ("weight", "running_var") else 0.0)
            elif name.endswith("embeds_weights"):
                rule = ("fill", THRESHOLD)
            else:  # embeddings and free parameters: unit variance
                rule = ("uniform", math.sqrt(3.0))
            rules.append((key, shape, *rule))
    return rules


def tree_seed(seed: int, tree: str) -> int:
    """A generator seed for one module tree of one run, independent of the
    order in which trees are made."""
    return (int(seed) * 1_000_003 + zlib.crc32(tree.encode())) % (2 ** 62)


@torch.no_grad()
def make(module: nn.Module, seed: int, tree: str, dtype: torch.dtype, device,
         kaiming: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of ``module`` (any device, meta included) drawn from
    ``seed`` on ``device`` in ``dtype`` (integer buffers keep their dtype)."""
    rules = leaf_rules(module, kaiming)
    ref = module.state_dict()
    n_uniform = sum(math.prod(s) for _, s, kind, _ in rules if kind == "uniform")
    gen = torch.Generator(device=device).manual_seed(tree_seed(seed, tree))
    flat = torch.empty(n_uniform, dtype=dtype, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out, off = {}, 0
    for key, shape, kind, value in rules:
        if kind == "uniform":
            n = math.prod(shape)
            out[key] = flat[off:off + n].view(shape).mul_(value)
            off += n
        else:
            dt = ref[key].dtype if not ref[key].is_floating_point() else dtype
            out[key] = torch.full(shape, value, dtype=dt, device=device)
    return out
