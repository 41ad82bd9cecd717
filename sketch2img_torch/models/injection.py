"""Injection states of the sketch (residual-KV) variant — counterpart of
``sketch2img_tpu/models/injection.py``.

The SketchEncoder's per-down-block residual tuples
(``UNet2DCondition.down_residuals``) are handed to the UNet's
TransformerBlocks in ``named_modules`` order (down, mid, up). The
reference's literal mapping (down = (r0, r1) per block, up += (r0, r1, r1),
total = down + reversed(up) + (last residual,)) gives two SD1.5 blocks a
feature of the wrong width; as in the JAX package (PARITY.md deviation 2),
each block takes the first unused feature of its own channel width in that
order, reusing one when none is left.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sketch2img_torch.models.unet import UNetConfig, transformer_block_dims


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def build_sketch_injection_states(config: UNetConfig,
                                  res_samples: Sequence[Tuple[torch.Tensor, ...]]
                                  ) -> List[torch.Tensor]:
    """``res_samples``: ``down_residuals`` output on the sketch (one tuple
    per down block: L resnet outputs, plus the downsampler's where there is
    one). Returns one (B, N_i, C_i) tensor per TransformerBlock."""
    L = config.layers_per_block
    down: List[torch.Tensor] = []
    up: List[torch.Tensor] = []
    for block in res_samples:
        if len(block) == L + 1:  # blocks with a downsampler
            down += list(block[:L])
            up += list(block[:L]) + [block[L - 1]]
    ordered = down + up[::-1] + [res_samples[-1][-1]]
    pool = list(ordered)
    states: List[torch.Tensor] = []
    for want in transformer_block_dims(config):
        j = next((j for j, cand in enumerate(pool) if cand.shape[1] == want), None)
        if j is not None:
            states.append(_tokens(pool.pop(j)))
        else:
            states.append(_tokens(next(p for p in ordered if p.shape[1] == want)))
    return states
