"""Parameter dtype utilities — counterpart of ``sketch2img_tpu/utils/params.py``.

Serving casts the float weights to the compute dtype once, outside the loop
(``SDComponents.cast_params`` does it for the loaded modules); training keeps
fp32 master weights and never calls this.
"""

from __future__ import annotations

from typing import Dict

import torch


def cast_float_params(state_dict: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A state dict with every floating-point tensor cast to ``dtype``;
    integer tensors (BatchNorm's ``num_batches_tracked``) and non-tensor
    entries pass through untouched."""
    return {k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
            for k, v in state_dict.items()}
