"""The control of the output check: the reference computed one precision
below what a configuration states.

Why it is here: a comparison proves something only if it fails the step a
later change would be tempted by. For the bf16 modules that step is fp8:
``to_fp8`` rounds every Linear and convolution weight, and every input to
one, to float8 e4m3 with one scale per tensor (amax / 448), as a per-tensor
scaled fp8 matmul does, and computes the product in fp32. For the fp32
modules (the LGP, anime2sketch) the step is TF32, which the port keeps off:
``tf32`` turns it on for the calls made inside it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

_FP8_MAX = 448.0
_LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's dtype;
    the gradient passes the rounding unchanged (straight through), so a
    backward runs on the rounded weights."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / _FP8_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


def _quantize_input(module, args):
    return (fake_fp8(args[0]),) + tuple(args[1:])


def to_fp8(module: nn.Module) -> nn.Module:
    """Round ``module``'s layer weights to fp8 in place and round every
    layer input on the way in. -> ``module``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _LAYERS):
                m.weight.copy_(fake_fp8(m.weight))
                m.register_forward_pre_hook(_quantize_input)
    return module


@contextlib.contextmanager
def tf32():
    """TF32 for fp32 matmuls and convolutions inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
