"""Device resolution and numeric settings for the port's entry points.

``"cuda"`` is the default everywhere and raises when no GPU is present:
there is no silent fall back to the CPU. The CPU runs only when the caller
passes ``device="cpu"`` (the tests do).

Every entry point that puts models on a device (the ``SDComponents``
constructors, both pipelines, the trainers, the process group) calls
``set_precision`` and ``set_deterministic``: the same inputs and seed then
give the same bits on the card, as they do in the JAX package.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_precision() -> None:
    """fp32 matmuls and convolutions in full fp32 on the card (no TF32).

    PyTorch's defaults differ between the two (``matmul.allow_tf32`` False,
    ``cudnn.allow_tf32`` True); both are set here so the fp32 parts of the
    path — the LGP head, the guidance step — keep fp32 arithmetic. The UNet,
    VAE and text encoder run in their compute dtype (bf16 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_deterministic(device: Union[str, torch.device]) -> None:
    """Bit-repeatable results on a CUDA device: cuDNN takes deterministic
    algorithms only, and chooses them by its heuristics (no benchmarking,
    which could pick another algorithm in another process).

    Without it cuDNN's backward-data and backward-filter algorithms may sum in
    a varying order, so the guided backward's gradient, and with it every
    later step of a sketch-guided request, differs from run to run. This flag
    is enough on the port's routes: the hand-written kernels sum in a fixed
    order, cuBLAS is deterministic on one stream, and the one PyTorch op on a
    backward that adds with atomics (bilinear upsampling) has a deterministic
    backward in ``ops/resize.py``. A CPU device is left alone."""
    if torch.device(device).type != "cuda":
        return
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def current_stream_handle(device: torch.device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device`` (a CUDA device
    with an index), for a kernel launched through ctypes. The raw getter
    skips building a ``torch.cuda.Stream`` object, a few microseconds a call
    on the wrappers' hot path."""
    return torch._C._cuda_getCurrentRawStream(device.index)
