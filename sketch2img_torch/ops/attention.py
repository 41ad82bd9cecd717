"""Multi-head attention over projected q/k/v — counterpart of
``sketch2img_tpu/ops/attention.py::multi_head_attention``.

Sites whose shapes pass the flash gate (``flash_attention.preferred``: no
mask, at least 128 queries and 128 keys, head dim <= 256 — the UNet
self-attentions at 64^2, 32^2 and 16^2) go through the flash kernels: a CUDA
tensor launches them, a CPU tensor takes their plain version. Every other
site (cross-attention over 77 text tokens, the 8^2 mid attention, the CLIP
text encoder's causal attention, the VAE's single-head attention) runs the
plain path: matmul, fp32 softmax, matmul.

Tensor parallelism (``parallel/tp.py``): ``set_tensor_parallel_context(mesh)``
names the mesh whose model group the head-sharded attention modules reduce
over. A sharded module projects only its local heads, so the flash sites
run the kernels on (B, heads / m, N, d) with no collective inside the
attention; a site whose heads do not divide by m was left whole and runs
replicated, unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from sketch2img_torch.ops import flash_attention as fa

_DEFAULT_BACKEND = "auto"
# the mesh of tensor-parallel serving (its model group), or None
_TP_CONTEXT = None


def set_tensor_parallel_context(mesh=None) -> None:
    """Enable (or clear, with None) head-sharded attention over ``mesh``'s
    model axis: the attention modules ``parallel.shard_params_tp`` sliced to
    their local heads reduce their ``to_out`` products over its model
    group."""
    global _TP_CONTEXT
    _TP_CONTEXT = mesh


def tensor_parallel_group(size: int):
    """The model group of the context's mesh, which must have ``size``
    ranks on its model axis (a module sliced for ``size`` ranks cannot run
    under another or no context)."""
    mesh = _TP_CONTEXT
    got = None if mesh is None else mesh.shape["model"]
    if got != size:
        raise RuntimeError(f"an attention sliced for {size} model ranks runs under a tensor-"
                           f"parallel context of {got}: call set_tensor_parallel_context(mesh)")
    return mesh.model_group


def set_default_attention_backend(backend: str) -> None:
    """Backend of every ``multi_head_attention`` call that names none:
    "auto" (the default) or "plain" (every site on the plain path, for
    holding the kernels' end-to-end effect against a reference run)."""
    global _DEFAULT_BACKEND
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown default attention backend {backend!r}")
    _DEFAULT_BACKEND = backend


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, Nq, d) x (B, H, Nk, d): logits and softmax in fp32, the
    weights cast back to v's dtype for the second product."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    *,
    mask: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (B, N, H*d) projections -> (B, Nq, H*d).

    ``mask``: additive bias broadcastable to (B, H, Nq, Nk). ``kv_len``: true
    key count when k/v carry a padded tail (keys >= kv_len are masked).
    ``backend``: "auto" (flash where ``preferred``), "flash" (flash where
    ``supported``, else raise) or "plain"; None takes the module default."""
    backend = backend or _DEFAULT_BACKEND
    if backend not in ("auto", "flash", "plain"):
        raise ValueError(f"unknown attention backend {backend!r}")
    d = q.shape[-1] // num_heads
    scale = d ** -0.5
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    if kv_len is not None and kv_len >= k.shape[1]:
        kv_len = None  # no padded tail

    if backend != "plain":
        gate = fa.supported if backend == "flash" else fa.preferred
        if gate(qh, kh, vh, mask):
            return _merge_heads(fa.flash_attention(qh, kh, vh, scale, None, kv_len))
        if backend == "flash":
            raise ValueError(f"flash attention does not take q={tuple(q.shape)} "
                             f"k={tuple(k.shape)} with mask={mask is not None}")
    if kv_len is not None:
        tail = torch.zeros(k.shape[1], device=q.device, dtype=torch.float32)
        tail[kv_len:] = -1e30
        tail = tail.view(1, 1, 1, -1)
        mask = tail if mask is None else mask + tail
    return _merge_heads(plain_attention(qh, kh, vh, scale, mask))
