"""Tensor parallelism of the UNet's attention over the ``model`` axis —
counterpart of ``sketch2img_tpu/parallel/tp.py``.

Megatron's split, as the JAX package shards it:

  * ``to_q`` / ``to_k`` / ``to_v``: column-sharded by whole heads — each
    rank keeps ``heads / m`` heads (rows of the PyTorch weight, which is
    (out, in)), so the attention itself needs no communication: the flash
    kernels run on the local heads, (B, heads / m, N, d);
  * ``to_out``: row-sharded (columns of the PyTorch weight) — each rank's
    product is a partial sum, all-reduced over the model group, and the
    bias (replicated) is added once after the sum;
  * everything else replicated, the GEGLU ``proj_in`` included: it
    interleaves value and gate halves in its output, so a column shard would
    cut the gate across ranks.

GSPMD derives the backward of the JAX version; here the two collectives are
written as ``torch.autograd.Function``s, Megatron's pair: ``copy_to_model``
(identity forward, all-reduce of the gradient backward) at the input of the
q/k/v projections, so each rank's input gradient gets the other ranks' heads'
share, and ``reduce_from_model`` (all-reduce forward, identity backward)
after ``to_out``, whose output gradient is already the same on every rank.
A plain differentiable all-reduce in both places would scale a replicated
term's gradient by ``m``.

An attention module whose head count does not divide by ``m`` stays whole
and takes the replicated path, as the JAX package's sites do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from sketch2img_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce_

_COL_SHARDED = ("to_q", "to_k", "to_v")   # weight (heads * d, in): rows split
_ROW_SHARDED = ("to_out",)                # to_out.0.weight (out, heads * d): columns split


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group`` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` all-reduced (summed) over ``group``; the gradient passes as it is."""
    return _ReduceFromModel.apply(x, group)


def _attention_modules(module: nn.Module):
    """(name, module) of every attention with ``to_q``/``to_k``/``to_v``/
    ``to_out`` projections and a ``heads`` count."""
    for name, m in module.named_modules():
        if all(hasattr(m, a) for a in _COL_SHARDED + _ROW_SHARDED + ("heads",)):
            yield name, m


def tp_param_specs(module: nn.Module, model_parallel: int = 2) -> Dict[str, Tuple]:
    """{parameter name: spec} over ``module``'s parameters, in PyTorch's
    (out, in) layout: (MODEL_AXIS, None) for a q/k/v weight (rows split),
    (None, MODEL_AXIS) for a ``to_out`` weight (columns split), () for every
    other parameter (replicated, ``to_out``'s bias included). An attention
    whose heads do not divide by ``model_parallel`` stays replicated."""
    specs = {n: () for n, _ in module.named_parameters()}
    for name, m in _attention_modules(module):
        if m.heads % model_parallel:
            continue
        prefix = name + "." if name else ""
        for proj in _COL_SHARDED:
            specs[f"{prefix}{proj}.weight"] = (MODEL_AXIS, None)
        specs[f"{prefix}to_out.0.weight"] = (None, MODEL_AXIS)
    return specs


def shard_params_tp(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Slice every qualifying attention of ``module`` to this rank's heads
    (``tp_param_specs``), in place, and set its local head count and its
    ``tp_size``; the rest stays as it is (replicated). Run it after the
    weights are replicated (``shard_params``). -> ``module``."""
    m_size, r = mesh.shape[MODEL_AXIS], mesh.model_index
    if m_size == 1:
        return module
    with torch.no_grad():
        for _, att in _attention_modules(module):
            if att.heads % m_size:
                continue
            for proj in _COL_SHARDED:
                lin = getattr(att, proj)
                n = lin.weight.shape[0] // m_size
                lin.weight = nn.Parameter(lin.weight[r * n:(r + 1) * n].clone(),
                                          requires_grad=lin.weight.requires_grad)
                lin.out_features = n
            out = att.to_out[0]
            n = out.weight.shape[1] // m_size
            out.weight = nn.Parameter(out.weight[:, r * n:(r + 1) * n].clone(),
                                      requires_grad=out.weight.requires_grad)
            out.in_features = n
            att.heads //= m_size
            att.tp_size = m_size
    return module
