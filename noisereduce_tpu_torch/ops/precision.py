"""The fused-forward / staged-backward contract (counterpart of
``noisereduce_tpu/ops/precision.py::cotangent_vjp``, ``:65``, and of the
``jax.custom_vjp`` wrappers around the fused kernels).

Every fused entry point differentiates the same way: the value under grad is
the kernels' output, bitwise the serving value, and the cotangent comes from
the staged plain-torch twin, recomputed from the saved inputs in the
backward pass (rematerialization: the residuals are the inputs, not the
twin's intermediates). The backward pass launches no kernel.

The twin runs in the primals' own dtype. The JAX package casts float32
primals and the cotangent to bfloat16 on a TPU only (``:80-99``); that
precision setting has no counterpart here yet.
"""
from __future__ import annotations

import torch

__all__ = ["cotangent_vjp", "fused_with_twin"]


def cotangent_vjp(fn, primals, g):
    """The cotangent ``g`` of ``fn(*primals)`` pulled back to the primals:
    ``fn`` is recomputed on detached copies under ``torch.enable_grad()``.
    A primal that ``fn`` does not use gets zeros; a None primal gets
    None."""
    args = tuple(None if p is None else p.detach().requires_grad_() for p in primals)
    with torch.enable_grad():
        out = fn(*args)
    live = [a for a in args if a is not None]
    grads = iter(torch.autograd.grad(out, live, g, allow_unused=True))
    res = []
    for a in args:
        if a is None:
            res.append(None)
            continue
        gr = next(grads)
        res.append(torch.zeros_like(a) if gr is None else gr)
    return tuple(res)


class _FusedWithTwin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward, twin, *primals):
        ctx.twin = twin
        ctx.save_for_backward(*primals)
        return forward(*primals)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + cotangent_vjp(ctx.twin, ctx.saved_tensors, g)


def fused_with_twin(forward, twin, *primals):
    """``forward(*primals)`` (the kernels) as the value, with the cotangent
    of ``twin(*primals)`` (the staged plain path) as its gradient. Only
    when autograd records the call: otherwise ``forward`` runs as it is,
    so a serving call takes exactly the path it took before."""
    if not (torch.is_grad_enabled()
            and any(p is not None and p.requires_grad for p in primals)):
        return forward(*primals)
    return _FusedWithTwin.apply(forward, twin, *primals)
