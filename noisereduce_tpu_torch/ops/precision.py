"""The fused-forward / staged-backward contract and the cotangent-precision
setting (counterpart of ``noisereduce_tpu/ops/precision.py``, ``:46-99``,
and of the ``jax.custom_vjp`` wrappers around the fused kernels).

Every fused entry point differentiates the same way: the value under grad is
the kernels' output, bitwise the serving value, and the cotangent comes from
the staged plain-torch twin, recomputed from the saved inputs in the
backward pass (rematerialization: the residuals are the inputs, not the
twin's intermediates). The backward pass launches no kernel.

``NRTPU_COTANGENT_PRECISION`` (``bf16`` | ``default`` | ``high`` |
``highest``; ``bf16`` when unset) sets the precision of the gate-level
cotangents, as in the JAX package. ``bf16`` casts float32 primals and the
incoming cotangent to bfloat16 where the primals are on the card, runs the
twin in bfloat16 (its mask decisions in float32, ``dsp.mask_dtype``) and
casts the gradients back to the primals' dtypes: the mixed-precision
training trade, within 5e-2 x max|g| of the uncast cotangent for the
soft masks (non-stationary and torch-convention gates) and within the
bf16 mode's 1.5e-1 for the stationary gates, whose binary decisions flip
on bf16 spectra (``tests/test_torch_cotangent_precision.py``). On the CPU it never casts,
so the CPU cotangents are the uncast twin's, bitwise, in every mode. The
twin has no operation whose precision PyTorch lowers (no matmul and no
convolution: ``torch.fft`` and shifted slices, ``ops/dsp.py``), so
``default``, ``high`` and ``highest`` all give the uncast cotangent,
bitwise; ``highest`` is the way to ask for it on the card. The setting
applies where the JAX package calls ``cotangent_vjp``: the gate-level
entries (``ops/cuda/dispatch.py``, ``ops/cuda/torch_dispatch.py``). The
row 6 and row 7 masks (``ops/cuda_mask.py``) differentiate with a plain
``jax.vjp`` there, and the stationary threshold
(``dispatch.fused_stationary_threshold``) has no ``cotangent_vjp``: they
pass ``cast_cotangent=False`` here.
"""
from __future__ import annotations

import os

import torch

__all__ = ["cotangent_vjp", "fused_with_twin"]

_MODES = ("bf16", "default", "high", "highest")


def _cotangent_mode() -> str:
    name = os.environ.get("NRTPU_COTANGENT_PRECISION", "bf16").lower()
    if name not in _MODES:
        raise ValueError(
            f"NRTPU_COTANGENT_PRECISION={name!r}: use bf16|default|high|highest"
        )
    return name


def _on_card(primals) -> bool:
    """Whether the primals are on the card (the JAX package's
    ``_tpu_available()`` gate of the cast)."""
    return any(p is not None and p.device.type == "cuda" for p in primals)


def cotangent_vjp(fn, primals, g, cast_cotangent: bool = True):
    """The cotangent ``g`` of ``fn(*primals)`` pulled back to the primals:
    ``fn`` is recomputed on detached copies under ``torch.enable_grad()``.
    A primal that ``fn`` does not use gets zeros; a None primal gets None.
    With ``cast_cotangent`` the mode ``bf16`` casts float32 primals on the
    card and ``g`` to bfloat16, and the gradients back."""
    cast = (
        cast_cotangent
        and _cotangent_mode() == "bf16"
        and _on_card(primals)
        and all(p is None or p.dtype == torch.float32 for p in primals)
    )

    def prep(p):
        p = p.detach()
        return (p.to(torch.bfloat16) if cast else p).requires_grad_()

    args = tuple(None if p is None else prep(p) for p in primals)
    with torch.enable_grad():
        out = fn(*args)
    live = [a for a in args if a is not None]
    grads = iter(torch.autograd.grad(out, live, g.to(out.dtype), allow_unused=True))
    res = []
    for a, p in zip(args, primals):
        if a is None:
            res.append(None)
            continue
        gr = next(grads)
        res.append(torch.zeros_like(p) if gr is None else gr.to(p.dtype))
    return tuple(res)


class _FusedWithTwin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward, twin, cast_cotangent, *primals):
        ctx.twin = twin
        ctx.cast_cotangent = cast_cotangent
        ctx.save_for_backward(*primals)
        return forward(*primals)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) + cotangent_vjp(
            ctx.twin, ctx.saved_tensors, g, ctx.cast_cotangent)


def fused_with_twin(forward, twin, *primals, cast_cotangent: bool = True):
    """``forward(*primals)`` (the kernels) as the value, with the cotangent
    of ``twin(*primals)`` (the staged plain path) as its gradient, at the
    ``NRTPU_COTANGENT_PRECISION`` setting where ``cast_cotangent`` (the
    gate-level sites; False for the row 6 and row 7 masks). Only when
    autograd records the call: otherwise ``forward`` runs as it is, so a
    serving call takes exactly the path it took before."""
    if not (torch.is_grad_enabled()
            and any(p is not None and p.requires_grad for p in primals)):
        return forward(*primals)
    return _FusedWithTwin.apply(forward, twin, cast_cotangent, *primals)
