"""The fused non-stationary masks with their gradients (counterpart of
``noisereduce_tpu/ops/pallas_mask.py``).

``fused_nonstationary_mask`` runs kernel G on a frequency-major spectrogram
(TPU row 6, ``_fused_mask_cvjp``, ``:189``) and
``fused_nonstationary_mask_tm`` runs kernel B with one unit tap on
time-major re/im planes (TPU row 7, ``_fused_mask_tm_cvjp``, ``:332``).
Both are the ``custom_vjp`` contract of the JAX package: under grad the
value is still the kernel's, and the cotangent comes from the
differentiable twin, ``_mask_impl`` (``_jnp_mask_impl``, ``:152``) or
``_mask_impl_tm`` (``_jnp_mask_impl_tm``, ``:307``). Like the reference,
the twins give NaN on silence (a 0/0 floor ratio), where the kernels give
finite values.

A complex input's gradient follows torch's convention, the conjugate of
``jax.vjp``'s.
"""
from __future__ import annotations

import torch

from noisereduce_tpu_torch.ops.cuda.kernels import fm_nonstationary_mask, nonstationary_mask
from noisereduce_tpu_torch.ops.dsp import ewma_filtfilt, sigmoid
from noisereduce_tpu_torch.ops.precision import fused_with_twin

__all__ = ["fused_nonstationary_mask", "fused_nonstationary_mask_tm"]


def _mask_impl(Z, b, thresh_mult, slope):
    """Differentiable twin of kernel G: ``abs``, the filtfilt floor along
    the last axis, the sigmoid."""
    mag = torch.abs(Z)
    floor = ewma_filtfilt(mag, b)
    return sigmoid((mag - floor) / floor, -thresh_mult, slope)


def _mask_impl_tm(re, im, b, thresh_mult, slope):
    """Differentiable twin of kernel B with one unit tap, time-major."""
    mag = torch.sqrt(re * re + im * im)
    floor = ewma_filtfilt(mag, b, axis=-2)
    return sigmoid((mag - floor) / floor, -thresh_mult, slope)


def fused_nonstationary_mask(Z: torch.Tensor, b: float, thresh_mult: float,
                             slope: float) -> torch.Tensor:
    """|Z| -> filtfilt floor -> sigmoid mask of a frequency-major (..., F, T)
    spectrogram through kernel G: complex64, or a float32 magnitude plane;
    float32 mask of the same shape. Differentiable: the cotangent comes
    from ``_mask_impl``."""
    return fused_with_twin(
        lambda z: fm_nonstationary_mask(z.contiguous(), b, thresh_mult, slope),
        lambda z: _mask_impl(z, b, thresh_mult, slope),
        Z,
    )


def fused_nonstationary_mask_tm(re: torch.Tensor, im: torch.Tensor, b: float,
                                thresh_mult: float, slope: float) -> torch.Tensor:
    """The same mask of time-major (..., T, F) re/im planes through kernel B
    with one unit tap. Differentiable: the cotangent comes from
    ``_mask_impl_tm``."""
    def forward(r, i):
        T, nb = r.shape[-2:]
        m = nonstationary_mask(
            r.reshape(-1, T, nb).contiguous(), i.reshape(-1, T, nb).contiguous(),
            b, thresh_mult, slope, (1.0,),
        )
        return m.reshape(r.shape)

    return fused_with_twin(
        forward, lambda r, i: _mask_impl_tm(r, i, b, thresh_mult, slope), re, im
    )
