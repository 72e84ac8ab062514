"""Elementwise and small-filter DSP ops in plain torch (counterpart of
``noisereduce_tpu/ops/dsp.py``, the subset the non-stationary gate uses).

The 'same' convolutions are written as sums of shifted slices rather than
``conv1d``: on a CUDA card a float32 ``conv1d`` goes through cuDNN in TF32
by default (about three decimal digits), and these are the plain versions
the kernels are held against.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "sigmoid",
    "triangular_vector",
    "tri_norm",
    "conv_same",
    "smooth_mask",
    "ewma_filtfilt",
]


def sigmoid(x: torch.Tensor, shift: float, mult: float) -> torch.Tensor:
    """``1 / (1 + exp(-(x + shift) * mult))`` (spectralgate/utils.py:4-8)."""
    return torch.sigmoid((x + shift) * mult)


@functools.lru_cache(maxsize=None)
def triangular_vector(n_grad: int) -> np.ndarray:
    """Length-(2n+1) symmetric triangular ramp, unnormalized float64:
    [1,...,n]/(n+1), 1, [n,...,1]/(n+1) (spectralgate/base.py:14-27)."""
    up = np.linspace(0.0, 1.0, n_grad + 1, endpoint=False)
    down = np.linspace(1.0, 0.0, n_grad + 2)
    return np.concatenate([up, down])[1:-1]


@functools.lru_cache(maxsize=None)
def tri_norm(n_grad: int) -> np.ndarray:
    """Normalized triangular taps (float64, length 2n+1); ``n_grad == 0``
    gives the identity tap [1.0] (that axis unsmoothed). The reference's
    2-D filter outer(v_f, v_t)/sum is rank-1, so it factors into these two
    1-D filters (cf. geometry.py::_tri_norm_np, kept here in float64 so the
    float64 parity mode is exact)."""
    if n_grad == 0:
        return np.ones(1)
    v = triangular_vector(n_grad)
    return v / v.sum()


def conv_same(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """'same' cross-correlation of ``x`` along ``dim`` with odd-length
    ``taps``, reading zeros outside the axis:
    out[i] = sum_d taps[d] * x[i + d - n], n = len(taps)//2."""
    n = len(taps) // 2
    if n == 0:
        return x * float(taps[0])
    length = x.shape[dim]
    xm = x.movedim(dim, -1)
    xp = F.pad(xm, (n, n))
    out = xp[..., 0:length] * float(taps[0])
    for d in range(1, len(taps)):
        out = out + xp[..., d : d + length] * float(taps[d])
    return out.movedim(-1, dim)


def smooth_mask(
    mask: torch.Tensor, n_grad_freq: int, n_grad_time: int,
    time_major: bool = False,
) -> torch.Tensor:
    """Smooth a (..., freq, time) mask, or (..., time, freq) with
    ``time_major``, with the normalized triangular filter: the reference's
    ``fftconvolve(mask, outer(v_f, v_t)/sum, mode='same')``
    (nonstationary.py:78-81) as two separable 1-D passes."""
    fdim, tdim = (-1, -2) if time_major else (-2, -1)
    out = conv_same(mask, tri_norm(n_grad_freq), fdim)
    return conv_same(out, tri_norm(n_grad_time), tdim)


def _ewma_forward(x: torch.Tensor, b: float) -> torch.Tensor:
    """y[0] = x[0]; y[t] = b*x[t] + (1-b)*y[t-1] along axis -1, one step
    per sample (scipy ``lfilter([b], [1, b-1], x, zi=(1-b)*x[0])``)."""
    a = 1.0 - b
    xs = x.unbind(-1)
    ys = [xs[0]]
    for t in range(1, len(xs)):
        ys.append(torch.add(xs[t] * b, ys[-1], alpha=a))
    return torch.stack(ys, dim=-1)


def ewma_filtfilt(x: torch.Tensor, b: float, axis: int = -1) -> torch.Tensor:
    """Zero-phase forward-backward first-order low-pass along ``axis``:
    ``scipy.signal.filtfilt([b], [1, b-1], x, padtype=None)`` with the
    lfilter_zi initial conditions, so y starts at the first sample in each
    direction (nonstationary.py:115; ``noisereduce_tpu/ops/dsp.py:491``)."""
    xm = x.movedim(axis, -1)
    fwd = _ewma_forward(xm, b)
    bwd = _ewma_forward(fwd.flip(-1), b).flip(-1)
    return bwd.movedim(-1, axis)
