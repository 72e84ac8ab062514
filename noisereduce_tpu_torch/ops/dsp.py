"""Elementwise and small-filter DSP ops in plain torch (counterpart of
``noisereduce_tpu/ops/dsp.py``): those of the scipy-convention gates and of
the torch-convention gate (TorchGate: ``temperature_sigmoid``,
``moving_average_same``, ``smooth_mask_2d_torchgate`` and the top_db 40,
ddof 1 noise threshold).

The 'same' convolutions are written as sums of shifted slices (the moving
average as a float64 prefix sum) rather than ``conv1d``: on a CUDA card a
float32 ``conv1d`` goes through cuDNN in TF32 by default (about three
decimal digits), and these are the plain versions the kernels are held
against.

In the bf16 mode (``compute_dtype=torch.bfloat16``) the spectra are
bfloat16 and the gating decisions float32 (``mask_dtype``, the JAX
package's ``models/spectral_gate.py::_mask_dtype``, ``:73``): the noise
thresholds widen bfloat16 spectra to float32, ``ewma_filtfilt`` carries a
bfloat16 input in float64 as it does a float32 one, and ``conv_same``
accumulates a bfloat16 input in float32 and rounds once, the float32
accumulators of ``noisereduce_tpu/ops/dsp.py`` (``:210``, ``:412``,
``:466``).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "mask_dtype",
    "to_mask_dtype",
    "amp_to_db",
    "noise_db_threshold",
    "torch_noise_db_threshold",
    "sigmoid",
    "temperature_sigmoid",
    "as_temperature",
    "triangular_vector",
    "tri_norm",
    "conv_same",
    "smooth_mask",
    "smooth_mask_2d_torchgate",
    "ewma_filtfilt",
    "moving_average_same",
]


# float64 machine epsilon: the reference adds it in every compute dtype
# (spectralgate/utils.py:11)
EPS_F64 = float(np.finfo(np.float64).eps)


def mask_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the mask-decision math for spectra of ``dtype``: dB
    statistics, threshold compares, the IIR floor and the sigmoid run in
    float32 for bfloat16 spectra (bf16's ~3 significant digits bias the
    statistics and flip threshold compares), in the spectra's own dtype
    otherwise (``_mask_dtype``, ``spectral_gate.py:73``)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def to_mask_dtype(*ts: torch.Tensor) -> tuple:
    """``ts`` in their ``mask_dtype``: bfloat16 widened to float32 (exact),
    any other dtype as it is."""
    return tuple(t.to(mask_dtype(t.dtype)) for t in ts)


def amp_to_db(
    x: torch.Tensor, top_db: float = 80.0, eps: float = EPS_F64, axis: int = -1
) -> torch.Tensor:
    """Amplitude -> dB, ``20*log10(|x| + eps)`` floored at (max over
    ``axis``) - top_db (spectralgate/utils.py:11-16; time-major callers
    pass axis=-2)."""
    x_db = 20.0 * torch.log10(x.abs() + eps)
    floor = x_db.amax(dim=axis, keepdim=True) - top_db
    return torch.maximum(x_db, floor)


def noise_db_threshold(re: torch.Tensor, im: torch.Tensor, n_std: float) -> torch.Tensor:
    """Stationary per-bin threshold from noise spectra (..., frames, bins):
    mean + n_std * std over frames of the dB spectrogram, ddof 0
    (stationary.py:67-81). Returns (..., bins), float32 for bfloat16
    spectra."""
    re, im = to_mask_dtype(re, im)
    db = amp_to_db(torch.sqrt(re * re + im * im), top_db=80.0, axis=-2)
    mean = db.mean(dim=-2)
    std = db.std(dim=-2, correction=0)
    return mean + std * n_std


def torch_noise_db_threshold(re: torch.Tensor, im: torch.Tensor, n_std: float) -> torch.Tensor:
    """TorchGate's stationary per-bin threshold from noise spectra
    (..., frames, bins): the dB spectrogram floored at max - 40 dB, then
    mean + n_std * std over frames, ddof 1 (torchgate.py:126-165;
    ``torch_dispatch.py::_torch_threshold_stats``, ``:169``). Returns
    (..., bins), float32 for bfloat16 spectra."""
    re, im = to_mask_dtype(re, im)
    db = amp_to_db(torch.sqrt(re * re + im * im), top_db=40.0, axis=-2)
    return db.mean(dim=-2) + db.std(dim=-2, correction=1) * n_std


def sigmoid(x: torch.Tensor, shift: float, mult: float) -> torch.Tensor:
    """``1 / (1 + exp(-(x + shift) * mult))`` (spectralgate/utils.py:4-8)."""
    return torch.sigmoid((x + shift) * mult)


def as_temperature(temp_coeff: float, dtype: torch.dtype) -> float:
    """The temperature as the JAX package divides by it in ``dtype``: XLA
    flushes a subnormal divisor to zero, on the CPU as on the TPU, so a
    value whose magnitude in ``dtype`` is below its smallest normal is a
    zero of its sign (``x / 1e-40`` is then inf, and NaN where x is 0).
    Every other value, 0, inf, NaN and a negative one included, stays."""
    t = float(temp_coeff)
    rounded = torch.tensor(t, dtype=dtype).item()
    return math.copysign(0.0, t) if 0.0 < abs(rounded) < torch.finfo(dtype).tiny else t


def temperature_sigmoid(x: torch.Tensor, x0: float, temp_coeff: float) -> torch.Tensor:
    """``sigmoid((x - x0) / temp)`` (torchgate/utils.py:27-39), the
    temperature read as the JAX package reads it (``as_temperature``)."""
    return torch.sigmoid((x - x0) / as_temperature(temp_coeff, x.dtype))


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
    out[i] = sum_d taps[d] * x[i + d - n], n = len(taps)//2; a bfloat16
    ``x`` is summed in float32 and rounded once."""
    n = len(taps) // 2
    if n == 0:
        return x * float(taps[0])
    if x.dtype == torch.bfloat16:
        return conv_same(x.float(), taps, dim).to(x.dtype)
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


@functools.lru_cache(maxsize=None)
def _torchgate_smoothing_kernel_np(n_grad_freq: int, n_grad_time: int) -> np.ndarray:
    """TorchGate's 2-D smoothing kernel (freq x time) with its float32
    rounding: the reference builds it from ``torch.linspace`` /
    ``torch.outer`` in float32 (torchgate.py:113-124), which makes it no
    longer exactly rank-1. float64 values of the float32 kernel."""
    def tri(n):
        return torch.cat(
            [torch.linspace(0, 1, n + 2)[:-1], torch.linspace(1, 0, n + 2)]
        )[1:-1]

    k = torch.outer(tri(n_grad_freq), tri(n_grad_time))
    return (k / k.sum()).to(torch.float64).numpy()


@functools.lru_cache(maxsize=None)
def _torchgate_kernel_svd_np(n_grad_freq: int, n_grad_time: int):
    """SVD of the TorchGate smoothing kernel, keeping every term with
    sigma_i > 1e-10 sigma_0 (rank 3-4; the trailing terms are ~1e-8 of
    sigma_0, float32 rounding). Returns (rows, cols): rows (r, kf) =
    sigma_i u_i (frequency taps), cols (r, kt) = v_i (time taps)."""
    k = _torchgate_smoothing_kernel_np(n_grad_freq, n_grad_time)
    u, s, vt = np.linalg.svd(k)
    r = max(1, int(np.sum(s > 1e-10 * s[0])))
    return (u[:, :r] * s[:r]).T.copy(), vt[:r].copy()


def smooth_mask_2d_torchgate(
    mask: torch.Tensor, n_grad_freq: int, n_grad_time: int,
    time_major: bool = False,
) -> torch.Tensor:
    """TorchGate's 'same' smoothing with its float32-rounded 2-D kernel
    (torchgate.py:241-249) over a (..., freq, time) mask, or (..., time,
    freq) with ``time_major``: the sum over the SVD ranks of a frequency
    pass with sigma_i u_i and a time pass with v_i, zero outside the axes."""
    rows, cols = _torchgate_kernel_svd_np(n_grad_freq, n_grad_time)
    fdim, tdim = (-1, -2) if time_major else (-2, -1)
    out = None
    for fr, tc in zip(rows, cols):
        term = conv_same(conv_same(mask, fr, fdim), tc, tdim)
        out = term if out is None else out + term
    return out


def moving_average_same(x: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """TorchGate's 'same' moving average over ``n`` samples along ``axis``
    (``conv1d(x, ones(n)/n, padding='same')``, torchgate.py:179-190): zero
    padding left = (n-1)//2, right = n-1-left (more on the right for an
    even n). Computed as a difference of prefix sums in float64 and rounded
    once to the input's dtype, as kernel F carries its window sum."""
    left = (n - 1) // 2
    right = n - 1 - left
    xm = x.movedim(axis, -1).to(torch.float64)
    length = xm.shape[-1]
    csum = F.pad(torch.cumsum(F.pad(xm, (left, right)), dim=-1), (1, 0))
    out = (csum[..., n : n + length] - csum[..., :length]) / n
    return out.to(x.dtype).movedim(-1, axis)


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
    direction (nonstationary.py:115; ``noisereduce_tpu/ops/dsp.py:491``).

    A float32 (or bfloat16) input is filtered in float64 and the result
    rounded once: a float32 state takes about 1/b roundings into each value
    (b ~ 0.003 at 48 kHz), where the JAX package's blockwise scan takes a
    few."""
    xm = x.movedim(axis, -1)
    if xm.dtype in (torch.float32, torch.bfloat16):
        xm = xm.to(torch.float64)
    fwd = _ewma_forward(xm, b)
    bwd = _ewma_forward(fwd.flip(-1), b).flip(-1)
    return bwd.movedim(-1, axis).to(x.dtype)
