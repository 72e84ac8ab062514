"""Spectral gates, stationary and non-stationary (counterpart of
``noisereduce_tpu/models/spectral_gate.py``).

``gate_nonstationary`` and ``gate_stationary`` run the fused kernels
(A-D, or A, E, C, D) whenever they serve the geometry and the dtype (on
the CPU their plain versions; on the card float32 or bfloat16,
``dispatch.kernels_take``). Otherwise they take the staged pipelines, which
are also the numerical oracles of the fused paths and their backward passes:
``_gate_nonstationary_staged`` (the twin of ``_gate_nonstationary_jnp``,
``spectral_gate.py:286``), which for such geometries takes its mask from
kernel B with one unit tap, as the JAX staged path takes it from a TPU
kernel (``:297-307``); and ``_gate_stationary_staged``
(``_gate_stationary_jnp``, ``:224``). Like the reference, the staged
non-stationary mask gives NaN on silence (a 0/0 noise-floor ratio), where
the kernels give finite zeros.

Every path is differentiable, on the card and on the CPU: the fused gates
and kernel B's staged mask take their value from the kernels and their
cotangent from the plain twin (``ops/cuda/dispatch.py``,
``ops/cuda_mask.py``); the stationary threshold's gradient is zero, as
the threshold compare has none.

Per-path quirk parity (SURVEY.md §5 quirk 3): the stationary path applies
prop_decrease BEFORE smoothing (stationary.py:108-114), the non-stationary
path AFTER it (nonstationary.py:78-84).

bfloat16 (the bf16 mode) runs on every path: the kernels take bf16
signals and planes (on the card too, ``kernels_take``); the staged paths
keep the spectrogram and the output in bfloat16 and make the mask
decisions in float32 (``dsp.mask_dtype``, the JAX package's
``_mask_dtype``, ``spectral_gate.py:73``), the threshold float32 too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_nonstationary,
    fused_gate_stationary,
    fused_gate_supported,
    fused_stationary_threshold,
    kernels_take,
)
from noisereduce_tpu_torch.ops.cuda_mask import fused_nonstationary_mask_tm
from noisereduce_tpu_torch.ops.dsp import (
    amp_to_db,
    ewma_filtfilt,
    noise_db_threshold,
    sigmoid,
    smooth_mask,
    to_mask_dtype,
)
from noisereduce_tpu_torch.ops.stft import istft, stft

__all__ = [
    "stationary_noise_threshold",
    "gate_stationary",
    "gate_nonstationary",
]


def _apply_mask_and_invert(Z, mask, cfg: GateConfig, n_samples: int):
    """mask * STFT -> iSTFT, zero filled (or cut) to the input length; the
    reference writes the shorter istft into a zeros buffer of the chunk's
    shape (nonstationary.py:49,95). The mask is cast to the spectra's dtype
    first (``spectral_gate.py:133``)."""
    re, im = Z
    mask = mask.to(re.dtype)
    y = istft((re * mask, im * mask), cfg.stft)
    out_len = y.shape[-1]
    if out_len < n_samples:
        return F.pad(y, (0, n_samples - out_len))
    return y[..., :n_samples]


def stationary_noise_threshold(y_noise: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Per-bin dB threshold from (..., n_clip) noise rows: mean + n_std *
    std over frames of the noise dB spectrogram (stationary.py:67-81; ddof
    0). The spectra come from kernel A where it serves the geometry and the
    dtype (``fused_stationary_threshold``), else from the staged STFT. Returns
    (..., bins), float32 for a bfloat16 clip. An empty clip frames as one
    frame of zeros, as the JAX package frames it (and as one zero sample
    does): the threshold of silence."""
    if y_noise.shape[-1] == 0:
        y_noise = F.pad(y_noise, (0, 1))
    if fused_gate_supported(cfg, y_noise):
        return fused_stationary_threshold(y_noise, cfg)
    re, im = stft(y_noise, cfg.stft)
    return noise_db_threshold(re, im, cfg.n_std_thresh_stationary)


def _align_thresh(noise_thresh: torch.Tensor, zdb_ndim: int) -> torch.Tensor:
    """Broadcast a per-bin threshold against (..., frames, bins) dB
    spectra (``spectral_gate.py:174``): a (bins,) threshold as it is; a
    per-row (B, ..., bins) one left-aligns its batch axes with the
    spectra's leading axes, the frames axis and any chunk axes inserted as
    broadcast axes just before bins."""
    if noise_thresh.ndim <= 1:
        return noise_thresh
    n_new = zdb_ndim - noise_thresh.ndim
    shape = noise_thresh.shape[:-1] + (1,) * n_new + noise_thresh.shape[-1:]
    return noise_thresh.reshape(shape)


def gate_stationary(
    chunk: torch.Tensor, noise_thresh: torch.Tensor, cfg: GateConfig
) -> torch.Tensor:
    """Stationary spectral gate over (..., samples) (stationary.py:83-126).

    ``noise_thresh``: (bins,), shared (the reference semantics), or per-row
    (B, bins) with B the leading axis of ``chunk`` (batched serving)."""
    if fused_gate_supported(cfg, chunk):
        return fused_gate_stationary(chunk, noise_thresh, cfg)
    return _gate_stationary_staged(chunk, noise_thresh, cfg)


def _gate_stationary_staged(
    chunk: torch.Tensor, noise_thresh: torch.Tensor, cfg: GateConfig
) -> torch.Tensor:
    """Staged pipeline in plain torch, time-major (..., frames, bins)."""
    n_samples = chunk.shape[-1]
    re, im = stft(chunk, cfg.stft)
    r, i = to_mask_dtype(re, im)
    z_db = amp_to_db(torch.sqrt(r * r + i * i), top_db=80.0, axis=-2)
    thresh = _align_thresh(noise_thresh.to(z_db.dtype), z_db.ndim)
    mask = (z_db > thresh).to(z_db.dtype)
    # prop_decrease blend FIRST (stationary-path order)
    mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
    if cfg.smoothing is not None:
        mask = smooth_mask(mask, *cfg.smoothing, time_major=True)
    return _apply_mask_and_invert((re, im), mask, cfg, n_samples)


def gate_nonstationary(chunk: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Non-stationary spectral gate over (..., samples)
    (nonstationary.py:47-95): kernels A-D where they serve the geometry
    and the dtype, else the staged pipeline, with kernel B's mask where it
    takes the dtype."""
    if fused_gate_supported(cfg, chunk):
        return fused_gate_nonstationary(chunk, cfg)
    return _gate_nonstationary_staged(chunk, cfg, mask_kernel=kernels_take(chunk))


def _gate_nonstationary_staged(
    chunk: torch.Tensor, cfg: GateConfig, mask_kernel: bool = False
) -> torch.Tensor:
    """Staged pipeline in plain torch, time-major (..., frames, bins).

    ``mask_kernel``: the |Z| -> filtfilt floor -> sigmoid stage runs as
    kernel B with one unit tap (``fused_nonstationary_mask_tm``; no time
    smoothing; on the CPU its plain version, which differs only on silence:
    finite zeros, not NaN), its cotangent from the plain stage below."""
    n_samples = chunk.shape[-1]
    re, im = stft(chunk, cfg.stft)
    if mask_kernel:
        mask = fused_nonstationary_mask_tm(
            re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
            cfg.sigmoid_slope_nonstationary,
        )
    else:
        r, i = to_mask_dtype(re, im)
        mag = torch.sqrt(r * r + i * i)
        # time-smoothed noise floor: zero-phase first-order IIR per frequency
        floor = ewma_filtfilt(mag, cfg.iir_b, axis=-2)
        ratio = (mag - floor) / floor
        mask = sigmoid(
            ratio, -cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary
        )
    if cfg.smoothing is not None:
        mask = smooth_mask(mask, *cfg.smoothing, time_major=True)
    mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
    return _apply_mask_and_invert((re, im), mask, cfg, n_samples)
