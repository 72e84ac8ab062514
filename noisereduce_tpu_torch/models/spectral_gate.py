"""Non-stationary spectral gate (counterpart of
``noisereduce_tpu/models/spectral_gate.py``).

``gate_nonstationary`` runs the fused kernels A-D whenever they serve the
geometry (on the CPU their plain versions); ``_gate_nonstationary_staged``
is the staged plain-torch pipeline, the twin of ``_gate_nonstationary_jnp``
(``spectral_gate.py:286``): the numerical oracle of the fused path and,
with the gradient slice, its backward pass. Like the reference it gives NaN
on silence (a 0/0 noise-floor ratio), where the kernels give finite zeros.

The non-stationary path applies prop_decrease AFTER smoothing
(nonstationary.py:78-84; SURVEY.md §5 quirk 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_nonstationary,
    fused_gate_supported,
)
from noisereduce_tpu_torch.ops.dsp import ewma_filtfilt, sigmoid, smooth_mask
from noisereduce_tpu_torch.ops.stft import istft, stft

__all__ = ["gate_nonstationary"]


def _apply_mask_and_invert(Z, mask, cfg: GateConfig, n_samples: int):
    """mask * STFT -> iSTFT, zero filled (or cut) to the input length; the
    reference writes the shorter istft into a zeros buffer of the chunk's
    shape (nonstationary.py:49,95)."""
    re, im = Z
    y = istft((re * mask, im * mask), cfg.stft)
    out_len = y.shape[-1]
    if out_len < n_samples:
        return F.pad(y, (0, n_samples - out_len))
    return y[..., :n_samples]


def gate_nonstationary(chunk: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Non-stationary spectral gate over (..., samples)
    (nonstationary.py:47-95)."""
    if fused_gate_supported(cfg):
        return fused_gate_nonstationary(chunk, cfg)
    if chunk.device.type != "cpu":
        raise NotImplementedError(
            "kernels A-D do not serve this STFT geometry (the hop must divide "
            "the window); on the card it needs the staged slice of "
            "ROADMAP.md, Queue 2"
        )
    return _gate_nonstationary_staged(chunk, cfg)


def _gate_nonstationary_staged(chunk: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Staged pipeline in plain torch, time-major (..., frames, bins)."""
    n_samples = chunk.shape[-1]
    re, im = stft(chunk, cfg.stft)
    mag = torch.sqrt(re * re + im * im)
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
