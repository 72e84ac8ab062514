"""Staged STFT / iSTFT in plain torch, scipy convention
(counterpart of ``noisereduce_tpu/ops/stft.py``).

``scipy.signal.stft/istft`` as the NumPy engines call them: periodic Hann,
the signal extended with ``win//2`` zeros each side, frames scaled by
``1/window.sum()``, inverse by windowed overlap-add divided by the
window-square envelope. Layout is time-major split re/im end to end:
``(..., n_frames, n_bins)`` real pairs, as the JAX package's internal
pipelines use (``time_major=True, split=True``). The torch convention comes
with the torch-gate slice.

Window and envelope tables are built in float64 numpy and cast to the
compute dtype, like the JAX package's trace-time constants.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.config import Convention, StftConfig

__all__ = ["stft", "istft"]


@functools.lru_cache(maxsize=None)
def _hann_periodic_np(n: int) -> np.ndarray:
    """Periodic Hann window in float64 (== scipy.get_window('hann', n))."""
    k = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))


def _require_scipy(cfg: StftConfig) -> None:
    if cfg.convention != Convention.SCIPY or cfg.quantize_window_f32:
        raise NotImplementedError(
            "the PyTorch port implements the scipy STFT convention only; the "
            "torch convention is a later slice (ROADMAP.md, Queue 1)"
        )


@functools.lru_cache(maxsize=None)
def _analysis_window_np(cfg: StftConfig) -> np.ndarray:
    """Window applied to each extracted frame (scipy: Hann(win))."""
    _require_scipy(cfg)
    return _hann_periodic_np(cfg.win_length)


@functools.lru_cache(maxsize=None)
def _ola_norm_np(cfg: StftConfig, n_frames: int) -> np.ndarray:
    """Window-square overlap-add envelope, full length (before the edge
    trim): frame_length + (n_frames-1)*hop samples, float64."""
    w = _analysis_window_np(cfg)
    frame_length = len(w)
    hop = cfg.hop_length
    full = frame_length + (n_frames - 1) * hop
    norm = np.zeros(full, dtype=np.float64)
    wsq = w * w
    for j in range(n_frames):
        norm[j * hop : j * hop + frame_length] += wsq
    return norm


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def stft(x: torch.Tensor, cfg: StftConfig):
    """(..., n_samples) real -> (re, im), each (..., n_frames, n_bins)."""
    _require_scipy(cfg)
    hop, pad, win = cfg.hop_length, cfg.boundary_pad, cfg.frame_length
    n_frames = cfg.n_frames(x.shape[-1])
    xp = F.pad(x, (pad, pad))
    need = (n_frames - 1) * hop + win
    frames = xp[..., :need].unfold(-1, win, hop)  # (..., n_frames, win)
    w = _analysis_window_np(cfg)
    frames = frames * _const(w, x)
    Z = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    scale = 1.0 / float(w.sum())
    return Z.real * scale, Z.imag * scale


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., n_frames, L) -> (..., L + (n_frames-1)*hop)."""
    n_frames, length = frames.shape[-2], frames.shape[-1]
    full = length + (n_frames - 1) * hop
    lead = frames.shape[:-2]
    cols = frames.reshape(-1, n_frames, length).transpose(1, 2)
    out = F.fold(
        cols, output_size=(1, full), kernel_size=(1, length), stride=(1, hop)
    )
    return out.reshape(lead + (full,))


def istft(Z, cfg: StftConfig) -> torch.Tensor:
    """(re, im) time-major pair -> real signal of length
    ``cfg.istft_length(n_frames)`` (scipy trims win//2 each side)."""
    _require_scipy(cfg)
    re, im = Z
    hop, win = cfg.hop_length, cfg.frame_length
    n_frames = re.shape[-2]
    frames = torch.fft.irfft(torch.complex(re, im), n=cfg.n_fft, dim=-1)
    frames = frames[..., :win]
    w = _analysis_window_np(cfg)
    # scipy: xsubs *= win.sum(); OLA of xsubs*win; divide by OLA(win^2)
    frames = frames * _const(w * w.sum(), re)
    x = _overlap_add(frames, hop)
    full = x.shape[-1]
    trim = cfg.win_length // 2
    norm = _ola_norm_np(cfg, n_frames)[trim : full - trim]
    norm = np.where(norm > 1e-10, norm, 1.0)
    return x[..., trim : full - trim] / _const(norm, re)
