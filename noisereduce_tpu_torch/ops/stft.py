"""Staged STFT / iSTFT in plain torch, both reference conventions
(counterpart of ``noisereduce_tpu/ops/stft.py``).

- scipy (``scipy.signal.stft/istft`` as the NumPy engines call them):
  periodic Hann, the signal extended with ``win//2`` zeros each side,
  frames scaled by ``1/window.sum()``, inverse by windowed overlap-add
  divided by the window-square envelope, trimmed ``win//2`` each side.
- torch (``torch.stft/istft`` with ``center=True, pad_mode='constant'`` as
  the TorchGate engine calls them): Hann(win) zero padded centered into an
  ``n_fft`` frame, ``n_fft//2`` zeros each side, no scaling; the inverse is
  trimmed ``n_fft//2`` and stops at the natural length ``(T-1)*hop``,
  divided by the envelope where it exceeds 1e-11.

``quantize_window_f32`` takes ``torch.hann_window``'s float32 values, as
the reference TorchGate does for any audio dtype, and accumulates the
envelope in float32 as ``torch.istft`` does. Layout is time-major split
re/im end to end: ``(..., n_frames, n_bins)`` real pairs, as the JAX
package's internal pipelines use (``time_major=True, split=True``).

Window and envelope tables are built in float64 numpy and cast to the
compute dtype, like the JAX package's trace-time constants.

bfloat16 (the bf16 mode) keeps the JAX staged path's rounding points
(``noisereduce_tpu/ops/stft.py:240-290``, ``:330-360``): frames times the
window in bfloat16, the FFT in float32 (``torch.fft`` takes no bfloat16),
re/im rounded to bfloat16 and scaled there; the inverse FFT in float32,
its frames rounded to bfloat16, the window, the overlap-add and the
envelope division in bfloat16.
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


@functools.lru_cache(maxsize=None)
def _hann_f32_np(n: int) -> np.ndarray:
    """``torch.hann_window(n)``'s float32 values, as float64: the reference
    TorchGate passes no dtype (torchgate.py:231,261)."""
    return torch.hann_window(n, dtype=torch.float32).to(torch.float64).numpy()


@functools.lru_cache(maxsize=None)
def _analysis_window_np(cfg: StftConfig) -> np.ndarray:
    """Window applied to each extracted frame of ``frame_length`` samples:
    scipy, Hann(win); torch, Hann(win) zero padded centered into n_fft
    (left pad (n_fft - win)//2, as torch.stft)."""
    w = _hann_f32_np(cfg.win_length) if cfg.quantize_window_f32 else (
        _hann_periodic_np(cfg.win_length))
    if cfg.convention == Convention.SCIPY:
        return w
    left = (cfg.n_fft - cfg.win_length) // 2
    out = np.zeros(cfg.n_fft, dtype=np.float64)
    out[left : left + cfg.win_length] = w
    return out


@functools.lru_cache(maxsize=None)
def _ola_norm_np(cfg: StftConfig, n_frames: int) -> np.ndarray:
    """Window-square overlap-add envelope, full length (before the edge
    trim): frame_length + (n_frames-1)*hop samples, returned as float64 and
    accumulated in float32 for a float32 window (torch.istft builds it in
    the window's dtype)."""
    w = _analysis_window_np(cfg)
    frame_length = len(w)
    hop = cfg.hop_length
    full = frame_length + (n_frames - 1) * hop
    acc = np.float32 if cfg.quantize_window_f32 else np.float64
    norm = np.zeros(full, dtype=acc)
    wsq = (w * w).astype(acc)
    for j in range(n_frames):
        norm[j * hop : j * hop + frame_length] += wsq
    return norm.astype(np.float64)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def stft(x: torch.Tensor, cfg: StftConfig):
    """(..., n_samples) real -> (re, im), each (..., n_frames, n_bins)."""
    hop, pad, win = cfg.hop_length, cfg.boundary_pad, cfg.frame_length
    n_frames = cfg.n_frames(x.shape[-1])
    xp = F.pad(x, (pad, pad))
    need = (n_frames - 1) * hop + win
    frames = xp[..., :need].unfold(-1, win, hop)  # (..., n_frames, win)
    w = _analysis_window_np(cfg)
    frames = frames * _const(w, x)
    Z = torch.fft.rfft(_fft_operand(frames), n=cfg.n_fft, dim=-1)
    re, im = Z.real.to(x.dtype), Z.imag.to(x.dtype)
    if cfg.convention != Convention.SCIPY:
        return re, im
    scale = _const(np.float64(1.0 / w.sum()), re)
    return re * scale, im * scale


def _fft_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as ``torch.fft`` takes it: bfloat16 widened to float32."""
    return t.float() if t.dtype == torch.bfloat16 else t


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
    ``cfg.istft_length(n_frames)``: scipy trims win//2 each side; torch
    trims n_fft//2 and stops at (n_frames-1)*hop samples."""
    re, im = Z
    hop, win = cfg.hop_length, cfg.frame_length
    n_frames = re.shape[-2]
    frames = torch.fft.irfft(
        torch.complex(_fft_operand(re), _fft_operand(im)), n=cfg.n_fft, dim=-1)
    frames = frames[..., :win].to(re.dtype)
    w = _analysis_window_np(cfg)
    norm = _ola_norm_np(cfg, n_frames)
    if cfg.convention == Convention.SCIPY:
        # scipy: xsubs *= win.sum(); OLA of xsubs*win; divide by OLA(win^2)
        x = _overlap_add(frames * _const(w * w.sum(), re), hop)
        full = x.shape[-1]
        trim = cfg.win_length // 2
        lo, hi, floor = trim, full - trim, 1e-10
    else:
        x = _overlap_add(frames * _const(w, re), hop)
        lo = cfg.n_fft // 2
        hi = lo + (n_frames - 1) * hop
        floor = 1e-11
    norm = norm[lo:hi]
    norm = np.where(norm > floor, norm, 1.0)
    return x[..., lo:hi] / _const(norm, re)
