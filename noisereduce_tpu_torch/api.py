"""Public API: ``reduce_noise``, signature-compatible with the reference
(noisereduce/noisereduce.py:13-185), non-stationary engine only
(counterpart of ``noisereduce_tpu/api.py``).

- ``device`` defaults to ``"cuda"``, as the reference's torch path does.
  Where CUDA is absent, ``device="cuda"`` raises; it does not fall back to
  the CPU. ``device="cpu"`` runs the kernels' plain versions (the parity
  mode).
- ``compute_dtype`` defaults to ``torch.float32``, the only type the
  kernels take; ``torch.float64`` runs on the CPU only.
- ``stationary=True``, ``use_torch=True`` and ``use_tqdm=True`` raise
  ``NotImplementedError``: they are later slices of the port (ROADMAP.md,
  Queue 1). ``tmp_folder`` and ``n_jobs`` are accepted for compatibility;
  chunk fan-out is the kernels' batch axis, not a process pool.
"""
from __future__ import annotations

import numpy as np
import torch

from noisereduce_tpu_torch.config import Convention, GateConfig, smoothing_kernel_sizes
from noisereduce_tpu_torch.models.spectral_gate import gate_nonstationary
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_chunked,
    fused_gate_supported,
)
from noisereduce_tpu_torch.parallel.chunking import process_chunked

__all__ = ["reduce_noise"]

_LATER = "is a later slice of the PyTorch port (ROADMAP.md, Queue 1)"


def _fused_chunked_ok(cfg: GateConfig, y2d: torch.Tensor, chunk_size: int) -> bool:
    """Whole-body fused chunked path (views read straight from the signal)
    for signals longer than one chunk; shorter ones keep their exact
    unchunked view geometry (``api.py:50``)."""
    return y2d.shape[-1] > chunk_size and fused_gate_supported(cfg)


def _run_nonstationary(y2d, cfg, chunk_size, padding):
    if _fused_chunked_ok(cfg, y2d, chunk_size):
        return fused_gate_chunked(y2d, cfg, chunk_size, padding)
    return process_chunked(
        lambda c: gate_nonstationary(c, cfg), y2d, chunk_size, padding
    )


def _as_2d(y: np.ndarray):
    """Reference input normalization (base.py:52-62): 1-D -> (1, n) plus a
    flat flag; more than 2-D is rejected."""
    if y.ndim == 1:
        return y[None, :], True
    if y.ndim > 2:
        raise ValueError("Waveform must be in shape (# frames, # channels)")
    return y, False


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass device='cpu' "
            "to run the plain versions"
        )
    return dev


def _finalize_reduce_output(out: torch.Tensor, out_dtype, flat: bool) -> np.ndarray:
    """Host array with the input's dtype and shape restored (``api.py:623``).

    A card's output lands in pinned host memory, which the returned array
    keeps: a pageable D2H, or a second host copy, each cost more than the
    four kernels together at the headline size (PERF.md, section 5)."""
    if out.device.type != "cpu":
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out)
        out = host
    arr = out.numpy().astype(out_dtype, copy=False)
    return arr.reshape(-1) if flat else arr


def reduce_noise(
    y,
    sr,
    stationary=False,
    y_noise=None,
    prop_decrease=1.0,
    time_constant_s=2.0,
    freq_mask_smooth_hz=500,
    time_mask_smooth_ms=50,
    thresh_n_mult_nonstationary=2,
    sigmoid_slope_nonstationary=10,
    n_std_thresh_stationary=1.5,
    tmp_folder=None,
    chunk_size=600000,
    padding=30000,
    n_fft=1024,
    win_length=None,
    hop_length=None,
    clip_noise_stationary=True,
    use_tqdm=False,
    n_jobs=1,
    use_torch=False,
    device="cuda",
    compute_dtype=None,
):
    """Reduce noise by non-stationary spectral gating
    (reference noisereduce.py:13-185).

    Parameters
    ----------
    y : np.ndarray [(frames,) or (channels, frames)], real-valued
    sr : int, sample rate
    prop_decrease : proportion to reduce the noise by (1.0 = 100%)
    time_constant_s : time constant of the noise-floor IIR, seconds
    freq_mask_smooth_hz, time_mask_smooth_ms : triangular mask-smoothing
        widths (None disables that axis)
    thresh_n_mult_nonstationary, sigmoid_slope_nonstationary : threshold
        multiple and sigmoid slope of the mask
    chunk_size, padding : long recordings are gated as halo'd chunks
    n_fft, win_length, hop_length : STFT geometry (win defaults to n_fft,
        hop to win // 4)
    device : torch device to run on (default "cuda"; raises if absent)
    compute_dtype : torch.float32 (default) or torch.float64 (CPU only)
    y_noise, n_std_thresh_stationary, clip_noise_stationary : used by the
        stationary engine only
    tmp_folder, n_jobs : accepted for reference compatibility

    Returns a NumPy array with the input's shape and dtype.
    """
    del tmp_folder, n_jobs, y_noise, n_std_thresh_stationary
    del clip_noise_stationary
    if use_torch:
        raise NotImplementedError(f"use_torch=True (the torch-convention gate) {_LATER}")
    if stationary:
        raise NotImplementedError(f"stationary=True {_LATER}")
    if use_tqdm:
        raise NotImplementedError(f"use_tqdm=True (the host-driven chunk loop) {_LATER}")
    # validate the smoothing geometry eagerly, like the reference
    # constructors (spectralgate/base.py:99-128): same ValueErrors
    win = n_fft if win_length is None else win_length
    hop = win // 4 if hop_length is None else hop_length
    smoothing_kernel_sizes(sr, n_fft, hop, freq_mask_smooth_hz, time_mask_smooth_ms)

    cdtype = torch.float32 if compute_dtype is None else compute_dtype
    if cdtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"compute_dtype={cdtype}: float32 and float64 only; the bf16 "
            f"mode {_LATER}"
        )
    dev = _resolve_device(device)

    y = np.asarray(y)
    out_dtype = y.dtype
    y2d, flat = _as_2d(y)
    y2d = torch.as_tensor(np.ascontiguousarray(y2d)).to(device=dev, dtype=cdtype)

    cfg = GateConfig(
        sr=sr,
        stationary=False,
        prop_decrease=prop_decrease,
        time_constant_s=time_constant_s,
        freq_mask_smooth_hz=freq_mask_smooth_hz,
        time_mask_smooth_ms=time_mask_smooth_ms,
        thresh_n_mult_nonstationary=thresh_n_mult_nonstationary,
        sigmoid_slope_nonstationary=sigmoid_slope_nonstationary,
        n_fft=n_fft,
        win_length=win_length,
        hop_length=hop_length,
        convention=Convention.SCIPY,
    )
    with torch.no_grad():
        out = _run_nonstationary(y2d, cfg, chunk_size, padding)
    return _finalize_reduce_output(out, out_dtype, flat)
