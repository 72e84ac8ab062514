"""Fused non-stationary gate: the composition of kernels A-D (counterpart
of ``noisereduce_tpu/ops/pallas/dispatch.py``).

``_gate_from_signal`` is the port of ``_merged_gate_from_blocks``
(``dispatch.py:55``): spectra -> mask + time smoothing -> frequency
smoothing + blend -> masked iSTFT + OLA, where the last kernel also does the
envelope division and the output window of ``_scipy_istft_tail``
(``:331``). ``_fused_gate_impl`` (``:590``) gates whole signals and
``fused_gate_chunked`` / ``_fused_chunked_impl`` (``:817``, ``:920``) gate a
long signal as halo'd chunk views read straight from it. There is no mesh
and no ``max_parallel_chunks``: every chunk is one row of one launch.

On a CUDA tensor every step launches its kernel; on a CPU tensor the
wrappers run their plain versions (the parity mode, float32 or float64).
No gradient yet: the fused-forward / staged-backward contract of
``dispatch.py:429-452`` comes with the gradient slice.
"""
from __future__ import annotations

import torch

from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry, kernels_supported
from noisereduce_tpu_torch.ops.cuda.kernels import (
    freq_smooth_blend,
    istft_ola,
    nonstationary_mask,
    spectra,
)
from noisereduce_tpu_torch.ops.dsp import tri_norm

__all__ = [
    "fused_gate_supported",
    "fused_gate_nonstationary",
    "fused_gate_chunked",
]


def fused_gate_supported(cfg: GateConfig) -> bool:
    """Whether kernels A-D serve this configuration. Unlike the TPU
    predicate (``dispatch.py:379``) there is no VMEM budget, no lane
    alignment and no cap on n_grad_time: only the STFT geometry matters."""
    return kernels_supported(cfg.stft)


def _gate_from_signal(x, cfg, chunk_size=0, padding=0):
    """(rows, n) -> gated views: each whole row (``chunk_size`` 0;
    (rows, n) out) or the core [padding, padding + chunk_size) of each
    halo'd chunk view ((rows*n_chunks, chunk_size) out), zero filled past
    the istft's end."""
    n = x.shape[-1]
    if chunk_size:
        view_len, out_off, out_len = chunk_size + 2 * padding, padding, chunk_size
    else:
        view_len, out_off, out_len = n, 0, n
    geo = gate_geometry(cfg.stft, view_len)
    n_grad_freq, n_grad_time = cfg.smoothing or (0, 0)
    re, im = spectra(x, geo, chunk_size, padding)
    mask = nonstationary_mask(
        re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
        cfg.sigmoid_slope_nonstationary, tri_norm(n_grad_time),
    )
    mask = freq_smooth_blend(mask, tri_norm(n_grad_freq), cfg.prop_decrease)
    return istft_ola(re, im, mask, geo, out_off, out_len)


def fused_gate_nonstationary(chunk: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Non-stationary gate of (..., n) signals through kernels A-D
    (``_fused_gate_impl``, ``dispatch.py:590``): same math as
    ``models.spectral_gate._gate_nonstationary_staged`` except that silence
    gives finite zeros. Caller guarantees ``fused_gate_supported``."""
    n = chunk.shape[-1]
    x = chunk.reshape(-1, n).contiguous()
    y = _gate_from_signal(x, cfg)
    return y.reshape(chunk.shape)


def fused_gate_chunked(
    y2d: torch.Tensor, cfg: GateConfig, chunk_size: int, padding: int
) -> torch.Tensor:
    """The whole chunked body (reference base.py:144-226): chunk i of each
    row is the view of source samples [i*cs - padding, (i+1)*cs + padding),
    zero outside the signal, gated, and its core [padding, padding + cs)
    assembled. Kernel A reads the views straight from ``y2d`` and kernel D
    writes only the cores, so no view is materialized. (ch, n) -> (ch, n)."""
    ch, n = y2d.shape
    core = _gate_from_signal(y2d.contiguous(), cfg, chunk_size, padding)
    return core.reshape(ch, -1)[:, :n]
