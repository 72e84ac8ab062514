"""Fused gates: the compositions of kernels A-E (counterpart of
``noisereduce_tpu/ops/pallas/dispatch.py``).

``_gate_from_signal`` is the port of ``_merged_gate_from_blocks``
(``dispatch.py:55``) and of its split twin ``_fused_gate_from_blocks``
(``:626``), which compute the same function: spectra (A) -> mask + time
smoothing (B non-stationary, E stationary) -> frequency smoothing + blend
(C; prop 1, no blend, for the stationary path, which blends before
smoothing) -> masked iSTFT + OLA (D), where the last kernel also does the
envelope division and the output window of ``_scipy_istft_tail``
(``:331``). ``fused_gate_nonstationary`` / ``fused_gate_stationary``
(``_fused_gate_impl``, ``:590``) gate whole signals and
``fused_gate_chunked`` (``:817``, ``:920``) gates a long signal as halo'd
chunk views read straight from it: every chunk one row of one launch of
each kernel, or, with ``max_parallel_chunks`` (``group``), the chunks in
host-driven groups, one launch of each kernel a group, the cores written
into one output (the bound on live device memory that the JAX package's
``max_parallel_chunks`` gives). A view, a frame and a line are the same
bits in either, so a grouped call is bitwise the ungrouped one on the
card. With a mesh (``parallel.mesh.ChunkMesh``) ``fused_gate_chunked``
gives each device a contiguous range of the chunks, which it gates from
its own slice of the signal, bitwise what the one device gives.
``fused_stationary_threshold`` (``:493``) takes the noise-clip spectra
from A.

On a CUDA tensor every step launches its kernel; on a CPU tensor the
wrappers run their plain versions (the parity mode, float32 or float64).
The kernels take float32 and bfloat16 (the bf16 mode: A reads the bf16
signal and stores bf16 planes, B or E read them, C's mask is float32, D
stores a bf16 output; the stationary threshold stays float32):
``kernels_take`` sends a card tensor of any other dtype (float64) to the
staged twins, as the JAX package sends a dtype its kernels do not take to
its staged path on any device
(``noisereduce_tpu/models/spectral_gate.py:115-119``). A bf16 card tensor
is never widened to run the float32 kernels.

The three gates are differentiable as ``_fused_gate_cvjp``,
``_fused_stat_cvjp`` and ``_fused_chunked_cvjp`` (``:429-490``,
``:857-917``) are: when autograd records the call, the value is still the
kernels' output, bitwise the serving value, and the cotangent comes from
the staged twin (``_gate_nonstationary_staged``, ``_gate_stationary_staged``,
or ``process_chunked`` of either), recomputed in the backward pass, which
launches no kernel (``ops/precision.py``). The stationary threshold gets a
zero gradient: the threshold compare has none. Otherwise they run exactly
as a serving call does.
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
    stationary_mask,
)
from noisereduce_tpu_torch.ops.dsp import mask_dtype, noise_db_threshold, tri_norm
from noisereduce_tpu_torch.ops.precision import fused_with_twin

__all__ = [
    "kernels_take",
    "fused_gate_supported",
    "fused_gate_nonstationary",
    "fused_gate_stationary",
    "fused_gate_chunked",
    "fused_stationary_threshold",
]


def kernels_take(x: torch.Tensor) -> bool:
    """Whether the kernels serve a tensor of this dtype and device: any on
    the CPU (their plain versions, the parity mode), float32 or bfloat16
    on the card. A card tensor of another dtype (float64) goes to the
    staged twins, which run it in its own precision; the kernel wrappers
    raise on it."""
    return x.device.type == "cpu" or x.dtype in (torch.float32, torch.bfloat16)


def on_device(x: torch.Tensor, device=None) -> torch.Tensor:
    """``x``, or an empty tensor of its dtype on ``device`` where the call
    will run there (a mesh's first device), for ``kernels_take``."""
    return x if device is None else torch.empty(0, dtype=x.dtype, device=device)


def fused_gate_supported(cfg: GateConfig, x: torch.Tensor, device=None) -> bool:
    """Whether kernels A-D serve this configuration and the signal ``x``
    (``kernels_take``), on ``device`` where it will run there. Unlike the
    TPU predicate (``dispatch.py:379``) there is no VMEM budget, no lane
    alignment and no cap on n_grad_time: only the STFT geometry with its
    frequency taps (``kernels_supported``) and the dtype matter."""
    n_freq_taps = 2 * (cfg.smoothing or (0, 0))[0] + 1
    return kernels_supported(cfg.stft, n_freq_taps) and kernels_take(on_device(x, device))


def _gate_from_signal(x, cfg, chunk_size=0, padding=0, noise_thresh=None, chunks=None,
                      src_start=0):
    """(rows, n) -> gated views: each whole row (``chunk_size`` 0;
    (rows, n) out) or the core [padding, padding + chunk_size) of each
    halo'd chunk view ((rows*n_chunks, chunk_size) out; with ``chunks`` =
    (first, count), of those chunks only, ``x`` holding the signal from
    sample ``src_start`` on: a device's slice under a mesh), zero filled
    past the istft's end. ``noise_thresh`` (a (bins,) or per-row (rows,
    bins) dB threshold) selects the stationary gate."""
    n = x.shape[-1]
    if chunk_size:
        view_len, out_off, out_len = chunk_size + 2 * padding, padding, chunk_size
    else:
        view_len, out_off, out_len = n, 0, n
    geo = gate_geometry(cfg.stft, view_len)
    n_grad_freq, n_grad_time = cfg.smoothing or (0, 0)
    re, im = spectra(x, geo, chunk_size, padding, chunks, src_start)
    if noise_thresh is None:
        mask = nonstationary_mask(
            re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
            cfg.sigmoid_slope_nonstationary, tri_norm(n_grad_time),
        )
        prop = cfg.prop_decrease
    else:
        mask = stationary_mask(
            re, im, noise_thresh.to(mask_dtype(re.dtype)).contiguous(),
            re.shape[0] // x.shape[0], cfg.prop_decrease, tri_norm(n_grad_time),
        )
        prop = 1.0  # the stationary blend came before the smoothing
    mask = freq_smooth_blend(mask, tri_norm(n_grad_freq), prop)
    return istft_ola(re, im, mask, geo, out_off, out_len)


def fused_gate_nonstationary(chunk: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Non-stationary gate of (..., n) signals through kernels A-D
    (``_fused_gate_impl``, ``dispatch.py:590``): same math as
    ``models.spectral_gate._gate_nonstationary_staged`` except that silence
    gives finite zeros. Caller guarantees ``fused_gate_supported``."""
    from noisereduce_tpu_torch.models.spectral_gate import _gate_nonstationary_staged

    def forward(c):
        n = c.shape[-1]
        return _gate_from_signal(c.reshape(-1, n).contiguous(), cfg).reshape(c.shape)

    return fused_with_twin(forward, lambda c: _gate_nonstationary_staged(c, cfg), chunk)


def fused_gate_stationary(
    chunk: torch.Tensor, noise_thresh: torch.Tensor, cfg: GateConfig
) -> torch.Tensor:
    """Stationary gate of (..., n) signals through kernels A, E, C and D
    (``fused_gate_stationary``, ``dispatch.py:455``): binary dB-threshold
    mask, blend BEFORE smoothing. ``noise_thresh`` is (bins,) or per-row,
    its leading axes left-aligned with the chunk's batch axes (a (B, bins)
    threshold for (B, n_chunks, n) chunks: every chunk of row b reads row
    b), as ``_fused_gate_impl`` (``:597-606``) broadcasts it. Caller
    guarantees ``fused_gate_supported``."""
    from noisereduce_tpu_torch.models.spectral_gate import _gate_stationary_staged

    def forward(c, thr):
        n = c.shape[-1]
        batch = c.shape[:-1]
        if thr.ndim > 1:
            nb = thr.shape[-1]
            thr = thr.reshape(thr.shape[:-1] + (1,) * (len(batch) + 1 - thr.ndim) + (nb,))
            thr = thr.expand(batch + (nb,)).reshape(-1, nb)
        y = _gate_from_signal(c.reshape(-1, n).contiguous(), cfg, noise_thresh=thr)
        return y.reshape(c.shape)

    return fused_with_twin(
        forward, lambda c, t: _gate_stationary_staged(c, t, cfg), chunk, noise_thresh
    )


def fused_gate_chunked(
    y2d: torch.Tensor, cfg: GateConfig, chunk_size: int, padding: int,
    noise_thresh=None, group: int = 0, progress: bool = False, mesh=None,
    axis_name: str = "chunks",
) -> torch.Tensor:
    """The whole chunked body (reference base.py:144-226): chunk i of each
    row is the view of source samples [i*cs - padding, (i+1)*cs + padding),
    zero outside the signal, gated, and its core [padding, padding + cs)
    assembled. Kernel A reads the views straight from ``y2d`` and kernel D
    writes only the cores, so no view is materialized. (ch, n) -> (ch, n).
    ``noise_thresh``, (bins,) or per-row (ch, bins), selects the stationary
    gate; every chunk of row c reads row c. ``group`` > 0 or ``progress``:
    the chunks in groups of ``group`` (1 for 0; ``parallel.chunking.
    grouped_cores``). ``mesh`` (a ``parallel.mesh.ChunkMesh``): the chunks
    sharded over its devices (``parallel.chunking.shard_cores``, the mesh
    branch of ``_fused_chunked_impl``, ``:1071-1094``): each device reads
    its range's views from its own slice of the signal and runs A, B or E,
    C and D over them (in groups of ``group`` chunks, no bar), the
    threshold copied to each; the output lands on ``y2d``'s device."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _gate_nonstationary_staged, _gate_stationary_staged,
    )
    from noisereduce_tpu_torch.parallel.chunking import (
        grouped_cores, process_chunked, shard_cores,
    )

    def forward(y, thr):
        if mesh is not None:
            return shard_cores(
                lambda yd, start, chunks, t: _gate_from_signal(
                    yd, cfg, chunk_size, padding, t, chunks, start),
                y, chunk_size, padding, mesh, axis_name, group, (thr,))
        y = y.contiguous()
        return grouped_cores(
            lambda chunks: _gate_from_signal(y, cfg, chunk_size, padding, thr, chunks),
            y, chunk_size, group, progress)

    def twin(y, thr):
        sharding = dict(mesh=mesh, axis_name=axis_name)
        if thr is None:
            return process_chunked(
                lambda c: _gate_nonstationary_staged(c, cfg), y, chunk_size, padding,
                **sharding)
        return process_chunked(
            lambda c, t: _gate_stationary_staged(c, t, cfg), y, chunk_size, padding,
            extra=(thr,), **sharding)

    return fused_with_twin(forward, twin, y2d, noise_thresh)


def fused_stationary_threshold(y_noise: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """Per-bin stationary dB threshold of (..., n_clip) noise rows, the
    spectra from kernel A (``fused_stationary_threshold``,
    ``dispatch.py:493``): mean + n_std * std over frames of the dB
    spectrogram, ddof 0, as plain reductions (XLA reductions in JAX).
    Returns (..., bins), float32 for a bfloat16 clip (``dispatch.py:493-518``).
    Caller guarantees ``fused_gate_supported``.
    Differentiable: the cotangent comes from the same statistics of the
    staged STFT, never cast to bfloat16 (the JAX threshold has no
    ``cotangent_vjp``; ``ops/precision.py``)."""
    from noisereduce_tpu_torch.ops.stft import stft

    def forward(y):
        n = y.shape[-1]
        re, im = spectra(y.reshape(-1, n).contiguous(), gate_geometry(cfg.stft, n))
        thr = noise_db_threshold(re, im, cfg.n_std_thresh_stationary)
        return thr.reshape(y.shape[:-1] + thr.shape[-1:])

    return fused_with_twin(
        forward,
        lambda y: noise_db_threshold(*stft(y, cfg.stft), cfg.n_std_thresh_stationary),
        y_noise,
        cast_cotangent=False,
    )
