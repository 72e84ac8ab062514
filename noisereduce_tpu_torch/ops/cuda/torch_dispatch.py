"""The torch-convention gate (TorchGate) through the kernels (counterpart of
``noisereduce_tpu/ops/pallas/torch_dispatch.py``).

``_tpugate_from_signal`` is the port of ``_merged_torch_impl`` (``:194``)
and of its split twin ``_fused_torch_impl`` (``:405``), which compute the
same function: spectra under torch conventions (A with the float32 Hann
centered in an n_fft frame, no 1/sum w) -> mask with the blend BEFORE
smoothing and the time factor v0 of the smoothing kernel's SVD (F
non-stationary; E stationary with top_db 40, from a noise clip's threshold
or from each view's own statistics) -> frequency smoothing with sigma0 u0
(C, prop 1) -> masked iSTFT, torch's natural length (T-1)*hop, divided by
the float32 envelope where it exceeds 1e-11 (D). ``_torch_threshold_stats``
(``:169``) takes the noise-clip spectra from A.

On a CUDA tensor every step launches its kernel; on a CPU tensor the
wrappers run their plain versions (the parity mode); a card tensor the
kernels do not take (float64) goes to the staged twin
(``dispatch.kernels_take``). A bfloat16 signal (the bf16 mode) runs A, F
or E and D on bf16 planes and a bf16 output, the masks and the threshold in
float32 (``_merged_torch_impl``'s fast mode, ``:202-224``, ``:279-283``);
``staged_tpugate`` keeps the plain STFT's bf16 spectra around them.
The TPU eligibility of ``fused_tpugate_supported`` (``:55``: win == n_fft,
a 128-aligned hop, r in {2, 4}, n_movemean <= 512, VMEM) does not apply:
A and D need a hop that divides n_fft and nothing else. For any other hop ``staged_tpugate``
puts the plain STFT and iSTFT around the mask kernels F or E and C, which
serve every geometry, as the scipy engine's staged path takes kernel B's
mask.

``fused_tpugate``, ``fused_tpugate_chunked`` and ``staged_tpugate`` are
differentiable as ``_fused_tpugate_cvjp1/2`` (``:128-166``) are: when
autograd records the call, the value is still the kernels' output, bitwise
the serving value, and the cotangent of ``x`` and of ``xn`` comes from the
staged twin ``TPUGate._call_staged`` (every SVD rank), recomputed in the
backward pass, which launches no kernel (``ops/precision.py``). The twin
sees the noise rows mapped onto the signal rows as the kernels read them.
For the hop that does not divide n_fft the JAX package differentiates
``_call_jnp`` itself: the same cotangent.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.ops.cuda.dispatch import kernels_take, on_device
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry, kernels_supported
from noisereduce_tpu_torch.ops.cuda.kernels import (
    freq_smooth_blend,
    istft_ola,
    spectra,
    stationary_mask,
    torch_nonstationary_mask,
)
from noisereduce_tpu_torch.ops.dsp import (
    _torchgate_kernel_svd_np,
    mask_dtype,
    torch_noise_db_threshold,
)
from noisereduce_tpu_torch.ops.precision import fused_with_twin
from noisereduce_tpu_torch.ops.stft import istft, stft
from noisereduce_tpu_torch.parallel.chunking import (
    grouped_cores,
    process_chunked,
    shard_cores,
)
from noisereduce_tpu_torch.parallel.transfer import HostSignal, StagedSignal

__all__ = [
    "fused_tpugate_supported",
    "fused_tpugate",
    "fused_tpugate_chunked",
    "staged_tpugate",
]


def fused_tpugate_supported(gate, x: torch.Tensor, device=None) -> bool:
    """Whether the kernels serve this gate's STFT geometry with its
    frequency taps and the signal ``x`` (``dispatch.kernels_take``), on
    ``device`` where it will run there."""
    n_freq_taps = len(_rank1_taps(gate.smoothing)[0])
    return (kernels_supported(gate.stft_config, n_freq_taps)
            and kernels_take(on_device(x, device)))


@functools.lru_cache(maxsize=None)
def _rank1_taps(smoothing) -> tuple:
    """(frequency taps sigma0 u0, time taps v0) of the SVD of TorchGate's
    float32-rounded smoothing kernel, as ``_fused_torch_impl`` takes them
    (``:421-427``; the trailing ranks are ~1e-8 of sigma0), both negated
    when v0 sums below zero (the product is the same) so that F's output is
    a mask; one unit tap each without smoothing."""
    if smoothing is None:
        return (1.0,), (1.0,)
    rows, cols = _torchgate_kernel_svd_np(*smoothing)
    sign = -1.0 if cols[0].sum() < 0 else 1.0
    return tuple((sign * rows[0]).tolist()), tuple((sign * cols[0]).tolist())


def _torch_threshold_stats(xn2: torch.Tensor, gate) -> torch.Tensor:
    """(bn, n_bins) stationary threshold of (bn, n_clip) noise rows, the
    spectra from kernel A under torch conventions: dB floored at max - 40,
    then mean + n_std * std over frames, ddof 1 (``:169-188``)."""
    re, im = spectra(xn2, gate_geometry(gate.stft_config, xn2.shape[-1]))
    return torch_noise_db_threshold(re, im, gate.n_std_thresh_stationary)


def _threshold_of(gate, xn):
    """The (bn, bins) threshold of a stationary gate's noise clip or rows
    (kernel A's spectra), or None: a non-stationary gate, or no clip (each
    view its own statistics)."""
    if gate.nonstationary or xn is None:
        return None
    return _torch_threshold_stats((xn if xn.ndim == 2 else xn[None]).contiguous(), gate)


def _tpugate_from_signal(x, gate, thr=None, chunk_size=0, padding=0, out_len=None,
                         chunks=None, src_start=0):
    """(rows, n) -> gated views: each whole row (``chunk_size`` 0;
    (rows, out_len) out, ``out_len`` defaulting to n) or the core
    [padding, padding + chunk_size) of each halo'd chunk view
    ((rows*n_chunks, chunk_size) out; with ``chunks`` = (first, count), of
    those chunks only, ``x`` holding the signal from sample ``src_start``
    on), zero past each view's natural length. ``thr``: a
    stationary gate's (bn, bins) threshold (``_threshold_of``), bn 1 or a
    divisor of the views that maps row-major onto them (view v reads row
    v // (views / bn)); None gives each view its own statistics."""
    n = x.shape[-1]
    if chunk_size:
        view_len, out_off, out_len = chunk_size + 2 * padding, padding, chunk_size
    else:
        view_len, out_off = n, 0
        out_len = n if out_len is None else out_len
    geo = gate_geometry(gate.stft_config, view_len)
    re, im = spectra(x, geo, chunk_size, padding, chunks, src_start)
    return istft_ola(re, im, _mask(re, im, gate, thr), geo, out_off, out_len)


def _mask(re, im, gate, thr=None):
    """The gate's smoothed mask of (views, frames, bins) spectra: F, or E
    from the (bn, bins) threshold ``thr`` (view v reads row
    v // (views / bn)) or, for None, from each view's own statistics; then
    the frequency taps through C. The blend comes before the smoothing
    (torchgate.py:241-249), so C blends with prop 1."""
    freq_taps, time_taps = _rank1_taps(gate.smoothing)
    if gate.nonstationary:
        mask = torch_nonstationary_mask(
            re, im, gate.n_movemean_nonstationary, gate.n_thresh_nonstationary,
            gate.temp_coeff_nonstationary, gate.prop_decrease, time_taps,
        )
    elif thr is None:
        mask = stationary_mask(
            re, im, None, 1, gate.prop_decrease, time_taps, top_db=40.0,
            n_std=gate.n_std_thresh_stationary,
        )
    else:
        mask = stationary_mask(
            re, im, thr.to(mask_dtype(re.dtype)).contiguous(), re.shape[0] // thr.shape[0],
            gate.prop_decrease, time_taps, top_db=40.0,
        )
    return freq_smooth_blend(mask, np.asarray(freq_taps), 1.0)


def _staged_twin(gate, x, xn, out_len=None):
    """The cotangent twin: ``gate._call_staged`` of (rows, n) signals, the
    (bn, n_clip) noise rows mapped row-major onto them (row v reads
    v // (rows / bn)), zero filled to ``out_len`` (default: the natural
    length)."""
    if xn is not None and xn.ndim == 2 and xn.shape[0] not in (1, x.shape[0]):
        xn = xn.repeat_interleave(x.shape[0] // xn.shape[0], dim=0)
    y = gate._call_staged(x, xn)
    return y if out_len is None else F.pad(y, (0, out_len - y.shape[-1]))


def fused_tpugate(x: torch.Tensor, xn, gate, out_len=None) -> torch.Tensor:
    """TorchGate of (B, n) signals through the kernels, torch.istft's
    natural (T-1)*hop samples out (``fused_tpugate``, ``:115``), or
    ``out_len`` samples, zero filled past the natural length. ``xn``: None,
    (n_clip,) or (bn, n_clip) with bn a divisor of B, row v of the signal
    reading noise row v // (B / bn). Caller guarantees
    ``fused_tpugate_supported``."""
    if out_len is None:
        out_len = gate_geometry(gate.stft_config, x.shape[-1]).istft_len
    return fused_with_twin(
        lambda a, b: _tpugate_from_signal(a.contiguous(), gate, _threshold_of(gate, b),
                                          out_len=out_len),
        lambda a, b: _staged_twin(gate, a, b, out_len),
        x, xn,
    )


def fused_tpugate_chunked(y2d, gate, chunk_size: int, padding: int,
                          xn=None, group: int = 0, progress: bool = False, mesh=None,
                          axis_name: str = "chunks"):
    """The whole chunked body of the torch-convention engine (reference
    base.py:144-226 with streamed_torch_gate.py): chunk i of each row is
    the view of source samples [i*cs - padding, (i+1)*cs + padding), zero
    outside the signal, gated, its natural-length deficit zero filled, and
    its core [padding, padding + cs) assembled (``api.py:163-175``). Kernel
    A reads the views straight from ``y2d`` and kernel D writes only the
    cores. A signal of at most ``chunk_size`` samples is one view of
    n + 2 * padding samples. ``xn``: a (n_clip,) clip or (bn, n_clip) noise
    rows with bn 1 or ch, row c serving every chunk of channel c; None gives
    each chunk view its own statistics. (ch, n) -> (ch, n). ``group`` > 0
    or ``progress``: the chunks in groups of ``group`` (1 for 0;
    ``parallel.chunking.grouped_cores``), the threshold taken once before
    them. ``mesh``: a signal longer than ``chunk_size`` sharded over its
    devices (``parallel.chunking.shard_cores``; ``api.py::_run_torch_gate``,
    ``:163-190``), the threshold taken once, on ``xn``'s device, and copied
    to each; a shorter one gated on the mesh's first device; the output on
    ``y2d``'s device. ``y2d`` may also be a host signal on its way to the
    card (``parallel.transfer.StagedSignal``, or with a mesh a
    ``HostSignal``): the chunks then run in pieces, each as soon as its
    slabs have arrived, into a ``PinnedCores`` (no gradient)."""
    def forward(y, b):
        thr = _threshold_of(gate, b)
        if mesh is not None and y.shape[-1] > chunk_size:
            return shard_cores(
                lambda yd, start, chunks, t: _tpugate_from_signal(
                    yd, gate, t, chunk_size, padding, chunks=chunks, src_start=start),
                y, chunk_size, padding, mesh, axis_name, group, (thr,))
        home = y.device
        if mesh is not None:
            dev = mesh.devices[0]
            y = y.stage(dev) if isinstance(y, HostSignal) else y.to(dev)
            thr = None if thr is None else thr.to(dev)
        staged = isinstance(y, StagedSignal)
        x = y.buffer if staged else y.contiguous()
        cs = min(chunk_size, y.shape[-1])
        out = grouped_cores(
            lambda chunks: _tpugate_from_signal(x, gate, thr, cs, padding, chunks=chunks),
            y if staged else x, cs, group, progress, padding)
        return out if staged else out.to(home)

    def twin(y, b):
        def call(c, bb):
            v = c.reshape(-1, c.shape[-1])
            return _staged_twin(gate, v, bb, v.shape[-1]).reshape(c.shape)

        return process_chunked(call, y, chunk_size, padding, mesh=mesh, axis_name=axis_name,
                               extra=(b,))

    if not isinstance(y2d, torch.Tensor):
        return forward(y2d, xn)
    return fused_with_twin(forward, twin, y2d, xn)


def staged_tpugate(x: torch.Tensor, xn, gate) -> torch.Tensor:
    """TorchGate of (rows, n) signals for a geometry that kernels A and D do
    not serve (a hop that does not divide n_fft): the plain STFT and iSTFT
    around the mask of F or E and C. Like the fused path, and unlike the
    staged twin ``TPUGate._call_staged``, it smooths with the rank-1 taps
    and gives finite zeros on silence. ``xn``: as ``fused_tpugate``'s, for
    the rows in place of the views. (rows, (T-1)*hop) out. A card tensor
    the kernels do not take (``kernels_take``) runs the staged twin."""
    if not kernels_take(x):
        return _staged_twin(gate, x, xn)
    scfg = gate.stft_config

    def forward(a, b):
        re, im = (t.contiguous() for t in stft(a, scfg))
        thr = None
        if not gate.nonstationary and b is not None:
            rn, in_ = stft(b if b.ndim == 2 else b[None], scfg)
            thr = torch_noise_db_threshold(rn, in_, gate.n_std_thresh_stationary)
        mask = _mask(re, im, gate, thr).to(re.dtype)
        return istft((re * mask, im * mask), scfg)

    return fused_with_twin(forward, lambda a, b: _staged_twin(gate, a, b), x, xn)
