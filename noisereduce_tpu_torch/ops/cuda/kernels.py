"""The four CUDA kernels of the non-stationary gate, their wrappers and
their plain PyTorch versions.

Together they replace the merged TPU kernel
``noisereduce_tpu/ops/pallas/dispatch.py::_merged_gate_from_blocks``
(``pallas_call`` at ``:287``):

=====  ======================  =============================================
A      ``spectra``             ``kernels.py::_spectra_phases`` (:152)
B      ``nonstationary_mask``  ``kernels.py::_am_kernel`` phase 3 (:443) and
                               ``_time_smooth_phase`` (:375)
C      ``freq_smooth_blend``   ``kernels.py::_freq_smooth_blend_phase`` (:906)
D      ``istft_ola``           ``kernels.py::_apply_istft_kernel`` (:736) and
                               ``dispatch.py::_scipy_istft_tail`` (:331)
=====  ======================  =============================================

Each wrapper takes its plain version (``*_ref``) for a tensor on the CPU
and only then. For a CUDA tensor it launches its kernel (sources in
``csrc/``, built by ``build.py``) or raises; it never falls back. Each
wrapper counts its launches in an integer attribute ``launches``
(``reset_launch_counts`` sets them to 0). The plain versions follow the
kernels' semantics, including finite zeros on silence (a zero noise floor
takes divisor 1).

Planes are time-major ``(rows, n_frames, n_bins)``, float32 on the card.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.ops import dsp
from noisereduce_tpu_torch.ops.cuda import build
from noisereduce_tpu_torch.ops.cuda.geometry import GateGeometry
from noisereduce_tpu_torch.ops.stft import _analysis_window_np, istft, stft
from noisereduce_tpu_torch.parallel.chunking import extract_chunks, n_chunks_for

__all__ = [
    "spectra", "spectra_ref",
    "nonstationary_mask", "nonstationary_mask_ref",
    "freq_smooth_blend", "freq_smooth_blend_ref",
    "istft_ola", "istft_ola_ref",
    "reset_launch_counts", "launch_counts",
]

_INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device."""
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: expected tensors on one CUDA device, got "
                f"{[str(u.device) for u in ts]}"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry ``nr_<name>`` on ``device``'s current stream, with
    ``device`` current (a ctypes launch goes to the runtime's current
    device), and raise on its CUDA error code."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        code = getattr(build.load(), f"nr_{name}")(*args, stream)
    build.check(name, code)


def _check_size(name: str, *sizes: int) -> None:
    for s in sizes:
        if s > _INT32_MAX:
            raise ValueError(f"{name}: {s} rows exceed one launch's int32 index")


@functools.lru_cache(maxsize=None)
def _analysis_table_np(scfg) -> np.ndarray:
    """(k_a, cols_a) float64: row n = window sample, columns
    [0, n_bins) = w[n] cos(2 pi k n / N) / sum w, [n_bins, 2 n_bins) =
    -w[n] sin(...) / sum w; zero padded. The tables depend on the STFT
    geometry only, hence a view length of 0."""
    geo = GateGeometry(scfg, 0)
    w = _analysis_window_np(scfg)
    F_ = geo.n_bins
    n = np.arange(geo.win, dtype=np.float64)[:, None]
    k = np.arange(F_, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / geo.n_fft
    ws = (w / w.sum())[:, None]
    tab = np.zeros((geo.k_a, geo.cols_a), np.float64)
    tab[: geo.win, :F_] = ws * np.cos(ang)
    tab[: geo.win, F_ : 2 * F_] = -ws * np.sin(ang)
    return tab


@functools.lru_cache(maxsize=None)
def _synthesis_table_np(scfg) -> np.ndarray:
    """(r * f2, cols_d) float64: row i*f2 + c, column q, with u = i*hop + q:
    c < n_bins: c_k cos(2 pi k u / N) / N * w[u] * sum w (k = c);
    n_bins <= c < 2 n_bins: -c_k sin(...) / N * w[u] * sum w (k = c - n_bins);
    c_k = 1 at DC and Nyquist, else 2 (irfft's Hermitian weights)."""
    geo = GateGeometry(scfg, 0)
    w = _analysis_window_np(scfg)
    N, F_, hop, r, f2 = geo.n_fft, geo.n_bins, geo.hop, geo.r, geo.f2
    k = np.arange(F_, dtype=np.float64)[:, None]
    ck = np.full((F_, 1), 2.0)
    ck[0] = 1.0
    if N % 2 == 0:
        ck[-1] = 1.0
    tab = np.zeros((r * f2, geo.cols_d), np.float64)
    for i in range(r):
        u = np.arange(i * hop, (i + 1) * hop, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * k * u / N
        post = (w[i * hop : (i + 1) * hop] * w.sum())[None, :] / N
        cos_rows = ck * np.cos(ang) * post
        sin_rows = -ck * np.sin(ang) * post
        sin_rows[0] = 0.0  # irfft ignores the imaginary DC part
        if N % 2 == 0:
            sin_rows[-1] = 0.0  # ... and the imaginary Nyquist part
        tab[i * f2 : i * f2 + F_, :hop] = cos_rows
        tab[i * f2 + F_ : i * f2 + 2 * F_, :hop] = sin_rows
    return tab


@functools.lru_cache(maxsize=None)
def _device_f32(kind: str, key, device: torch.device) -> torch.Tensor:
    """A constant table as a float32 tensor on ``device``, built once."""
    if kind == "analysis":
        a = _analysis_table_np(key)
    elif kind == "synthesis":
        a = _synthesis_table_np(key)
    elif kind == "window":
        a = _analysis_window_np(key)
    else:  # "taps": key is the tuple of tap values
        a = np.asarray(key, np.float64)
    return torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()


# ---------------------------------------------------------------------------
# A: spectra
# ---------------------------------------------------------------------------
def spectra_ref(x, geo: GateGeometry, chunk_size=0, padding=0):
    """Plain version of ``spectra``: extract the views, then the staged
    scipy STFT."""
    views = extract_chunks(x, chunk_size, padding) if chunk_size else x[:, None]
    return stft(views.reshape(-1, geo.view_len), geo.scfg)


def spectra(x, geo: GateGeometry, chunk_size=0, padding=0):
    """Windowed frame spectra (scipy ``stft``) of every view of every
    signal row.

    x: (rows, n_src). With ``chunk_size`` 0 each row is one view
    (``geo.view_len == n_src``); otherwise the views are the halo'd chunks
    of ``parallel.chunking.extract_chunks`` (chunk i: source samples
    [i*chunk_size - padding, (i+1)*chunk_size + padding), zero outside the
    signal), which the kernel reads straight from ``x``. Returns (re, im),
    each (rows*n_views, n_frames, n_bins), row h*n_views + i.
    """
    if not chunk_size and geo.view_len != x.shape[-1]:
        raise ValueError(
            f"spectra: view_len {geo.view_len} != signal length {x.shape[-1]}"
        )
    if _on_cpu(x):
        return spectra_ref(x, geo, chunk_size, padding)
    _check_cuda("spectra", x)
    rows, n_src = x.shape
    n_chunks = n_chunks_for(n_src, chunk_size) if chunk_size else 1
    B, T, nb = rows * n_chunks, geo.n_frames, geo.n_bins
    _check_size("spectra", B * T, -(-B * T // 128) * (geo.cols_a // 128))
    tab = _device_f32("analysis", geo.scfg, x.device)
    re = torch.empty((B, T, nb), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    _launch(
        "spectra", x.device, _ptr(x), n_src, rows, n_chunks, chunk_size,
        -padding, geo.view_len, T, geo.hop, geo.bpad, geo.win, nb,
        _ptr(tab), geo.cols_a, geo.k_a, _ptr(re), _ptr(im),
    )
    spectra.launches += 1
    return re, im


# ---------------------------------------------------------------------------
# B: nonstationary_mask
# ---------------------------------------------------------------------------
def nonstationary_mask_ref(re, im, b, thresh, slope, taps):
    """Plain version of ``nonstationary_mask``."""
    mag = torch.sqrt(re * re + im * im)
    floor = dsp.ewma_filtfilt(mag, b, axis=-2)
    ratio = (mag - floor) / torch.where(floor == 0, 1.0, floor)
    raw = dsp.sigmoid(ratio, -thresh, slope)
    return dsp.conv_same(raw, taps, -2)


def nonstationary_mask(re, im, b, thresh, slope, taps):
    """Filtfilt IIR noise floor, sigmoid mask and time smoothing.

    re/im: (rows, n_frames, n_bins). Per bin: y = forward EWMA of |Z| with
    y[0] = |Z|[0]; w = the same recurrence backwards over y with
    w[T-1] = y[T-1]; mask = sigmoid(((|Z| - w)/w' - thresh) * slope) with
    w' = 1 where w == 0; then a 'same' correlation along frames with the odd
    ``taps`` (numpy), zero outside the frames.
    """
    if _on_cpu(re, im):
        return nonstationary_mask_ref(re, im, b, thresh, slope, taps)
    _check_cuda("nonstationary_mask", re, im)
    rows, T, nb = re.shape
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), re.device)
    scratch = torch.empty_like(re)
    out = torch.empty_like(re)
    _launch(
        "nonstationary_mask", re.device, _ptr(re), _ptr(im), _ptr(scratch),
        _ptr(out), _ptr(tap_t), len(taps), rows, T, nb, b, thresh, slope,
    )
    nonstationary_mask.launches += 1
    return out


# ---------------------------------------------------------------------------
# C: freq_smooth_blend
# ---------------------------------------------------------------------------
def freq_smooth_blend_ref(mask, taps, prop):
    """Plain version of ``freq_smooth_blend``."""
    return dsp.conv_same(mask, taps, -1) * prop + (1.0 - prop)


def freq_smooth_blend(mask, taps, prop):
    """'same' correlation along bins with the odd ``taps`` (zero outside
    the bins), then the non-stationary blend m*prop + (1 - prop)."""
    if _on_cpu(mask):
        return freq_smooth_blend_ref(mask, taps, prop)
    _check_cuda("freq_smooth_blend", mask)
    nb = mask.shape[-1]
    n_rows = mask.numel() // nb
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), mask.device)
    out = torch.empty_like(mask)
    _launch(
        "freq_smooth_blend", mask.device, _ptr(mask), _ptr(out), _ptr(tap_t),
        len(taps), n_rows, nb, prop,
    )
    freq_smooth_blend.launches += 1
    return out


# ---------------------------------------------------------------------------
# D: istft_ola
# ---------------------------------------------------------------------------
def istft_ola_ref(re, im, mask, geo: GateGeometry, out_off, out_len):
    """Plain version of ``istft_ola``: the staged scipy iSTFT of the masked
    spectra, windowed and zero filled."""
    y = istft((re * mask, im * mask), geo.scfg)[..., out_off : out_off + out_len]
    return F.pad(y, (0, out_len - y.shape[-1]))


def istft_ola(re, im, mask, geo: GateGeometry, out_off, out_len):
    """Masked inverse STFT (scipy convention) of each row, returning only
    trimmed samples [out_off, out_off + out_len) as (rows, out_len); samples
    past the istft length are zero."""
    if _on_cpu(re, im, mask):
        return istft_ola_ref(re, im, mask, geo, out_off, out_len)
    _check_cuda("istft_ola", re, im, mask)
    rows, T, nb = re.shape
    j0, n_out = geo.out_blocks(out_off, out_len)
    _check_size(
        "istft_ola", rows * n_out, -(-rows * n_out // 128) * (geo.cols_d // 128)
    )
    tab = _device_f32("synthesis", geo.scfg, re.device)
    win = _device_f32("window", geo.scfg, re.device)
    out = torch.empty((rows, out_len), dtype=torch.float32, device=re.device)
    _launch(
        "istft_ola", re.device, _ptr(re), _ptr(im), _ptr(mask), _ptr(win),
        _ptr(tab), geo.cols_d, geo.f2, rows, T, nb, geo.hop, geo.r, geo.bpad,
        j0, n_out, out_off, out_len, geo.istft_len, _ptr(out),
    )
    istft_ola.launches += 1
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
KERNELS = (spectra, nonstationary_mask, freq_smooth_blend, istft_ola)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
