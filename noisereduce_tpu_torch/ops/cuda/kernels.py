"""The seven CUDA kernels of the gates and masks, their wrappers and their
plain PyTorch versions.

Together they replace the merged TPU kernel
``noisereduce_tpu/ops/pallas/dispatch.py::_merged_gate_from_blocks``
(``pallas_call`` at ``:287``) in both its variants and its split twin
(``:723``, ``:758``, ``:804``), and the torch-convention gate
``ops/pallas/torch_dispatch.py::_merged_torch_impl`` (``:382``) and its
split twin ``_fused_torch_impl`` (``:485``, ``:526``, ``:561``); A alone
replaces the noise-clip spectra of ``_fused_stft_planes`` (``:556``) for
both conventions' thresholds, B with one unit tap the time-major mask of
``ops/pallas_mask.py::_fused_mask_tm_cvjp`` (``:364``) and G the
frequency-major mask of ``_fused_mask_cvjp`` (``:229``):

=====  ======================  =============================================
A      ``spectra``             ``kernels.py::_spectra_phases`` (:152)
B      ``nonstationary_mask``  ``kernels.py::_am_kernel`` phase 3 (:443) and
                               ``_time_smooth_phase`` (:375)
C      ``freq_smooth_blend``   ``kernels.py::_freq_smooth_blend_phase`` (:906)
D      ``istft_ola``           ``kernels.py::_apply_istft_kernel`` (:736) and
                               ``dispatch.py::_scipy_istft_tail`` (:331)
E      ``stationary_mask``     ``kernels.py::_as_kernel`` passes A, B and
                               the self-statistics pass (:565-628) and
                               ``_time_smooth_phase`` (:630)
F      ``torch_nonstationary_  ``kernels.py::_mt_kernel`` passes 1-3
       mask``                  (:663-714)
G      ``fm_nonstationary_     ``pallas_mask.py::_mask_kernel`` (:84-149)
       mask``
=====  ======================  =============================================

A and D take either STFT convention: their constant tables and D's
envelope floor and output length come from the geometry's ``StftConfig``.
Each has two routes, picked by the geometry alone
(``geometry.fft_route``): for a power-of-two n_fft (64 to 8192)
shared-memory FFTs, ``csrc/spectra_fft.cu`` and ``csrc/istft_fft.cu``; for
any other n_fft the DFT products ``csrc/spectra.cu`` and
``csrc/istft_ola.cu``. No route is tried after another fails.

Each wrapper takes its plain version (``*_ref``, the plain version of
both routes) for a tensor on the CPU and only then. For a CUDA tensor it
launches its kernel (sources in ``csrc/``, built by ``build.py``) or
raises; it never falls back. Each wrapper counts its launches in an
integer attribute ``launches``, and A and D also by route in
``fft_launches`` and ``product_launches`` (``route_counts``;
``reset_launch_counts`` sets them all to 0). The plain versions follow the
kernels' semantics, including finite zeros on silence (a zero noise floor
takes divisor 1).

Planes are time-major ``(rows, n_frames, n_bins)``, float32 on the card;
G's are frequency-major ``(..., n_bins, n_frames)``.

The wrappers are not differentiable (the kernels write into fresh tensors).
The gradient of every entry point that runs them comes from its staged
twin (``ops/precision.py::fused_with_twin``; the masks in
``ops/cuda_mask.py``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.config import Convention
from noisereduce_tpu_torch.ops import dsp
from noisereduce_tpu_torch.ops.cuda import build
from noisereduce_tpu_torch.ops.cuda.geometry import GateGeometry, fft_route
from noisereduce_tpu_torch.ops.stft import _analysis_window_np, istft, stft
from noisereduce_tpu_torch.parallel.chunking import extract_chunks, n_chunks_for

__all__ = [
    "spectra", "spectra_ref",
    "nonstationary_mask", "nonstationary_mask_ref",
    "freq_smooth_blend", "freq_smooth_blend_ref",
    "istft_ola", "istft_ola_ref",
    "stationary_mask", "stationary_mask_ref",
    "torch_nonstationary_mask", "torch_nonstationary_mask_ref",
    "fm_nonstationary_mask", "fm_nonstationary_mask_ref",
    "reset_launch_counts", "launch_counts", "route_counts",
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


def _wsum(scfg) -> float:
    """sum w for scipy (its spectra divide by it, its istft multiplies), 1
    for torch."""
    w = _analysis_window_np(scfg)
    return float(w.sum()) if scfg.convention == Convention.SCIPY else 1.0


@functools.lru_cache(maxsize=None)
def _analysis_table_np(scfg) -> np.ndarray:
    """(k_a, cols_a) float64: row n = frame sample, columns
    [0, n_bins) = w[n] cos(2 pi k n / N) s, [n_bins, 2 n_bins) =
    -w[n] sin(...) s, with s = 1 / sum w for scipy and 1 for torch; zero
    padded. The tables depend on the STFT geometry only, hence a view
    length of 0."""
    geo = GateGeometry(scfg, 0)
    w = _analysis_window_np(scfg)
    F_ = geo.n_bins
    n = np.arange(geo.win, dtype=np.float64)[:, None]
    k = np.arange(F_, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / geo.n_fft
    ws = (w / _wsum(scfg))[:, None]
    tab = np.zeros((geo.k_a, geo.cols_a), np.float64)
    tab[: geo.win, :F_] = ws * np.cos(ang)
    tab[: geo.win, F_ : 2 * F_] = -ws * np.sin(ang)
    return tab


@functools.lru_cache(maxsize=None)
def _synthesis_table_np(scfg) -> np.ndarray:
    """(r * f2, cols_d) float64: row i*f2 + c, column q, with u = i*hop + q:
    c < n_bins: c_k cos(2 pi k u / N) / N * post[u] (k = c);
    n_bins <= c < 2 n_bins: -c_k sin(...) / N * post[u] (k = c - n_bins);
    c_k = 1 at DC and Nyquist, else 2 (irfft's Hermitian weights);
    post = w * sum w for scipy (its istft rescales by sum w) and w for
    torch."""
    geo = GateGeometry(scfg, 0)
    w = _analysis_window_np(scfg)
    N, F_, hop, r, f2 = geo.n_fft, geo.n_bins, geo.hop, geo.r, geo.f2
    wsum = _wsum(scfg)
    k = np.arange(F_, dtype=np.float64)[:, None]
    ck = np.full((F_, 1), 2.0)
    ck[0] = 1.0
    if N % 2 == 0:
        ck[-1] = 1.0
    tab = np.zeros((r * f2, geo.cols_d), np.float64)
    for i in range(r):
        u = np.arange(i * hop, (i + 1) * hop, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * k * u / N
        post = (w[i * hop : (i + 1) * hop] * wsum)[None, :] / N
        cos_rows = ck * np.cos(ang) * post
        sin_rows = -ck * np.sin(ang) * post
        sin_rows[0] = 0.0  # irfft ignores the imaginary DC part
        if N % 2 == 0:
            sin_rows[-1] = 0.0  # ... and the imaginary Nyquist part
        tab[i * f2 : i * f2 + F_, :hop] = cos_rows
        tab[i * f2 + F_ : i * f2 + 2 * F_, :hop] = sin_rows
    return tab


@functools.lru_cache(maxsize=None)
def _twiddle_np(n_fft: int) -> np.ndarray:
    """(n_fft, 2) float64: tw[k] = e^{-2 pi i k / n_fft} as (re, im), with
    exact zeros at the quarter turns (the FFT route's twiddles)."""
    t = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    tab = np.stack([t.real, t.imag], axis=-1)
    tab[np.abs(tab) < 1e-12] = 0.0
    return tab


@functools.lru_cache(maxsize=None)
def _scaled_window_np(scfg) -> np.ndarray:
    """(frame_length,) float64: the FFT route's analysis window w * s, s =
    1 / sum w for scipy and 1 for torch."""
    return _analysis_window_np(scfg) / _wsum(scfg)


@functools.lru_cache(maxsize=None)
def _post_window_np(scfg) -> np.ndarray:
    """(frame_length,) float64: the FFT route's synthesis window w * sum w
    / (n_fft/2) for scipy, w / (n_fft/2) for torch; 1/(n_fft/2) undoes the
    unscaled half-length inverse FFT."""
    return _analysis_window_np(scfg) * _wsum(scfg) / (scfg.n_fft // 2)


@functools.lru_cache(maxsize=None)
def _window_squares_np(scfg) -> np.ndarray:
    """(frame_length,) w^2, rounded to float32 for a float32 window, as
    ``ops/stft.py::_ola_norm_np`` takes them."""
    w = _analysis_window_np(scfg)
    return (w * w).astype(np.float32 if scfg.quantize_window_f32 else np.float64)


@functools.lru_cache(maxsize=None)
def _interior_envelope_np(scfg) -> np.ndarray:
    """(hop,): the window-square envelope of an output hop block that all r
    frames cover, w^2[i*hop + q] summed over the frames in ascending order
    (i descending), in float32 for a float32 window: the plain version's
    envelope (``ops/stft.py::_ola_norm_np``) to the bit."""
    wsq = _window_squares_np(scfg).reshape(-1, scfg.hop_length)
    env = np.zeros(scfg.hop_length, wsq.dtype)
    for row in wsq[::-1]:
        env += row
    return env.astype(np.float64)


_TABLES = {
    "analysis": _analysis_table_np,
    "synthesis": _synthesis_table_np,
    "window": _analysis_window_np,
    "twiddle": _twiddle_np,  # key: n_fft
    "scaled_window": _scaled_window_np,
    "post_window": _post_window_np,
    "window_squares": _window_squares_np,
    "envelope": _interior_envelope_np,
    "taps": lambda key: np.asarray(key, np.float64),  # key: the tap values
}


@functools.lru_cache(maxsize=None)
def _device_f32(kind: str, key, device: torch.device) -> torch.Tensor:
    """A constant table as a float32 tensor on ``device``, built once."""
    a = _TABLES[kind](key)
    return torch.as_tensor(a, dtype=torch.float32).to(device).contiguous()


# ---------------------------------------------------------------------------
# A: spectra
# ---------------------------------------------------------------------------
def spectra_ref(x, geo: GateGeometry, chunk_size=0, padding=0):
    """Plain version of ``spectra``: extract the views, then the staged
    STFT."""
    views = extract_chunks(x, chunk_size, padding) if chunk_size else x[:, None]
    return stft(views.reshape(-1, geo.view_len), geo.scfg)


def spectra(x, geo: GateGeometry, chunk_size=0, padding=0):
    """Windowed frame spectra (``stft`` of the geometry's convention) of
    every view of every signal row.

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
    return _spectra_on(_route(geo), x, geo, chunk_size, padding)


def _route(geo: GateGeometry) -> str:
    """Kernels A and D's route for the geometry: "fft" or "product"."""
    return "fft" if fft_route(geo.scfg) else "product"


def _spectra_on(route, x, geo: GateGeometry, chunk_size=0, padding=0):
    """Launch kernel A's ``route`` on a CUDA tensor, and count it."""
    _check_cuda("spectra", x)
    rows, n_src = x.shape
    n_chunks = n_chunks_for(n_src, chunk_size) if chunk_size else 1
    B, T, nb = rows * n_chunks, geo.n_frames, geo.n_bins
    re = torch.empty((B, T, nb), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    views = (n_src, rows, n_chunks, chunk_size, -padding, geo.view_len, T,
             geo.hop, geo.bpad, geo.win)
    if route == "fft":
        _check_size("spectra", B * T, B * -(-T // geo.fft_tile_frames))
        _launch(
            "spectra_fft", x.device, _ptr(x), *views, geo.n_fft, nb,
            geo.fft_tile_frames,
            _ptr(_device_f32("scaled_window", geo.scfg, x.device)),
            _ptr(_device_f32("twiddle", geo.n_fft, x.device)), _ptr(re), _ptr(im),
        )
        spectra.fft_launches += 1
    else:
        _check_size("spectra", B * T, -(-B * T // 128) * (geo.cols_a // 128))
        tab = _device_f32("analysis", geo.scfg, x.device)
        _launch(
            "spectra", x.device, _ptr(x), *views, nb, _ptr(tab), geo.cols_a,
            geo.k_a, _ptr(re), _ptr(im),
        )
        spectra.product_launches += 1
    spectra.launches += 1
    return re, im


# ---------------------------------------------------------------------------
# B: nonstationary_mask
# ---------------------------------------------------------------------------
def nonstationary_mask_ref(re, im, b, thresh, slope, taps):
    """Plain version of ``nonstationary_mask``."""
    mag = torch.sqrt(re * re + im * im)
    floor = dsp.ewma_filtfilt(mag, b, axis=-2)  # float64 state, as the kernel's
    ratio = (mag - floor) / torch.where(floor == 0, 1.0, floor)
    raw = dsp.sigmoid(ratio, -thresh, slope)
    return dsp.conv_same(raw, taps, -2)


def nonstationary_mask(re, im, b, thresh, slope, taps):
    """Filtfilt IIR noise floor, sigmoid mask and time smoothing.

    re/im: (rows, n_frames, n_bins). Per bin: y = forward EWMA of |Z| with
    y[0] = |Z|[0]; w = the same recurrence backwards over y with
    w[T-1] = y[T-1], both carried in float64;
    mask = sigmoid(((|Z| - w)/w' - thresh) * slope) with
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
    """Plain version of ``istft_ola``: the staged iSTFT of the masked
    spectra, windowed and zero filled."""
    y = istft((re * mask, im * mask), geo.scfg)[..., out_off : out_off + out_len]
    return F.pad(y, (0, out_len - y.shape[-1]))


def istft_ola(re, im, mask, geo: GateGeometry, out_off, out_len):
    """Masked inverse STFT of each row in the geometry's convention,
    returning only trimmed samples [out_off, out_off + out_len) as
    (rows, out_len); samples past the istft length (scipy's, or torch's
    natural (T-1)*hop) are zero."""
    if _on_cpu(re, im, mask):
        return istft_ola_ref(re, im, mask, geo, out_off, out_len)
    return _istft_ola_on(_route(geo), re, im, mask, geo, out_off, out_len)


def _istft_ola_on(route, re, im, mask, geo: GateGeometry, out_off, out_len):
    """Launch kernel D's ``route`` on CUDA tensors, and count it."""
    _check_cuda("istft_ola", re, im, mask)
    rows, T, nb = re.shape
    j0, n_out = geo.out_blocks(out_off, out_len)
    out = torch.empty((rows, out_len), dtype=torch.float32, device=re.device)
    if route == "fft":
        _check_size("istft_ola", rows * T * nb, rows * -(-n_out // geo.fft_run))
        _launch(
            "istft_fft", re.device, _ptr(re), _ptr(im), _ptr(mask), rows, T, nb,
            geo.n_fft, geo.hop, geo.r, geo.bpad, j0, n_out, geo.fft_run,
            out_off, out_len, geo.istft_len, geo.env_floor,
            _ptr(_device_f32("post_window", geo.scfg, re.device)),
            _ptr(_device_f32("window_squares", geo.scfg, re.device)),
            _ptr(_device_f32("envelope", geo.scfg, re.device)),
            _ptr(_device_f32("twiddle", geo.n_fft, re.device)), _ptr(out),
        )
        istft_ola.fft_launches += 1
    else:
        _check_size(
            "istft_ola", rows * n_out, -(-rows * n_out // 128) * (geo.cols_d // 128)
        )
        tab = _device_f32("synthesis", geo.scfg, re.device)
        win = _device_f32("window", geo.scfg, re.device)
        _launch(
            "istft_ola", re.device, _ptr(re), _ptr(im), _ptr(mask), _ptr(win),
            _ptr(tab), geo.cols_d, geo.f2, rows, T, nb, geo.hop, geo.r, geo.bpad,
            j0, n_out, out_off, out_len, geo.istft_len, geo.env_floor, _ptr(out),
        )
        istft_ola.product_launches += 1
    istft_ola.launches += 1
    return out


# ---------------------------------------------------------------------------
# E: stationary_mask
# ---------------------------------------------------------------------------
# 20 / ln 10: dB as a natural log times a constant, the TPU kernel's formula
# (kernels.py:573), in the kernel and in its plain version alike
_DB_PER_NEPER = 20.0 / float(np.log(10.0))


def _check_thr(thr, views, views_per_row, n_bins) -> None:
    """A (n_bins,) threshold is shared by every view; row r of a
    (rows, n_bins) one serves views [r * views_per_row, (r + 1) *
    views_per_row); None asks for each view's own statistics."""
    if thr is None:
        return
    if thr.shape[-1] != n_bins or thr.ndim not in (1, 2) or (
        thr.ndim == 2 and thr.shape[0] * views_per_row != views
    ):
        raise ValueError(
            f"stationary_mask: threshold of shape {tuple(thr.shape)} for "
            f"{views} views of {n_bins} bins, {views_per_row} views per row"
        )


def _self_threshold(db, mx, n_std):
    """Each view's own threshold, (views, n_bins) float64: mean + n_std *
    std (ddof 1) over frames of the clamped dB ``db``, from float64 sums of
    dB - ``mx`` (the column max) and its square, as kernel E forms it; the
    shift keeps the one-pass variance from cancelling."""
    n = db.shape[-2]
    mx = mx.to(torch.float64)
    d = db.to(torch.float64) - mx
    s1, s2 = d.sum(dim=-2), (d * d).sum(dim=-2)
    var = torch.clamp(s2 - s1 * s1 / n, min=0.0) / max(n - 1, 1)
    return mx[..., 0, :] + s1 / n + torch.sqrt(var) * n_std


def stationary_mask_ref(re, im, thr, views_per_row, prop, taps, top_db=80.0,
                        n_std=None):
    """Plain version of ``stationary_mask``, with the kernel's dB formula."""
    views, _, nb = re.shape
    _check_thr(thr, views, views_per_row, nb)
    db = torch.log(torch.sqrt(re * re + im * im) + dsp.EPS_F64) * _DB_PER_NEPER
    mx = db.amax(dim=-2, keepdim=True)
    db = torch.maximum(db, mx - top_db)
    if thr is None:
        m = db.to(torch.float64) > _self_threshold(db, mx, n_std)[:, None, :]
    else:
        thr = thr.to(re.dtype)
        thr = thr.repeat_interleave(views_per_row, dim=0) if thr.ndim == 2 else thr[None]
        m = db > thr[:, None, :]
    m = m.to(re.dtype)
    return dsp.conv_same(m * prop + (1.0 - prop), taps, -2)


def stationary_mask(re, im, thr, views_per_row, prop, taps, top_db=80.0,
                    n_std=None):
    """Stationary mask: dB spectrogram floored at its per-bin max -
    ``top_db`` (80 for the scipy engine, 40 for TorchGate), 1[dB > thr]
    blended as m*prop + (1 - prop) BEFORE a 'same' correlation along frames
    with the odd ``taps`` (numpy), zero outside the frames.

    re/im: (views, n_frames, n_bins). thr: (n_bins,), shared, or
    (rows, n_bins) with view v reading row v // ``views_per_row`` (the
    chunk views of one signal row share its threshold); or None, and then
    each view takes its own: mean + ``n_std`` * std (ddof 1) over frames of
    its clamped dB (TorchGate with no noise clip, torchgate.py:126-165),
    accumulated in float64 and compared in float64.
    """
    if thr is None and n_std is None:
        raise ValueError("stationary_mask: self statistics need n_std")
    ts = (re, im) if thr is None else (re, im, thr)
    if _on_cpu(*ts):
        return stationary_mask_ref(re, im, thr, views_per_row, prop, taps, top_db, n_std)
    _check_cuda("stationary_mask", *ts)
    views, T, nb = re.shape
    _check_thr(thr, views, views_per_row, nb)
    _check_size("stationary_mask", views * nb)
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), re.device)
    scratch = torch.empty_like(re) if len(taps) > 1 else re
    out = torch.empty_like(re)
    _launch(
        "stationary_mask", re.device, _ptr(re), _ptr(im),
        ctypes.c_void_p(None) if thr is None else _ptr(thr),
        nb if thr is not None and thr.ndim == 2 else 0, views_per_row,
        _ptr(scratch), _ptr(out), _ptr(tap_t), len(taps), views, T, nb, prop,
        1.0 - prop, dsp.EPS_F64, _DB_PER_NEPER, top_db,
        0.0 if n_std is None else n_std,
    )
    stationary_mask.launches += 1
    return out


# ---------------------------------------------------------------------------
# F: torch_nonstationary_mask
# ---------------------------------------------------------------------------
def torch_nonstationary_mask_ref(re, im, n_movemean, n_thresh, temp, prop, taps):
    """Plain version of ``torch_nonstationary_mask``."""
    mag = torch.sqrt(re * re + im * im)
    ma = dsp.moving_average_same(mag, n_movemean, axis=-2)  # float64 sums
    ratio = (mag - ma) / torch.where(ma == 0, 1.0, ma)
    m = dsp.temperature_sigmoid(ratio, n_thresh, temp)
    return dsp.conv_same(m * prop + (1.0 - prop), taps, -2)


def torch_nonstationary_mask(re, im, n_movemean, n_thresh, temp, prop, taps):
    """TorchGate's non-stationary mask (torchgate.py:167-198, 241-249).

    re/im: (views, n_frames, n_bins). Per bin: ma = the 'same' moving
    average of |Z| over ``n_movemean`` frames (zero outside the frames;
    (n-1)//2 before, the rest after), its window sum carried in float64;
    m = sigmoid(((|Z| - ma) / ma' - n_thresh) / temp) with ma' = 1 where
    ma == 0 (silence gives finite zeros); the blend m*prop + (1 - prop)
    BEFORE a 'same' correlation along frames with the odd ``taps``.
    """
    if _on_cpu(re, im):
        return torch_nonstationary_mask_ref(re, im, n_movemean, n_thresh, temp, prop, taps)
    _check_cuda("torch_nonstationary_mask", re, im)
    views, T, nb = re.shape
    _check_size("torch_nonstationary_mask", views * nb)
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), re.device)
    scratch = torch.empty_like(re) if len(taps) > 1 else re
    out = torch.empty_like(re)
    _launch(
        "torch_nonstationary_mask", re.device, _ptr(re), _ptr(im),
        _ptr(scratch), _ptr(out), _ptr(tap_t), len(taps), views, T, nb,
        int(n_movemean), n_thresh, temp, prop, 1.0 - prop,
    )
    torch_nonstationary_mask.launches += 1
    return out


# ---------------------------------------------------------------------------
# G: fm_nonstationary_mask
# ---------------------------------------------------------------------------
def fm_nonstationary_mask_ref(z, b, thresh, slope):
    """Plain version of ``fm_nonstationary_mask``; |Z| as the kernel forms
    it, sqrt(re^2 + im^2)."""
    mag = torch.sqrt(z.real * z.real + z.imag * z.imag) if z.is_complex() else z
    floor = dsp.ewma_filtfilt(mag, b, axis=-1)  # float64 state, as the kernel's
    ratio = (mag - floor) / torch.where(floor == 0, 1.0, floor)
    return dsp.sigmoid(ratio, -thresh, slope)


def fm_nonstationary_mask(z, b, thresh, slope):
    """Filtfilt IIR noise floor and sigmoid mask of a frequency-major plane,
    no time smoothing.

    z: (..., n_bins, n_frames), complex64 or a float32 magnitude plane.
    Per (row, bin) column: y = forward EWMA of |Z| along frames with
    y[0] = |Z|[0]; w = the same recurrence backwards over y with
    w[T-1] = y[T-1], both carried in float64;
    mask = sigmoid(((|Z| - w)/w' - thresh) * slope) with w' = 1 where
    w == 0. Returns the float32 mask, z's shape.
    """
    if _on_cpu(z):
        return fm_nonstationary_mask_ref(z, b, thresh, slope)
    is_complex = z.is_complex()
    if is_complex and z.dtype != torch.complex64:
        raise TypeError(f"fm_nonstationary_mask: the kernel takes complex64, got {z.dtype}")
    zr = torch.view_as_real(z) if is_complex else z
    _check_cuda("fm_nonstationary_mask", zr)
    T = z.shape[-1]
    n_cols = z.numel() // T if T else 0
    out = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    scratch = torch.empty_like(out)
    _launch(
        "fm_nonstationary_mask", z.device, _ptr(zr), int(is_complex),
        _ptr(scratch), _ptr(out), n_cols, T, float(b), thresh, slope,
    )
    fm_nonstationary_mask.launches += 1
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
KERNELS = (spectra, nonstationary_mask, freq_smooth_blend, istft_ola,
           stationary_mask, torch_nonstationary_mask, fm_nonstationary_mask)
ROUTED = (spectra, istft_ola)  # the kernels with an FFT and a product route


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in ROUTED:
        fn.fft_launches = fn.product_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def route_counts() -> dict:
    """Launches of kernels A and D by route, e.g.
    {"spectra": {"fft": 1, "product": 0}, "istft_ola": {...}}."""
    return {fn.__name__: {"fft": fn.fft_launches, "product": fn.product_launches}
            for fn in ROUTED}


reset_launch_counts()
