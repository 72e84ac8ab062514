"""The seven CUDA kernels of the gates and masks and the output's cast
(H), their wrappers and their plain PyTorch versions.

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

H ``output_cast`` replaces no TPU kernel: it narrows a card's float32 (or
bfloat16) output to an integer or float16 caller's dtype as numpy's
``astype`` does on x86, which the JAX package runs on the host
(``noisereduce_tpu/api.py:630``), so that the D2H moves the narrow bytes
into the call's pinned output (``parallel/transfer.py::to_output``).

A and D take either STFT convention: their constant tables and D's
envelope floor and output length come from the geometry's ``StftConfig``.
Each has five routes, picked by the geometry alone
(``geometry.fft_route``, the rules of ``csrc/fft_route.cuh``; a frame's
transform has n = n_fft/2 complex points, or n_fft for an odd n_fft, two
frames a transform):

- "fft": an n_fft whose n has no prime factor above 13 and fits a block
  (4096 points) or is below a big block's 8192 points with no cluster
  shape (8580, odd 5005), or none above 31 and fits a block,
  shared-memory mixed-radix FFTs: ``csrc/spectra_fft.cu`` and
  ``csrc/istft_fft.cu`` for an even n_fft to 8192 whose half is 2^k 3^a
  5^b 7^c (2, 40, 1024, 1536, ...), ``csrc/spectra_cplx.cu`` and
  ``csrc/istft_cplx.cu`` (the complex-frame kernels) for the rest (1100,
  441, 1323, 8580, odd 3 and 63; 1102, 493, 34 and 62 with radices 17 to
  31, ...), A's and D's builds as persistent blocks that walk A's tiles
  or D's runs, as many as ``real_capacity`` or ``cplx_capacity`` says the
  card holds; an n_fft below 64 (n of 1 to 31
  points, or 63 odd) in tiles and runs of up to a few thousand frames;
- "cluster": such an n past a block with a cluster shape, to 65,536
  points (``geometry.cluster_shape``), a four-step FFT across a thread
  block cluster's shared memory: ``csrc/spectra_cluster.cu`` and
  ``csrc/istft_cluster.cu`` (12000, 16380, 16384, 40000, 32768, ...);
- "chirp": any other n whose chirp length fits a big block (n to 4096
  with a prime factor above 31: 1101, 4106, odd 37 to 61 of the primes,
  ...), a chirp-z transform in the complex-frame kernels, its chirp and
  filter spectrum host tables built in float64 (``_chirp_np``,
  ``_chirp_filter_np``);
- "cluster_chirp": any other n to 32,768 points (an n with a prime factor
  above 13 past 4096 points, a 13-smooth n past a big block with no
  cluster shape: 4801, 4803, 16386, 16940, 65534, ...), a chirp-z
  transform whose length (``geometry.chirp_length``: the smallest 2^a 3^b
  5^c >= 2n - 1 with a cluster shape) runs the cluster route's four-step
  FFT, in ``csrc/spectra_cluster_chirp.cu`` and
  ``csrc/istft_cluster_chirp.cu`` (the ``CHIRP`` builds of
  ``csrc/spectra_cluster.cuh`` and ``csrc/istft_cluster.cuh``), the
  filter spectrum laid out in that FFT's order
  (``_cluster_chirp_filter_np``);
- "global_chirp": any other n past 32,768 points, to 8,388,608 (40005,
  65538, 144000, 192000, ...), a chirp-z transform whose length
  (``geometry.chirp_length``: the smallest 2^a 3^b 5^c >= 2n - 1 that
  splits as L1 L2, each within a block, ``geometry.global_split``) runs a
  four-step FFT in passes of ordinary blocks through a scratch in device
  memory, in ``csrc/spectra_global.cu`` and ``csrc/istft_global.cu`` (over
  ``csrc/fft_global.cuh``), a group of slots a launch of each pass
  (``geometry.global_group``), the filter spectrum and the four-step
  twiddles laid out in the passes' order (``_global_chirp_filter_np``,
  ``_global_twiddle_np``).

An n past 8,388,608 points has no route: ``geometry.kernels_supported``
refuses it, and the staged twins take it.
No route is tried after another fails.

Each wrapper takes its plain version (``*_ref``, the plain version of
every route) for a tensor on the CPU and only then. For a CUDA tensor it
launches its kernel (sources in ``csrc/``, built by ``build.py``) or
raises; it never falls back. Each wrapper counts its launches in an
integer attribute ``launches``, and A and D also by route in
``fft_launches``, ``chirp_launches``, ``cluster_launches``,
``cluster_chirp_launches`` and ``global_chirp_launches``
(``route_counts``),
and G in ``resident_launches``
and ``tiled_launches``, every kernel by its planes' dtype in
``dtype_launches``
(``dtype_counts``) and by device in ``device_launches``
(``device_counts``); ``reset_launch_counts`` sets them all to 0. B, E and F
run as a few CUDA launches over time tiles (``geometry.TimeTilePlan``: segment partials,
a per-column combine, a final pass that smooths from shared memory) and
still count 1 a call; G as one (its resident route: whole columns in shared
memory) or three (its tiled route, for longer columns;
``geometry.fm_mask_plan``); ``cuda_launches`` holds how many CUDA launches
their last call made. The plain versions follow the
kernels' semantics, including finite zeros on silence (a zero noise floor
takes divisor 1).

Planes are time-major ``(rows, n_frames, n_bins)``, float32 on the card;
G's are frequency-major ``(..., n_bins, n_frames)``. In the bf16 mode
(``compute_dtype=torch.bfloat16``) A reads a bfloat16 signal and stores
bfloat16 re/im planes, B, E and F read them, and D reads them and stores a
bfloat16 output: each has a bfloat16 build beside its float32 one
(``csrc/planes.cuh``), whose arithmetic is the float32 build's on the
widened values, rounded where it stores. The masks, C and G stay float32.
A plain version takes bfloat16 the same way: in float32, rounded where
its kernel stores.

The wrappers are not differentiable (the kernels write into fresh tensors).
The gradient of every entry point that runs them comes from its staged
twin (``ops/precision.py::fused_with_twin``; the masks in
``ops/cuda_mask.py``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.config import Convention
from noisereduce_tpu_torch.ops import dsp
from noisereduce_tpu_torch.ops.cuda import build
from noisereduce_tpu_torch.ops.cuda.geometry import (
    SEG_B, SEG_E, SEG_F, GateGeometry, TimeTilePlan, cluster_shape, fft_n, fm_mask_plan,
    freq_smooth_plan, global_group, global_shape,
)
from noisereduce_tpu_torch.ops.stft import _analysis_window_np, istft, stft
from noisereduce_tpu_torch.parallel.chunking import chunk_views, extract_chunks, n_chunks_for

__all__ = [
    "spectra", "spectra_ref",
    "nonstationary_mask", "nonstationary_mask_ref",
    "freq_smooth_blend", "freq_smooth_blend_ref",
    "istft_ola", "istft_ola_ref",
    "stationary_mask", "stationary_mask_ref",
    "torch_nonstationary_mask", "torch_nonstationary_mask_ref",
    "fm_nonstationary_mask", "fm_nonstationary_mask_ref",
    "output_cast", "output_cast_ref", "CAST_DTYPES",
    "reset_launch_counts", "launch_counts", "route_counts", "dtype_counts", "device_counts",
]

_INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


# the plane types of kernels A, B, D, E and F (csrc/planes.cuh's codes): A's
# signal and planes, the re/im planes of B, E and F, D's planes and output;
# masks, thresholds and tables stay float32
_PLANE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda(name: str, *ts: torch.Tensor, planes: int = 0) -> int:
    """The kernels take contiguous CUDA tensors on one device, float32; the
    first ``planes`` of ``ts`` float32 or bfloat16, of one dtype. Returns
    the planes' code (``_PLANE_CODE``; 0 without planes)."""
    dev = ts[0].device
    pdt = ts[0].dtype if planes else torch.float32
    for i, t in enumerate(ts):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: expected tensors on one CUDA device, got "
                f"{[str(u.device) for u in ts]}"
            )
        want = pdt if i < planes else torch.float32
        if t.dtype != want or want not in _PLANE_CODE:
            kinds = "float32 or bfloat16 planes" if i < planes else "float32"
            raise TypeError(f"{name}: the kernel takes {kinds}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    return _PLANE_CODE[pdt]


def _mask_like(planes: torch.Tensor) -> torch.Tensor:
    """A float32 plane of ``planes``' shape and device: the masks, in any
    plane type."""
    return torch.empty(planes.shape, dtype=torch.float32, device=planes.device)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _ptr_or_null(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else _ptr(t)


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
def _twiddle_np(n_fft: int) -> np.ndarray:
    """(n_fft, 2) float64: tw[k] = e^{-2 pi i k / n_fft} as (re, im), with
    exact zeros at the quarter turns (the FFT route's twiddles)."""
    t = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    tab = np.stack([t.real, t.imag], axis=-1)
    tab[np.abs(tab) < 1e-12] = 0.0
    return tab


@functools.lru_cache(maxsize=None)
def _chirp_np(n: int) -> np.ndarray:
    """(n, 2) float64: the chirp-z route's cbar_j = e^{-i pi (j^2 mod 2n) /
    n}, j < n, as (re, im): the index exact in integer arithmetic (j^2 <
    2^26; a float phase of j^2 would lose its low bits), the phase in
    float64, rounded once to float32 on the device."""
    j = np.arange(n, dtype=np.int64)
    t = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    return np.stack([t.real, t.imag], axis=-1)


@functools.lru_cache(maxsize=None)
def _chirp_filter_np(key: tuple) -> np.ndarray:
    """(L, 2) float64 for key (n, L): the chirp-z route's filter spectrum
    FFT_L(h) / L, h_j = h_{L-j} = c_j = e^{i pi (j^2 mod 2n) / n} for j < n
    (zero between), taken in float64 once per (n, L). Kernel A multiplies
    by it, kernel D by its conjugate (h is symmetric, so FFT_L(conj h) is
    the conjugate of FFT_L(h))."""
    n, length = key
    j = np.arange(n, dtype=np.int64)
    c = np.exp(1j * np.pi * ((j * j) % (2 * n)) / n)
    h = np.zeros(length, np.complex128)
    h[:n] = c
    h[length - n + 1 :] = c[1:][::-1]
    f = np.fft.fft(h) / length
    return np.stack([f.real, f.imag], axis=-1)


@functools.lru_cache(maxsize=None)
def _cluster_chirp_filter_np(key: tuple) -> np.ndarray:
    """(L, 2) float64 for key (n, L): ``_chirp_filter_np`` in the order the
    cluster route's forward transform leaves it (``csrc/fft_cluster.cuh::
    cluster_convolve``): block q's point k1 of row r at (q n1 + k1) rows +
    r holds H[k], k = q rows + r + n2 k1, for the shape (c, n1, n2) of L
    (rows = n2 / c)."""
    c, n1, n2 = cluster_shape(key[1])
    rows = n2 // c
    q, k1, r = np.meshgrid(np.arange(c), np.arange(n1), np.arange(rows), indexing="ij")
    return _chirp_filter_np(key)[(q * rows + r + n2 * k1).ravel()]


@functools.lru_cache(maxsize=None)
def _global_chirp_filter_np(key: tuple) -> np.ndarray:
    """(row_blocks * L2 * rb, 2) float64 for key (n, L): ``_chirp_filter_np``
    in the order the global chirp route's row pass reads it
    (``csrc/fft_global.cuh::global_rows_kernel``): row block q's point k2
    of row r at (q L2 + k2) rb + r holds H[k1 + L1 k2], k1 = q rb + r, zero
    for k1 past L1, for the shape (L1, L2, tc, rb) of L."""
    L1, L2, _, rb = global_shape(key[1])
    q, k2, r = np.meshgrid(np.arange(-(-L1 // rb)), np.arange(L2), np.arange(rb), indexing="ij")
    k1 = (q * rb + r).ravel()
    out = _chirp_filter_np(key)[np.minimum(k1, L1 - 1) + L1 * k2.ravel()]
    out[k1 >= L1] = 0.0
    return out


@functools.lru_cache(maxsize=None)
def _global_twiddle_np(L: int) -> np.ndarray:
    """(L, 2) float64: the global chirp route's four-step twiddle w_L^{j2
    k1} at k1 L2 + j2 (``csrc/fft_global.cuh``: pass 1 multiplies row k1's
    point j2 by it, pass 3 by its conjugate), from ``_twiddle_np(L)`` at
    the exact product j2 k1 < L."""
    L1, L2, _, _ = global_shape(L)
    return _twiddle_np(L)[(np.arange(L1)[:, None] * np.arange(L2)[None, :]).ravel()]


@functools.lru_cache(maxsize=None)
def _scaled_window_np(scfg) -> np.ndarray:
    """(frame_length,) float64: the FFT route's analysis window w * s, s =
    1 / sum w for scipy and 1 for torch."""
    return _analysis_window_np(scfg) / _wsum(scfg)


@functools.lru_cache(maxsize=None)
def _post_window_np(scfg) -> np.ndarray:
    """(frame_length,) float64: the FFT and chirp routes' synthesis window
    w * sum w / n for scipy, w / n for torch, n = ``geometry.fft_n``
    (n_fft/2, or n_fft for an odd n_fft); 1/n undoes the unscaled n-point
    inverse FFT."""
    return _analysis_window_np(scfg) * _wsum(scfg) / fft_n(scfg.n_fft)


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
    "twiddle": _twiddle_np,  # key: the table's length
    "chirp": _chirp_np,  # key: n
    "chirp_filter": _chirp_filter_np,  # key: (n, L)
    "cluster_chirp_filter": _cluster_chirp_filter_np,  # key: (n, L)
    "global_chirp_filter": _global_chirp_filter_np,  # key: (n, L)
    "global_twiddle": _global_twiddle_np,  # key: L
    "scaled_window": _scaled_window_np,
    "post_window": _post_window_np,
    "window_squares": _window_squares_np,
    "envelope": _interior_envelope_np,
    "taps": lambda key: np.asarray(key, np.float64),  # key: the tap values
}


# the bytes the device-table cache keeps at most: a table past it is built
# for its call and dropped (the global chirp route's tables of a chirp
# length of a few million points), so a long-frame call pins no gigabytes
_CACHE_BYTES = 1 << 28
_cache: "collections.OrderedDict" = collections.OrderedDict()


def _device_f32(kind: str, key, device: torch.device) -> torch.Tensor:
    """A constant table as a float32 tensor on ``device``, built from its
    float64 host values (``_TABLES``). Kept while the cached tables stay
    within ``_CACHE_BYTES``, the least recently used dropped first."""
    at = (kind, key, device)
    if at in _cache:
        _cache.move_to_end(at)
        return _cache[at]
    t = torch.as_tensor(_TABLES[kind](key), dtype=torch.float32).to(device).contiguous()
    size = t.numel() * t.element_size()
    if size <= _CACHE_BYTES:
        _cache[at] = t
        while sum(v.numel() * v.element_size() for v in _cache.values()) > _CACHE_BYTES:
            _cache.popitem(last=False)
    return t


# ---------------------------------------------------------------------------
# A: spectra
# ---------------------------------------------------------------------------
def spectra_ref(x, geo: GateGeometry, chunk_size=0, padding=0, chunks=None, src_start=0):
    """Plain version of ``spectra``: extract the views, then the staged
    STFT; a bfloat16 signal in float32, the planes rounded once to
    bfloat16, as the kernel stores them."""
    (x32,) = dsp.to_mask_dtype(x)
    if src_start:
        views = chunk_views(x32, chunk_size, padding, *chunks, src_start)
    else:
        views = extract_chunks(x32, chunk_size, padding) if chunk_size else x32[:, None]
        if chunks is not None:
            views = views[:, chunks[0] : chunks[0] + chunks[1]]
    re, im = stft(views.reshape(-1, geo.view_len), geo.scfg)
    return re.to(x.dtype), im.to(x.dtype)


def spectra(x, geo: GateGeometry, chunk_size=0, padding=0, chunks=None, src_start=0):
    """Windowed frame spectra (``stft`` of the geometry's convention) of
    every view of every signal row.

    x: (rows, n_src). With ``chunk_size`` 0 each row is one view
    (``geo.view_len == n_src``); otherwise the views are the halo'd chunks
    of ``parallel.chunking.extract_chunks`` (chunk i: source samples
    [i*chunk_size - padding, (i+1)*chunk_size + padding), zero outside the
    signal), which the kernel reads straight from ``x``: all of them, or
    the ``count`` chunks from ``first`` of ``chunks`` = (first, count) (a
    group of chunks: the same views, from the same samples). ``src_start``
    (with ``chunks``): ``x`` holds the signal's samples from ``src_start``
    on, a device's slice of it under a mesh that reaches the signal's true
    ends wherever a view runs past it, so the zero fill is the same. Returns
    (re, im), each (rows*n_views, n_frames, n_bins), row h*n_views + i, in
    x's dtype: a bfloat16 signal is read as it is (the bf16 mode) and its
    planes rounded to bfloat16 on store, the FFT in float32.
    """
    if not chunk_size and geo.view_len != x.shape[-1]:
        raise ValueError(
            f"spectra: view_len {geo.view_len} != signal length {x.shape[-1]}"
        )
    if _on_cpu(x):
        return spectra_ref(x, geo, chunk_size, padding, chunks, src_start)
    return _spectra_on(geo.route, x, geo, chunk_size, padding, chunks, src_start)


def _chirp_tables(geo: GateGeometry, route: str, slot: int, device):
    """The chirp-z route's chirp and filter spectrum on ``device``, or two
    Nones on another route."""
    if route != "chirp":
        return None, None
    n = geo.fft_n
    return _device_f32("chirp", n, device), _device_f32("chirp_filter", (n, slot), device)


def _cluster_tables(geo: GateGeometry, route: str, device) -> tuple:
    """The cluster routes' tables on ``device``, as pointers: the stages'
    twiddles of the n1- and n2-point FFTs, e^{-2 pi i k / m} for the four
    steps' twiddle (m: n, or the chirp length L on the cluster chirp
    route), the split's of n_fft points, and on the cluster chirp route
    cbar_j and the filter spectrum in the four-step FFT's order
    (``_cluster_chirp_filter_np``)."""
    slot = geo.fft_layout(route)[0]
    _, n1, n2 = cluster_shape(slot)
    tabs = tuple(_ptr(_device_f32("twiddle", m, device))
                 for m in (2 * n1, 2 * n2, slot, geo.n_fft))
    if route != "cluster_chirp":
        return tabs
    return (*tabs, _ptr(_device_f32("chirp", geo.fft_n, device)),
            _ptr(_device_f32("cluster_chirp_filter", (geo.fft_n, slot), device)))


def _cluster_entry(name: str, geo: GateGeometry, route: str) -> tuple:
    """The C entry of ``name``'s build on a cluster route (the chirp's
    ``nr_<name>_chirp``, which also takes the chirp length) and the
    arguments it takes before its tables: () or (L,)."""
    if route == "cluster_chirp":
        return f"{name}_chirp", (geo.fft_layout(route)[0],)
    return name, ()


def _global_tables(geo: GateGeometry, device) -> tuple:
    """The global chirp route's tables on ``device``: the stages' twiddles
    of the L1- and L2-point FFTs, the four-step twiddle in the columns'
    layout (``_global_twiddle_np``), the split's of n_fft points, cbar_j
    and the filter spectrum in the row pass's order
    (``_global_chirp_filter_np``). The caller holds them until its launch
    is queued: past the device-table cache's bound (L of a few million) a
    table is not kept there."""
    L = geo.fft_layout("global_chirp")[0]
    L1, L2, _, _ = global_shape(L)
    return (_device_f32("twiddle", 2 * L1, device), _device_f32("twiddle", 2 * L2, device),
            _device_f32("global_twiddle", L, device), _device_f32("twiddle", geo.n_fft, device),
            _device_f32("chirp", geo.fft_n, device),
            _device_f32("global_chirp_filter", (geo.fft_n, L), device))


def _global_scratch(geo: GateGeometry, total: int, group, device) -> tuple:
    """(group, scratch) of the global chirp route over ``total`` slots:
    ``group`` slots a launch (``geometry.global_group`` by default) and
    their (group, L, 2) float32 scratch."""
    L = geo.fft_layout("global_chirp")[0]
    group = max(1, min(total, group or global_group(L, total)))
    return group, torch.empty((group, L, 2), dtype=torch.float32, device=device)


def cluster_capacity(geo: GateGeometry, kernel: str = "spectra", dtype=torch.float32,
                     device=None) -> int:
    """Clusters of ``kernel``'s build on the geometry's cluster route
    ("spectra", or "istft_ola": its transform pass) for its n_fft (and
    chirp length on the cluster chirp route) and planes of ``dtype`` that
    the card holds at once: the persistent grid of a launch, whose
    clusters walk the slots past it (``csrc/fft_cluster.cuh``)."""
    device = torch.device(device or "cuda")
    name, slot = _cluster_entry(
        {"spectra": "spectra_cluster", "istft_ola": "istft_cluster"}[kernel], geo, geo.route)
    with torch.cuda.device(device):
        n = getattr(build.load(), f"nr_{name}_capacity")(_PLANE_CODE[dtype], geo.n_fft, *slot)
    if n < 1:
        build.check(f"{name}_capacity", -n)
    return n


def cplx_capacity(geo: GateGeometry, dtype=torch.float32, device=None,
                  kernel: str = "spectra") -> int:
    """Blocks of ``kernel``'s complex-frame build ("spectra":
    ``csrc/spectra_cplx.cu``, or "istft_ola": ``csrc/istft_cplx.cu``) for
    the geometry (the FFT route's n_fft that the real-FFT kernels do not
    serve, and the chirp route) and planes of ``dtype`` that the card holds
    at once: the persistent grid of a launch, whose blocks walk A's tiles
    or D's runs past it."""
    device = torch.device(device or "cuda")
    slot, warps, tile = geo.fft_layout()
    name, args = (("spectra_cplx_capacity", (slot, tile, geo.hop, geo.win)) if kernel == "spectra"
                  else ("istft_cplx_capacity", (slot, warps, geo.n_bins, geo.hop, geo.r)))
    with torch.cuda.device(device):
        n = getattr(build.load(), f"nr_{name}")(_PLANE_CODE[dtype], geo.n_fft, *args)
    if n < 1:
        build.check(name, -n)
    return n


def real_capacity(geo: GateGeometry, kernel: str = "spectra", dtype=torch.float32,
                  device=None) -> int:
    """Blocks of ``kernel``'s real-FFT build ("spectra": ``csrc/spectra_fft.cu``,
    or "istft_ola": ``csrc/istft_fft.cu``) for the geometry and planes of
    ``dtype`` that the card holds at once: the persistent grid of a launch,
    whose blocks walk A's tiles or D's runs past it."""
    device = torch.device(device or "cuda")
    _, warps, tile = geo.fft_layout("fft")
    name, args = (("spectra_fft_capacity", (tile, geo.hop, geo.win)) if kernel == "spectra" else
                  ("istft_fft_capacity", (warps, geo.n_bins, geo.hop, geo.r)))
    with torch.cuda.device(device):
        n = getattr(build.load(), f"nr_{name}")(_PLANE_CODE[dtype], geo.n_fft, *args)
    if n < 1:
        build.check(name, -n)
    return n


def _spectra_on(route, x, geo: GateGeometry, chunk_size=0, padding=0, chunks=None,
                src_start=0, group=None):
    """Launch kernel A's ``route`` on a CUDA tensor, and count it; on the
    global chirp route ``group`` slots a launch of each pass (None: the
    geometry's ``global_group``)."""
    plane = _check_cuda("spectra", x, planes=1)
    rows, n_src = x.shape
    first, n_chunks = chunks or (0, n_chunks_for(n_src, chunk_size) if chunk_size else 1)
    B, T, nb = rows * n_chunks, geo.n_frames, geo.n_bins
    re = torch.empty((B, T, nb), dtype=x.dtype, device=x.device)
    im = torch.empty_like(re)
    views = (n_src, rows, n_chunks, chunk_size, first * chunk_size - padding - src_start,
             geo.view_len, T, geo.hop, geo.bpad, geo.win)
    dev = x.device
    if route == "global_chirp":
        slots = -(-T // 2) if geo.fft_paired else T
        _check_size("spectra", B * T, B * slots)
        group, scratch = _global_scratch(geo, B * slots, group, dev)
        tabs = _global_tables(geo, dev)
        _launch(
            "spectra_global", dev, plane, _ptr(x), *views, geo.n_fft, nb,
            geo.fft_layout(route)[0], group, _ptr(_device_f32("scaled_window", geo.scfg, dev)),
            *map(_ptr, tabs), _ptr(scratch), _ptr(re), _ptr(im),
        )
    elif route in ("cluster", "cluster_chirp"):
        slots = -(-T // 2) if geo.fft_paired else T
        _check_size("spectra", B * T, B * slots * geo.cluster[0])
        name, slot = _cluster_entry("spectra_cluster", geo, route)
        _launch(
            name, dev, plane, _ptr(x), *views, geo.n_fft, nb, *slot,
            _ptr(_device_f32("scaled_window", geo.scfg, dev)),
            *_cluster_tables(geo, route, dev), _ptr(re), _ptr(im),
        )
    elif route == "fft" and geo.fft_real:
        _, warps, tile = geo.fft_layout(route)
        _check_size("spectra", B * T, B * -(-T // tile))
        _launch(
            "spectra_fft", dev, plane, _ptr(x), *views, geo.n_fft, nb, warps, tile,
            _ptr(_device_f32("scaled_window", geo.scfg, dev)),
            _ptr(_device_f32("twiddle", geo.n_fft, dev)), _ptr(re), _ptr(im),
        )
    else:
        slot, warps, tile = geo.fft_layout(route)
        _check_size("spectra", B * T, B * -(-T // tile))
        chirp, filt = _chirp_tables(geo, route, slot, dev)
        _launch(
            "spectra_cplx", dev, plane, _ptr(x), *views, geo.n_fft, nb, slot, warps, tile,
            _ptr(_device_f32("scaled_window", geo.scfg, dev)),
            _ptr(_device_f32("twiddle", 2 * slot, dev)),
            _ptr(_device_f32("twiddle", geo.n_fft, dev)), _ptr_or_null(chirp),
            _ptr_or_null(filt), _ptr(re), _ptr(im),
        )
    _count(spectra, x.dtype, x.device, route)
    return re, im


# ---------------------------------------------------------------------------
# B: nonstationary_mask
# ---------------------------------------------------------------------------
def nonstationary_mask_ref(re, im, b, thresh, slope, taps):
    """Plain version of ``nonstationary_mask``."""
    re, im = dsp.to_mask_dtype(re, im)
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
    ``taps`` (numpy), zero outside the frames. re/im float32 or bfloat16
    (the bf16 mode: read as they are, the math in float32 and float64); the
    mask float32.
    """
    if _on_cpu(re, im):
        return nonstationary_mask_ref(re, im, b, thresh, slope, taps)
    plane = _check_cuda("nonstationary_mask", re, im, planes=2)
    rows, T, nb = re.shape
    plan = TimeTilePlan(rows, T, nb, len(taps), words=2, seg_len=SEG_B)
    _check_size("nonstationary_mask", rows * nb, plan.final_blocks, rows * T * nb // 256)
    p_f, p_b, k = _ewma_constants(float(b), plan.seg_len, T, plan.halo)
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), re.device)
    parts = torch.empty((4, rows, plan.n_segs, nb), dtype=torch.float64, device=re.device)
    raw = None if plan.fused else _mask_like(re)
    out = _mask_like(re)
    _launch(
        "nonstationary_mask", re.device, plane, _ptr(re), _ptr(im), _ptr(parts),
        _ptr_or_null(raw), _ptr(out), _ptr(tap_t), len(taps), rows, T, nb,
        plan.halo, p_f, p_b, (ctypes.c_double * len(k))(*k), thresh, slope,
        plan.smem_bytes,
    )
    _count(nonstationary_mask, re.dtype, re.device)
    nonstationary_mask.cuda_launches = 3 if plan.fused else 4
    return out


def _ewma_constants(b: float, seg_len: int, n_frames: int, halo: int) -> tuple:
    """Kernel B's host constants for segments of ``seg_len`` frames and a
    final-pass halo of ``halo`` frames: (p_f, p_b, k). p_f = (-halo-1) mod
    L is the offset in its segment of the frame before a halo's start, p_b
    = halo mod L that of the frame after a halo's end; k holds, in float64,
    a = 1 - b, b, a^(p_f+1), then for a full segment (n = L) and for the
    last one (n = n_frames - (S-1) L): a^n, R(0, n), R(p_b, n),
    a^(n - p_b), with R(p, n) = b a^(p+1) sum_{j < n-p} a^(2j), the w at
    offset p of a segment per unit of the y carried into it
    (csrc/nonstationary_mask.cu). Entries for an offset past the last
    segment's end are 0 (never read)."""
    a = 1.0 - b
    p_f, p_b = (-halo - 1) % seg_len, halo % seg_len
    n_segs = max(1, -(-n_frames // seg_len))
    n_last = max(1, n_frames - (n_segs - 1) * seg_len)

    def per(n):
        return (a**n, _ewma_r(b, 0, n), _ewma_r(b, p_b, n), a ** (n - p_b) if p_b < n else 0.0)

    return p_f, p_b, (a, b, a ** (p_f + 1), *per(seg_len), *per(n_last))


@functools.lru_cache(maxsize=4096)
def _ewma_r(b: float, p: int, n: int) -> float:
    """R(p, n) = b a^(p+1) sum_{j < n-p} a^(2j), a = 1 - b, in float64: the
    w at offset p of a stretch of n frames per unit of the y carried into it
    (0 for an offset past its end)."""
    a = 1.0 - b
    return b * a ** (p + 1) * math.fsum(a ** (2 * j) for j in range(n - p)) if p < n else 0.0


# ---------------------------------------------------------------------------
# C: freq_smooth_blend
# ---------------------------------------------------------------------------
def freq_smooth_blend_ref(mask, taps, prop):
    """Plain version of ``freq_smooth_blend``."""
    return dsp.conv_same(mask, taps, -1) * prop + (1.0 - prop)


def freq_smooth_blend(mask, taps, prop):
    """'same' correlation along bins with the odd ``taps`` (zero outside
    the bins), then the non-stationary blend m*prop + (1 - prop).

    On the card: one CUDA launch of spans of whole lines, or of pieces of
    a line too long for a block (``geometry.freq_smooth_plan``); every
    output sums its products in tap order, so the output does not depend
    on the span it lands in."""
    if _on_cpu(mask):
        return freq_smooth_blend_ref(mask, taps, prop)
    nb = mask.shape[-1]
    return _freq_smooth_on(freq_smooth_plan(max(1, mask.numel() // nb), nb, len(taps)),
                           mask, taps, prop)


def _freq_smooth_on(plan, mask, taps, prop):
    """Launch kernel C on a CUDA tensor with ``plan`` (a plan in pieces
    may be forced on a line that fits whole), and count it."""
    _check_cuda("freq_smooth_blend", mask)
    nb = mask.shape[-1]
    n_rows = mask.numel() // nb
    out = torch.empty_like(mask)
    if not n_rows:
        return out
    tap_t = _device_f32("taps", plan.device_taps(taps), mask.device)
    _launch(
        "freq_smooth_blend", mask.device, _ptr(mask), _ptr(out), _ptr(tap_t),
        plan.n_taps, plan.half, n_rows, nb, plan.lines, plan.piece, prop,
    )
    _count(freq_smooth_blend, torch.float32, mask.device)
    return out


# ---------------------------------------------------------------------------
# D: istft_ola
# ---------------------------------------------------------------------------
def istft_ola_ref(re, im, mask, geo: GateGeometry, out_off, out_len):
    """Plain version of ``istft_ola``: the staged iSTFT of the masked
    spectra, windowed and zero filled; bfloat16 planes in float32, the
    output rounded once to bfloat16, as the kernel stores it."""
    re32, im32 = dsp.to_mask_dtype(re, im)
    y = istft((re32 * mask, im32 * mask), geo.scfg)[..., out_off : out_off + out_len]
    return F.pad(y, (0, out_len - y.shape[-1])).to(re.dtype)


def istft_ola(re, im, mask, geo: GateGeometry, out_off, out_len):
    """Masked inverse STFT of each row in the geometry's convention,
    returning only trimmed samples [out_off, out_off + out_len) as
    (rows, out_len); samples past the istft length (scipy's, or torch's
    natural (T-1)*hop) are zero. re/im float32 or bfloat16 (the bf16 mode:
    the product, the inverse FFT, the overlap-add and the envelope in
    float32, the output rounded to bfloat16 on store), the mask float32;
    the output in the planes' dtype."""
    if _on_cpu(re, im, mask):
        return istft_ola_ref(re, im, mask, geo, out_off, out_len)
    return _istft_ola_on(geo.route, re, im, mask, geo, out_off, out_len)


def _istft_ola_on(route, re, im, mask, geo: GateGeometry, out_off, out_len, group=None):
    """Launch kernel D's ``route`` on CUDA tensors, and count it; on the
    global chirp route ``group`` slots a launch of each pass (None: the
    geometry's ``global_group``)."""
    plane = _check_cuda("istft_ola", re, im, mask, planes=2)
    rows, T, nb = re.shape
    j0, n_out = geo.out_blocks(out_off, out_len)
    out = torch.empty((rows, out_len), dtype=re.dtype, device=re.device)
    dev = re.device
    if route == "global_chirp":
        t_lo, n_fr = geo.cluster_frames(j0, n_out)
        slots = rows * -(-n_fr // (2 if geo.fft_paired else 1))
        _check_size("istft_ola", rows * T * nb, slots, rows * n_out * geo.hop)
        frames = torch.empty((rows, n_fr, geo.win), dtype=torch.float32, device=dev)
        group, scratch = _global_scratch(geo, slots, group, dev)
        tabs = _global_tables(geo, dev)
        _launch(
            "istft_global", dev, plane, _ptr(re), _ptr(im), _ptr(mask), rows, T, nb,
            geo.n_fft, geo.hop, geo.r, geo.bpad, j0, n_out, out_off, out_len,
            geo.istft_len, geo.env_floor, _ptr(_device_f32("post_window", geo.scfg, dev)),
            _ptr(_device_f32("window_squares", geo.scfg, dev)),
            _ptr(_device_f32("envelope", geo.scfg, dev)), geo.fft_layout(route)[0], group,
            *map(_ptr, tabs), _ptr(scratch), _ptr(frames), t_lo, n_fr, _ptr(out),
        )
    elif route in ("cluster", "cluster_chirp"):
        t_lo, n_fr = geo.cluster_frames(j0, n_out)
        _check_size("istft_ola", rows * T * nb, rows * n_fr, rows * n_out * geo.hop)
        frames = torch.empty((rows, n_fr, geo.win), dtype=torch.float32, device=dev)
        name, slot = _cluster_entry("istft_cluster", geo, route)
        _launch(
            name, dev, plane, _ptr(re), _ptr(im), _ptr(mask), rows, T, nb,
            geo.n_fft, geo.hop, geo.r, geo.bpad, j0, n_out, out_off, out_len,
            geo.istft_len, geo.env_floor, _ptr(_device_f32("post_window", geo.scfg, dev)),
            _ptr(_device_f32("window_squares", geo.scfg, dev)),
            _ptr(_device_f32("envelope", geo.scfg, dev)), *slot,
            *_cluster_tables(geo, route, dev), _ptr(frames), t_lo, n_fr, _ptr(out),
        )
    else:
        slot, warps, _ = geo.fft_layout(route)
        real = route == "fft" and geo.fft_real
        two_pass = not real and geo.cplx_two_pass
        run = geo.fft_run if real or two_pass else geo.cplx_run(
            rows, n_out, cplx_capacity(geo, re.dtype, dev, kernel="istft_ola"))
        _check_size("istft_ola", rows * T * nb, rows * -(-n_out // run))
        tail = (geo.hop, geo.r, geo.bpad, j0, n_out, run, out_off, out_len,
                geo.istft_len, geo.env_floor,
                _ptr(_device_f32("post_window", geo.scfg, dev)),
                _ptr(_device_f32("window_squares", geo.scfg, dev)),
                _ptr(_device_f32("envelope", geo.scfg, dev)))
        if real:
            _launch(
                "istft_fft", dev, plane, _ptr(re), _ptr(im), _ptr(mask), rows, T, nb,
                geo.n_fft, warps, *tail, _ptr(_device_f32("twiddle", geo.n_fft, dev)),
                _ptr(out),
            )
        else:
            chirp, filt = _chirp_tables(geo, route, slot, dev)
            t_lo, n_fr, frames = 0, 0, None
            if two_pass:  # a big block: each frame once into a scratch, then the overlap-add
                t_lo, n_fr = geo.cluster_frames(j0, n_out)
                _check_size("istft_ola", rows * n_fr, rows * n_out * geo.hop)
                frames = torch.empty((rows, n_fr, geo.win), dtype=torch.float32, device=dev)
            _launch(
                "istft_cplx", dev, plane, _ptr(re), _ptr(im), _ptr(mask), rows, T, nb,
                geo.n_fft, slot, warps, *tail,
                _ptr(_device_f32("twiddle", 2 * slot, dev)),
                _ptr(_device_f32("twiddle", geo.n_fft, dev)), _ptr_or_null(chirp),
                _ptr_or_null(filt), _ptr_or_null(frames), t_lo, n_fr, _ptr(out),
            )
    _count(istft_ola, re.dtype, re.device, route)
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
    re, im = dsp.to_mask_dtype(re, im)
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
    accumulated in float64 and compared in float64. re/im float32 or
    bfloat16 (the bf16 mode: read as they are, the math as for float32);
    thr and the mask float32.
    """
    if thr is None and n_std is None:
        raise ValueError("stationary_mask: self statistics need n_std")
    ts = (re, im) if thr is None else (re, im, thr)
    if _on_cpu(*ts):
        return stationary_mask_ref(re, im, thr, views_per_row, prop, taps, top_db, n_std)
    plane = _check_cuda("stationary_mask", *ts, planes=2)
    views, T, nb = re.shape
    _check_thr(thr, views, views_per_row, nb)
    plan = TimeTilePlan(views, T, nb, len(taps), words=1 if len(taps) > 1 else 0,
                          seg_len=SEG_E)
    _check_size("stationary_mask", views * nb, plan.final_blocks, views * T * nb // 256)
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), re.device)

    def work(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=re.device)

    maxima, mx = work(views, plan.n_segs, nb), work(views, nb)
    own = thr is None
    sums = work(2, views, plan.n_segs, nb, dtype=torch.float64) if own else None
    th = work(views, nb, dtype=torch.float64) if own else None
    raw = None if plan.fused else _mask_like(re)
    out = _mask_like(re)
    _launch(
        "stationary_mask", re.device, plane, _ptr(re), _ptr(im), _ptr_or_null(thr),
        nb if thr is not None and thr.ndim == 2 else 0, views_per_row,
        _ptr(maxima), _ptr(mx), _ptr_or_null(sums), _ptr_or_null(th),
        _ptr_or_null(raw), _ptr(out), _ptr(tap_t), len(taps), plan.halo, views,
        T, nb, prop, 1.0 - prop, dsp.EPS_F64, _DB_PER_NEPER, top_db,
        0.0 if n_std is None else n_std, plan.smem_bytes,
    )
    _count(stationary_mask, re.dtype, re.device)
    stationary_mask.cuda_launches = 3 + 2 * own + (not plan.fused)
    return out


# ---------------------------------------------------------------------------
# F: torch_nonstationary_mask
# ---------------------------------------------------------------------------
def torch_nonstationary_mask_ref(re, im, n_movemean, n_thresh, temp, prop, taps):
    """Plain version of ``torch_nonstationary_mask``."""
    re, im = dsp.to_mask_dtype(re, im)
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
    BEFORE a 'same' correlation along frames with the odd ``taps``. temp
    takes any value, read as the JAX package divides by it
    (``dsp.as_temperature``): 0 gives a step (NaN where the ratio is
    exactly n_thresh, as 0/0 there), inf gives 0.5.

    On the card: partials of |Z| per segment of ``SEG_F`` frames (a |Z|
    plane, float64 sums), a column scan into float64 prefixes, and a final
    pass over time tiles that slides each window on those prefixes (no cap
    on ``n_movemean``) and smooths from shared memory; 3 CUDA launches, 4
    for taps whose halo does not fit the tile. re/im float32 or bfloat16
    (the bf16 mode: read as they are, the math as for float32); the |Z|
    plane and the mask float32. The sigmoid's argument divides by a normal
    temp on the IEEE division's fast path, and by any other exactly, in a
    final pass of its own.
    """
    if int(n_movemean) < 1:
        raise ValueError(f"torch_nonstationary_mask: n_movemean must be at least 1, "
                         f"got {n_movemean}")
    if _on_cpu(re, im):
        return torch_nonstationary_mask_ref(re, im, n_movemean, n_thresh, temp, prop, taps)
    plane = _check_cuda("torch_nonstationary_mask", re, im, planes=2)
    views, T, nb = re.shape
    plan = TimeTilePlan(views, T, nb, len(taps), words=1 if len(taps) > 1 else 0,
                        seg_len=SEG_F)
    _check_size("torch_nonstationary_mask", views * nb, plan.final_blocks,
                views * T * nb // 256)
    tap_t = _device_f32("taps", tuple(float(v) for v in taps), re.device)

    def work(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=re.device)

    # temp as the kernel takes it: rounded to float32, a subnormal one
    # flushed to a zero of its sign as the JAX package divides by it; one
    # that is then not a normal float takes the exact division
    temp = torch.tensor(dsp.as_temperature(temp, torch.float32), dtype=torch.float32).item()
    exact = not (math.isfinite(temp) and temp != 0.0)
    mag = _mask_like(re)
    pre = work(views, plan.n_segs + 1, nb, dtype=torch.float64)
    offs = work(4, views, plan.n_segs, nb, dtype=torch.float64)
    raw = None if plan.fused else _mask_like(re)
    out = _mask_like(re)
    _launch(
        "torch_nonstationary_mask", re.device, plane, _ptr(re), _ptr(im), _ptr(mag),
        _ptr(pre), _ptr(offs), _ptr_or_null(raw), _ptr(out), _ptr(tap_t),
        len(taps), plan.halo, views, T, nb, int(n_movemean),
        *_movemean_offsets(int(n_movemean), plan.seg_len, plan.halo),
        n_thresh, temp, int(exact), prop, 1.0 - prop, plan.smem_bytes,
    )
    _count(torch_nonstationary_mask, re.dtype, re.device)
    torch_nonstationary_mask.cuda_launches = 3 if plan.fused else 4
    return out


def _movemean_offsets(n_movemean: int, seg_len: int, halo: int) -> tuple:
    """Kernel F's window-start offsets in a segment of ``seg_len`` frames,
    for a final-pass halo of ``halo`` frames: where the prefixes P[t +
    right + 1] and P[t - left] of a window at frame t land, (right + 1)
    mod L and (-left) mod L for a thread that starts at its segment, the
    same less ``halo`` for the first warp of a block, which starts ``halo``
    frames earlier (csrc/torch_nonstationary_mask.cu). left = (n - 1) // 2,
    right = n - 1 - left."""
    left = (n_movemean - 1) // 2
    right = n_movemean - 1 - left
    return ((right + 1) % seg_len, -left % seg_len, (right + 1 - halo) % seg_len,
            (-left - halo) % seg_len)


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

    On the card (``geometry.fm_mask_plan``): the resident route, one CUDA
    launch, while a column's two planes fit a block's shared memory (29,020
    frames); the tiled route, three, past that. ``cuda_launches`` holds the
    last call's CUDA launches, ``resident_launches`` / ``tiled_launches``
    count the calls by route.
    """
    if _on_cpu(z):
        return fm_nonstationary_mask_ref(z, b, thresh, slope)
    return _fm_mask_on(None, z, b, thresh, slope)


def _fm_mask_on(route, z, b, thresh, slope):
    """Launch kernel G on a CUDA tensor on ``route`` (None: the plan's)
    and count it."""
    is_complex = z.is_complex()
    if is_complex and z.dtype != torch.complex64:
        raise TypeError(f"fm_nonstationary_mask: the kernel takes complex64, got {z.dtype}")
    zr = torch.view_as_real(z) if is_complex else z
    _check_cuda("fm_nonstationary_mask", zr)
    T = z.shape[-1]
    n_cols = z.numel() // T if T else 0
    out = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    if not n_cols:
        return out
    plan = fm_mask_plan(n_cols, T, route)
    _check_size("fm_nonstationary_mask", plan.blocks, T)
    tiled = plan.route == "tiled"
    parts = (torch.empty((2, plan.n_tiles, n_cols), dtype=torch.float64, device=z.device)
             if tiled else None)
    k = _fm_constants(float(b), plan.lane_len, plan.short_lane, plan.tile_len, plan.last_tile)
    _launch(
        "fm_nonstationary_mask", z.device, _ptr(zr), int(is_complex), _ptr_or_null(parts),
        _ptr(out), n_cols, T, plan.cols, plan.lane_len, plan.tile_len, plan.n_tiles,
        (ctypes.c_double * len(k))(*k), thresh, slope, plan.smem_bytes,
    )
    _count(fm_nonstationary_mask, torch.float32, z.device, plan.route)
    fm_nonstationary_mask.cuda_launches = 3 if tiled else 1
    return out


@functools.lru_cache(maxsize=256)
def _fm_constants(b: float, lane_len: int, short: int, tile_len: int, last_tile: int) -> tuple:
    """Kernel G's host constants (csrc/fm_nonstationary_mask.cu, struct
    Consts), float64: a = 1 - b, b; a^n and R(0, n) of a full region
    (``lane_len`` frames) and of the ``short`` one that ends the column or
    its last tile; a^n and R(0, n) of a full tile and of the last tile (the
    tiled route's; the resident route reads none)."""
    a = 1.0 - b
    return (a, b, a**lane_len, _ewma_r(b, 0, lane_len), a**short, _ewma_r(b, 0, short),
            a**tile_len, _ewma_r(b, 0, tile_len), a**last_tile, _ewma_r(b, 0, last_tile))


# ---------------------------------------------------------------------------
# H: output_cast
# ---------------------------------------------------------------------------
# the caller dtypes kernel H writes, by their codes in csrc/output_cast.cu
_CAST_CODE = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.uint16: 3, torch.int32: 4,
              torch.float16: 5}
CAST_DTYPES = tuple(_CAST_CODE)


def _low_bits(i: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The low 8 or 16 bits of int32 ``i`` as ``dtype`` (a signed or
    unsigned integer of that width, or float16's bits): the wrap written
    out, so that no cast in between may saturate."""
    bits = 8 * dtype.itemsize
    half = 1 << (bits - 1)
    signed = {1: torch.int8, 2: torch.int16}[dtype.itemsize]
    return (((i & ((1 << bits) - 1)) ^ half) - half).to(signed).view(dtype)


def output_cast_ref(cores: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``output_cast``: numpy's cast of the float32 output
    on x86 (``noisereduce_tpu/api.py:630``; bfloat16 cores widened first).
    An integer: NaN and anything outside [-2^31, 2^31) give INT32_MIN, the
    rest truncates toward zero, and int8, uint8, int16 and uint16 keep that
    int32's low bits. float16: round to nearest even and overflow to +-inf,
    a NaN kept as numpy keeps it (its sign, 0x7C00 | its top 10 payload
    bits, at least one of them set)."""
    x = cores.float()
    if dtype == torch.float16:
        f = x.view(torch.int32)
        nan = 0x7C00 | ((f & 0x7FFFFF) >> 13)
        nan = (nan + (nan == 0x7C00).int()) | ((f >> 16) & 0x8000)
        bits = torch.where(torch.isnan(x), _low_bits(nan, torch.int16),
                           x.to(torch.float16).view(torch.int16))
        return bits.view(torch.float16)
    ok = (x >= -(2.0**31)) & (x < 2.0**31)
    i = torch.where(ok, x, torch.zeros_like(x)).to(torch.int32)
    i = torch.where(ok, i, torch.full_like(i, -(2**31)))
    return i if dtype == torch.int32 else _low_bits(i, dtype)


def output_cast(cores: torch.Tensor, dtype: torch.dtype, out=None) -> torch.Tensor:
    """Kernel H: (..., w) float32 or bfloat16 cores, each row's elements
    adjacent and the rows at any stride, in an integer or float16 caller's
    ``dtype`` (``CAST_DTYPES``), numpy's cast (``output_cast_ref``); into
    ``out`` ((..., w) in ``dtype`` on the cores' device, rows of adjacent
    elements) where given, else into a new contiguous tensor. On the CPU the
    plain version."""
    if dtype not in _CAST_CODE:
        raise TypeError(f"output_cast: no kernel writes {dtype}; it writes {CAST_DTYPES}")
    shape = cores.shape
    if _on_cpu(cores):
        got = output_cast_ref(cores, dtype)
        return got if out is None else out.copy_(got)
    if cores.dtype not in _PLANE_CODE:
        raise TypeError(f"output_cast: the kernel reads float32 or bfloat16, got {cores.dtype}")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=cores.device)
    if out.dtype != dtype or out.shape != shape or out.device != cores.device:
        raise ValueError(f"output_cast: out must be {tuple(shape)} {dtype} on {cores.device}")
    w = shape[-1]
    x = cores.reshape(-1, w) if cores.ndim != 2 else cores
    o = out.view(-1, w) if out.ndim != 2 else out
    if w > 1 and (x.stride(1) != 1 or o.stride(1) != 1):
        raise ValueError("output_cast: each row's elements must be adjacent")
    if not x.numel():
        return out
    _launch("output_cast", cores.device, _PLANE_CODE[cores.dtype], _ptr(x), x.stride(0),
            _CAST_CODE[dtype], _ptr(o), o.stride(0), x.shape[0], w)
    _count(output_cast, cores.dtype, cores.device)
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
KERNELS = (spectra, nonstationary_mask, freq_smooth_blend, istft_ola,
           stationary_mask, torch_nonstationary_mask, fm_nonstationary_mask, output_cast)
ROUTED = (spectra, istft_ola)  # the kernels with routes
ROUTES = ("fft", "chirp", "cluster", "cluster_chirp", "global_chirp")
FM_ROUTES = ("resident", "tiled")  # kernel G's routes


DTYPES = ("float32", "bfloat16")  # the plane types (``_PLANE_CODE``)


def _count(fn, dtype: torch.dtype, device: torch.device, route: str = None) -> None:
    """Count one launch of ``fn``'s kernel: in ``launches``, by its planes'
    dtype in ``dtype_launches``, by device in ``device_launches`` and, for a
    kernel with routes, by route."""
    fn.launches += 1
    fn.dtype_launches[str(dtype).removeprefix("torch.")] += 1
    fn.device_launches[str(device)] = fn.device_launches.get(str(device), 0) + 1
    if route is not None:
        setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.dtype_launches = dict.fromkeys(DTYPES, 0)
        fn.device_launches = {}
    for fn in ROUTED:
        for route in ROUTES:
            setattr(fn, f"{route}_launches", 0)
    for route in FM_ROUTES:
        setattr(fm_nonstationary_mask, f"{route}_launches", 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def route_counts() -> dict:
    """Launches of kernels A and D by route, e.g. {"spectra": {"fft": 1,
    "chirp": 0, "cluster": 0, "cluster_chirp": 0, "global_chirp": 0},
    "istft_ola": {...}}."""
    return {fn.__name__: {route: getattr(fn, f"{route}_launches") for route in ROUTES}
            for fn in ROUTED}


def dtype_counts() -> dict:
    """Launches of every kernel by the dtype of its planes, e.g.
    {"spectra": {"float32": 0, "bfloat16": 1}, ...}: a bf16 call launches
    the bfloat16 variants of A, B, D, E and F (C and G take float32 only),
    and H by the dtype of the cores it reads."""
    return {fn.__name__: dict(fn.dtype_launches) for fn in KERNELS}


def device_counts() -> dict:
    """Launches of every kernel by device, e.g. {"spectra": {"cuda:0": 4},
    ...}: a mesh of (cuda:0,) * 4 launches each kernel of its path once a
    shard on cuda:0."""
    return {fn.__name__: dict(fn.device_launches) for fn in KERNELS}


reset_launch_counts()
nonstationary_mask.cuda_launches = stationary_mask.cuda_launches = 0
torch_nonstationary_mask.cuda_launches = fm_nonstationary_mask.cuda_launches = 0
