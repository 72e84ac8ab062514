#!/usr/bin/env python3
"""Time kernels A ``spectra`` and D ``istft_ola`` on one CUDA card at the
headline shapes (960 s of 48 kHz audio, n_fft 1024 / hop 256), at
n_fft 1536 / hop 384 (the first 60 s, and all 960 s), n_fft 400 / hop 100
(960 s), n_fft 1100 / hop 275 (60 s and 960 s: radix 11), and at 44.1 kHz
n_fft 1323 / hop 441 and 441 / hop 147 (60 s: odd, two frames a
transform), n_fft 1102 / hop 551 (60 s: the large radices 19 and 29;
the chirp-z route before them) and 1101 / hop 367 (60 s: the chirp-z
route, 3 x 367), chunked as ``reduce_noise`` chunks
(600000 / 30000); frames below 64 samples at 8 kHz, 60 s (the DFT
products before them): n_fft 40 / hop 10 and 2 / 1, 16 / 4 (the
real-FFT kernels, 204, 4,096 and 512 frames a tile), odd 3 / 1 and 63 /
21, 34 / 17 and 62 / 31 (radix 17 and 31: the complex-frame kernels) and
odd 37 / 1 (the chirp-z route, L = 81); the long frames, only when ``--cells`` names them, each
one unchunked view: n_fft 16384 / hop 4096 on 60 s (704 frames; the
cluster route on 2 blocks, the big block before it), 16380 / hop 4095
(the cluster route on 3 blocks, the big block's largest slot before it)
and n_fft 40000 / hop 10000 on 400,000
samples, with
kernel C's plan for the line (and its time where it has one), the device
time also by ``queued_ms``; and A alone on the 10 s noise
row of ``chip_smoke.py`` (n_fft 1024, unchunked: the stationary paths'
threshold spectra, TPU row 3). The cluster route also at n_fft 32768 /
hop 8192 (two blocks) and 19683 / hop 6561 at 44.1 kHz (odd, three
blocks), each one view of 400,000 samples, and n_fft 40000 / hop 10000
over all 960 s chunked as ``reduce_noise`` chunks (77 views; the
throughput case, named ``40000@960``). The cluster chirp route (the DFT
products before it): n_fft 4803 / hop 1601 (3 x 1601, odd) on 60 s
and on all 960 s chunked (``4803``, ``4803@960``) and 16386 / hop 2731
(n = 3 x 2731) on 60 s, each also with the 2^a 3^b family's chirp
length (``*_23_ms``, ``slot_23``) beside the route's own 2^a 3^b 5^c.
The global chirp route (the DFT products before it): n_fft 40005 / hop
8001 (odd, L = 81,000) on one view of 400,000 samples and on all 960 s
chunked (``40005``, ``40005@960``), 65538 / hop 21846 and 192000 / hop
48000 on 60 s chunked, each also with one launch of each pass over every
slot (the geometry's ``group`` at these cells) beside groups whose
scratch stays in the card's L2 (``l2_group``, ``*_l2_group_*``, and that
run's peak memory); a call that runs out of device memory (a tree whose
route there builds n_fft x n_fft tables) is recorded in ``*_error``.
The big block's builds: n_fft 8580 / hop 2145 (n = 4290, every odd
radix, no cluster shape) and 4106 / hop 2053 (chirp length 8192), each
one view of 60 s; 12000 / hop 3000 (n = 6000: the cluster route on 2
blocks, the big block before it). A cell of the complex-frame kernels
prints kernel A's persistent grid (``grid``: the blocks the card holds,
in a tree whose blocks walk the tiles), and every unchunked
long cell A's and D's largest deviation from their plain versions
(``*_max_dev``, x max|plain|), so that a copy of the package with
another route (``tools/fft_route_variants.py``) is held where it is
timed.
Every cell prints A's and D's bytes bound: the signal read once and
the planes written once (A), the planes and the mask read once and the
output written once (D), over the card's 3.35 TB/s; every long cell also
the host wall of each one's first call (tables included) and the peak
device memory over both (also over the inputs). Two times per kernel: CUDA
events around one call, the minimum of ``--reps`` runs after a warm-up (the
host's launch work included, as ``chip_smoke.py`` times), and the device
time of the kernel alone, the mean over ``--reps`` calls in a
``torch.profiler`` trace; and the host's time to issue one call (the
mean over ``--reps`` calls issued back to back without a synchronise),
which the events time includes where it exceeds the card's. A chirp-route
cell is timed twice, with the chirp length 2^a 3^b (the route's own) and a
power of two (``geometry.chirp_length`` replaced for the run). With ``--library``, ``torch.stft`` /
``torch.istft`` at the same shapes are timed the same three ways. Prints the card's name and power limit, then
one JSON line: per cell, A's and D's times and the route each launch
took.

    python3 tools/fft_route_timing.py [--reps 10] [--cells 1024,1536] [--library]
    python3 tools/fft_route_timing.py --cells 40,2,16,3,63,34,62,37 --library  # small frames
    python3 tools/fft_route_timing.py --cells 16384,40000 --library   # the long frames
    python3 tools/fft_route_timing.py --cells 40000,40000@960,32768,19683 --library  # cluster route
    python3 tools/fft_route_timing.py --cells 4803,4803@960,16386 --library  # cluster chirp route
    python3 tools/fft_route_timing.py --cells 40005,40005@960,65538,192000 --library  # global chirp
    PYTHONPATH=<parent checkout> python3 tools/fft_route_timing.py --cells 40 --library
    python3 tools/fft_route_timing.py --ab [NAME=]<checkout>[,...] --rounds 4 --cells 1024,1536
    python3 tools/fft_route_timing.py --ab <checkout> --cells 1024 --dtype bfloat16
    python3 tools/fft_route_timing.py --ab <checkout> --cells 1024 --variants run32,diag_a_no_fft

``--ab`` times kernels A and D of this tree, of other checkouts (a
parent commit unpacked with ``git archive``; the sources of
``--ab-kernels`` built with this tree's flags into ``$TMPDIR``, beside
this tree's own build, their ``ptxas -v`` reports printed; D with the run
length of the checkout's own ``geometry.py``) and of the ``--variants``
(``AB_VARIANTS``: this tree's library with the parent's run length, or its
sources with a piece of the work taken out or another design choice) in
one process: every call goes through this tree's wrapper, whose library
is swapped for each build's entries in turn (``AB_KERNELS``: ``real``,
the real-FFT kernels ``csrc/spectra_fft.cu`` and ``csrc/istft_fft.cu``;
``global``, the global chirp route's ``csrc/spectra_global.cu`` and
``csrc/istft_global.cu`` over ``csrc/fft_global.cuh``; ``cplx``, the
complex-frame kernels ``csrc/spectra_cplx.cu`` and ``csrc/istft_cplx.cu``),
in ``--rounds`` rounds of alternating order (this tree first, then the
others, then the reverse),
on the ``CELLS`` and ``LONG_CELLS`` that ``--cells`` names, with the
signal in ``--dtype``. Per cell, build and kernel: the device time of
each round (``queued_ms``: events around one call with the host's launch
work hidden, min of ``--reps``), their min, median and max, and whether
each build's outputs are bitwise this tree's (else their largest
difference); on the global chirp route also each launch's device ms
(``*_split``: a ``torch.profiler`` trace) and the same times with groups
whose scratch stays in L2 (``*_l2``); with ``--library`` also
``torch.stft`` / ``torch.istft`` and one elementwise pass over two planes
(the card's rate on these bytes).

    python3 tools/fft_route_timing.py --ab parent=<checkout> --ab-kernels global,cplx \
        --cells 40005,40005@960,65538,192000,1100,1323,1102,1101,8580,4106,37 --library \
        --variants cplx_fixed_run,run32

It times the ``noisereduce_tpu_torch`` that Python imports first. To time
another checkout of the package beside this one (a parent commit unpacked
with ``git archive`` into an ignored directory), put that checkout first
on ``PYTHONPATH``; run the two in turns (A, B, B, A) on one card. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import importlib.util
import json
import os
import pathlib
import re as regex
import statistics
import sys
import tempfile
import time
from unittest import mock

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # this tree's package, after PYTHONPATH's

CELLS = (  # name, n_fft, hop, seconds (or samples), sample rate
    ("headline n_fft 1024, 960 s", 1024, 256, 960, 48000),
    ("n_fft 1536, 60 s", 1536, 384, 60, 48000),
    ("n_fft 1536, 960 s", 1536, 384, 960, 48000),
    ("n_fft 400, 960 s", 400, 100, 960, 48000),
    ("n_fft 1100, 60 s", 1100, 275, 60, 48000),
    ("n_fft 1100, 960 s", 1100, 275, 960, 48000),
    ("n_fft 1323, 44.1 kHz, 60 s", 1323, 441, 60, 44100),
    ("n_fft 441, 44.1 kHz, 60 s", 441, 147, 60, 44100),
    ("n_fft 1102, 44.1 kHz, 60 s", 1102, 551, 60, 44100),
    ("n_fft 1101, 44.1 kHz, 60 s", 1101, 367, 60, 44100),
    # the large radices beside radix 13: n = 221 = 13 x 17
    ("n_fft 442, 44.1 kHz, 60 s", 442, 221, 60, 44100),
    # frames below 64 samples at 8 kHz (the DFT products before them): the
    # real-FFT kernels at M = 20, 1 and 8; odd 3 and 63 = 3^2 7, M = 17 and
    # 31 (stage_large) on the complex-frame kernels; the chirp at odd 37
    ("n_fft 40, 8 kHz, 60 s", 40, 10, 60, 8000),
    ("n_fft 2, 8 kHz, 60 s", 2, 1, 60, 8000),
    ("n_fft 16, 8 kHz, 60 s", 16, 4, 60, 8000),
    ("n_fft 3, 8 kHz, 60 s", 3, 1, 60, 8000),
    ("n_fft 63, 8 kHz, 60 s", 63, 21, 60, 8000),
    ("n_fft 34, 8 kHz, 60 s", 34, 17, 60, 8000),
    ("n_fft 62, 8 kHz, 60 s", 62, 31, 60, 8000),
    ("n_fft 37, 8 kHz, 60 s", 37, 1, 60, 8000),
)
# timed only when --cells names them by key: key, name, n_fft, hop,
# samples, sample rate, chunked (as reduce_noise chunks: CHUNK / PADDING)
# or one unchunked view
LONG_CELLS = (
    ("16384", "n_fft 16384, 60 s, one view", 16384, 4096, 60 * 48000, 48000, False),
    ("16380", "n_fft 16380, 60 s, one view", 16380, 4095, 60 * 48000, 48000, False),
    # n = 6000 = 2^4 3 5^3: the cluster route on 2 blocks (the big block
    # before it); the big block's builds: n = 4290 = 2 3 5 11 13 (all odd
    # radices, no cluster shape) and the chirp length 8192 (4106: n = 2053,
    # prime)
    ("12000", "n_fft 12000, 60 s, one view", 12000, 3000, 60 * 48000, 48000, False),
    ("8580", "n_fft 8580, 60 s, one view", 8580, 2145, 60 * 48000, 48000, False),
    ("4106", "n_fft 4106, 60 s, one view", 4106, 2053, 60 * 48000, 48000, False),
    ("40000", "n_fft 40000, 400,000 samples, one view", 40000, 10000, 400000, 48000, False),
    ("40000@960", "n_fft 40000, 960 s, 77 views", 40000, 10000, 960 * 48000, 48000, True),
    ("32768", "n_fft 32768, 400,000 samples, one view", 32768, 8192, 400000, 48000, False),
    ("19683", "n_fft 19683, 44.1 kHz, 400,000 samples, one view", 19683, 6561, 400000,
     44100, False),
    # the chirp on the cluster route: odd 4803 = 3 x 1601 (L = 9720, 2
    # blocks) and even 16386 = 2 x 3 x 2731 (n = 8193, L = 16875, 3
    # blocks), each hop one that divides the frame
    ("4803", "n_fft 4803, 60 s, one view", 4803, 1601, 60 * 48000, 48000, False),
    ("4803@960", "n_fft 4803, 960 s, 77 views", 4803, 1601, 960 * 48000, 48000, True),
    ("16386", "n_fft 16386, 60 s, one view", 16386, 2731, 60 * 48000, 48000, False),
    # the global chirp route (the DFT products before it): odd 40005 = 3^2
    # 5 7 127 (L = 81,000 = 270 x 300) on one view and on all 960 s; even
    # 65538 (n = 32,769, L = 65,610) and 192000 (n = 96,000, L = 192,000 =
    # 400 x 480) on 60 s in reduce_noise's 5 views
    ("40005", "n_fft 40005, 400,000 samples, one view", 40005, 8001, 400000, 48000, False),
    ("40005@960", "n_fft 40005, 960 s, 77 views", 40005, 8001, 960 * 48000, 48000, True),
    ("65538", "n_fft 65538, 60 s, 5 views", 65538, 21846, 60 * 48000, 48000, True),
    ("192000", "n_fft 192000, 60 s, 5 views", 192000, 48000, 60 * 48000, 48000, True),
)
# the global chirp route's groups within the card's 50 MB L2: slots whose
# scratch (8 L bytes each) fits this, timed beside the geometry's group
L2_SCRATCH_BYTES = 32 << 20
# the chirp length families of the cluster route: the route's own
# (geometry.chirp_length) and the smallest 2^a 3^b with a cluster shape
CHIRP_FAMILY_23 = (2, 3)


def pow2_length(n: int) -> int:
    """The least power of two >= 2n - 1, or 8192 past a block of 4096
    points: a chirp length the kernels take beside the route's own."""
    return 8192 if 2 * n - 1 > 4096 else 1 << (2 * n - 2).bit_length()


def family_length(radices):
    """The chirp length of ``radices``' family past a big block: the
    smallest L >= 2n - 1 with no other prime factor and a cluster shape
    (the route's own length within a block)."""
    from noisereduce_tpu_torch.ops.cuda import geometry as G
    own = G.chirp_length

    def length(n: int) -> int:
        if 2 * n - 1 <= G.FFT_BIG_ELEMS:
            return own(n)
        return next(L for L in range(2 * n - 1, G.CLUSTER_MAX * G.FFT_BIG_ELEMS + 1)
                    if G._strip(L, radices) == 1 and G.cluster_shape(L))
    return length


@contextlib.contextmanager
def chirp_lengths(length):
    """``geometry.chirp_length`` replaced by ``length`` inside the block,
    the layout cache cleared on the way in and out."""
    from noisereduce_tpu_torch.ops.cuda import geometry as G
    own = G.chirp_length
    G.chirp_length = length
    G._layout.cache_clear()
    try:
        yield
    finally:
        G.chirp_length = own
        G._layout.cache_clear()


def walk_grid(K, g):
    """The persistent grid of kernel A's complex-frame builds at this
    geometry (``kernels.cplx_capacity``), in a tree whose blocks walk the
    tiles; else None."""
    if not hasattr(K, "cplx_capacity") or g.route not in ("fft", "chirp") or g.fft_real:
        return None
    return K.cplx_capacity(g)


def long_cell(cs, K, times, signals, n_fft, hop, n, sr, chunked, args) -> dict:
    """A and D on ``n`` samples of the headline signal at ``sr``, one
    unchunked view or (``chunked``) the views of ``reduce_noise``'s chunks
    (its own route, the device time also by ``queued_ms``; ``torch.stft`` /
    ``torch.istft`` with ``--library``, on the same views), their bytes
    bounds, and kernel C's plan for its line at the default 500 Hz of
    frequency smoothing (timed where there is one)."""
    from noisereduce_tpu_torch.config import GateConfig, StftConfig
    from noisereduce_tpu_torch.ops.cuda import geometry as G
    from noisereduce_tpu_torch.ops.dsp import tri_norm
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    if sr not in signals or signals[sr].shape[-1] < n:
        signals[sr] = torch.as_tensor(cs.headline_signal(-(-n // sr), sr)).cuda()
    xs = signals[sr][None, :n].contiguous()
    scfg = StftConfig(n_fft=n_fft, hop_length=hop)
    cut = (cs.CHUNK, cs.PADDING) if chunked else (0, 0)
    g = G.gate_geometry(scfg, cut[0] + 2 * cut[1] if chunked else n)
    win = (cut[1], cut[0]) if chunked else (0, n)  # D's trimmed output window
    cell = dict(route=g.route, frames=g.n_frames, bins=g.n_bins)
    # 500 ms of time smoothing, or 2 s past a hop of 500 ms (at least a hop)
    taps = tri_norm(GateConfig(sr=sr, n_fft=n_fft, hop_length=hop,
                               time_mask_smooth_ms=500 if 2 * hop <= sr else 2000
                               ).smoothing[0])
    try:
        plan = G.freq_smooth_plan(g.n_frames, g.n_bins, len(taps))
        cell["c_plan"] = {k: v for k, v in vars(plan).items()}
    except ValueError as e:
        cell["c_plan"] = f"raises ValueError: {e}"
    print(f"{n_fft}: route {g.route}, {g.n_frames} frames, kernel C plan {cell['c_plan']}",
          flush=True)
    K.reset_launch_counts()
    a = (xs, g, *cut)
    # the first call of each (host wall, tables and builds of the call
    # included) and the peak device memory over both; a call that runs out
    # of device memory (a tree whose route builds n_fft x n_fft tables, past
    # about n_fft 146,000) is recorded, D then tried on zero planes of the
    # same shape
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        re, im = K.spectra(*a)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        cell["spectra_error"] = str(e).splitlines()[0]
        re = torch.zeros((xs.shape[0] * (-(-n // cut[0]) if chunked else 1), g.n_frames,
                          g.n_bins), device=xs.device)
        im = torch.zeros_like(re)
    cell["spectra_first_call_s"] = time.perf_counter() - t0
    mask = torch.rand(re.shape, generator=torch.Generator("cuda").manual_seed(0),
                      device=re.device)
    d = (re, im, mask, g, *win)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        K.istft_ola(*d)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        cell["istft_ola_error"] = str(e).splitlines()[0]
    cell["istft_ola_first_call_s"] = time.perf_counter() - t0
    if "spectra_error" in cell or "istft_ola_error" in cell:
        cell["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        print(f"{n_fft}{' chunked' if chunked else ''}: {json.dumps(cell)}", flush=True)
        del re, im, mask, d
        return cell
    cell["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    cell["peak_over_inputs_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    cell["views"] = re.shape[0]
    cell["routes"] = {k: max(v, key=v.get) for k, v in K.route_counts().items()}
    if walk_grid(K, g):
        cell["grid"] = walk_grid(K, g)
    if not chunked:  # A's and D's deviation from their plain versions
        rre, rim = K.spectra_ref(*a)
        scale = max(float(rre.abs().max()), float(rim.abs().max()))
        cell["spectra_max_dev"] = max(float((re - rre).abs().max()),
                                      float((im - rim).abs().max())) / scale
        y, ry = K.istft_ola(*d), K.istft_ola_ref(*d)
        cell["istft_ola_max_dev"] = float((y - ry).abs().max()) / float(ry.abs().max())
        del rre, rim, y, ry
    planes = re.numel() * re.element_size()
    cell["spectra_bound_ms"] = (n * xs.element_size() + 2 * planes) / cs.HBM_BYTES_PER_S * 1e3
    cell["istft_ola_bound_ms"] = (2 * planes + mask.numel() * 4
                                  + re.shape[0] * win[1] * 4) / cs.HBM_BYTES_PER_S * 1e3
    cell.update(times("spectra", lambda: K.spectra(*a)))
    cell.update(times("istft_ola", lambda: K.istft_ola(*d)))
    cell["spectra_queued_ms"] = cs.queued_ms(lambda: K.spectra(*a))
    cell["istft_ola_queued_ms"] = cs.queued_ms(lambda: K.istft_ola(*d))
    if g.route == "global_chirp":  # the geometry's group against groups within L2
        slots = re.shape[0] * -(-g.n_frames // (2 if g.fft_paired else 1))
        L = g.fft_layout()[0]
        cell["slots"], cell["group"] = slots, G.global_group(L, slots)
        cell["l2_group"] = l2 = max(1, min(slots, L2_SCRATCH_BYTES // (8 * L)))
        cell.update(times("spectra_l2_group",
                          lambda: K._spectra_on("global_chirp", *a, group=l2)))
        cell.update(times("istft_ola_l2_group",
                          lambda: K._istft_ola_on("global_chirp", *d, group=l2)))
        torch.cuda.reset_peak_memory_stats()
        K._spectra_on("global_chirp", *a, group=l2)
        K._istft_ola_on("global_chirp", *d, group=l2)
        torch.cuda.synchronize()
        cell["l2_group_peak_over_inputs_mib"] = (torch.cuda.max_memory_allocated()
                                                 - base) / 2**20
    if g.route == "cluster_chirp":  # the 2^a 3^b family's length at the same shapes
        with chirp_lengths(family_length(CHIRP_FAMILY_23)):
            cell["slot_23"] = g.fft_layout()[0]
            for name, fn in (("spectra", lambda: K.spectra(*a)),
                             ("istft_ola", lambda: K.istft_ola(*d))):
                cell.update({f"{k[:-3]}_23_ms": v for k, v in times(name, fn).items()})
        cell["slot"] = g.fft_layout()[0]
    if args.library:
        views = (extract_chunks(xs, *cut).reshape(-1, g.view_len).contiguous() if chunked
                 else xs)
        window = torch.hann_window(g.win, periodic=True, device=xs.device)
        zm = torch.complex(re * mask, im * mask).transpose(1, 2).contiguous()
        stft = lambda: torch.stft(views, g.n_fft, g.hop, g.win, window,  # noqa: E731
                                  center=True, pad_mode="constant", return_complex=True)
        istft = lambda: torch.istft(zm, g.n_fft, g.hop, g.win, window,  # noqa: E731
                                    center=True, length=g.view_len)
        cell.update(times("torch_stft", stft))
        cell.update(times("torch_istft", istft))
        cell["torch_stft_queued_ms"] = cs.queued_ms(stft)
        cell["torch_istft_queued_ms"] = cs.queued_ms(istft)
        del zm, views
    if isinstance(cell["c_plan"], dict) and not chunked:
        m = mask[0].contiguous()
        cell.update(times("freq_smooth_blend", lambda: K.freq_smooth_blend(m, taps, 1.0)))
        cell["freq_smooth_blend_queued_ms"] = cs.queued_ms(
            lambda: K.freq_smooth_blend(m, taps, 1.0))
    print(f"{n_fft}{' chunked' if chunked else ''}: {json.dumps(cell)}", flush=True)
    del re, im, mask, d
    return cell


# --ab: the kernels' sources and entries by set (--ab-kernels: the real-FFT
# kernels, the global chirp route's, D's complex-frame kernel), and the
# variants of this tree: the patches of its sources ((file, old, new)
# replacements; None to time this tree's library) and D's run rule (None:
# the geometry's; "run32": the run length before whole groups, min(32, 8192
# / hop) hop blocks, the complex-frame kernel's before its ring; "longest":
# the complex-frame kernel's fft_run, not shortened to fill the grid). The
# diag_* variants take a piece of a kernel's work out (wrong outputs by
# design, not held) to see what it costs: A's pack (the general build's:
# the power-of-two build packs as its first stage loads), stages or
# unpack; D's pre-step, stages or overlap-add
AB_KERNELS = {
    "real": (("spectra_fft.cu", "istft_fft.cu"), ("nr_spectra_fft", "nr_istft_fft")),
    "global": (("spectra_global.cu", "istft_global.cu"), ("nr_spectra_global", "nr_istft_global")),
    "cplx": (("spectra_cplx.cu", "istft_cplx.cu"), ("nr_spectra_cplx", "nr_istft_cplx")),
}
_A, _D, _G, _AC = "spectra_fft.cu", "istft_fft.cu", "fft_global.cuh", "spectra_cplx.cu"
_AG, _DG = "spectra_global.cu", "istft_global.cu"
AB_VARIANTS = {
    "run32": (None, "run32"),
    # D's overlap-add a sample at a time, not RING_UNROLL at once
    "ring_loop": ([(_D, "constexpr int RING_UNROLL = 6;", "constexpr int RING_UNROLL = 1;")],
                  None),
    # D at one block an SM (128 registers, no spills), in place
    "d_one_block": ([(_D, "constexpr int BLOCKS_PER_SM = 2;", "constexpr int BLOCKS_PER_SM = 1;")],
                    None),
    # D's overlap-add a sample at a time for an even hop too, not in pairs
    "ola_scalar": ([(_D, "      if (p.hop % 2)\n", "      if (true)\n")], None),
    "diag_a_no_pack": ([
        (_A, "for (int e = sg.lane; e < nf * m; e += plan.threads) {",
         "for (int e = sg.lane; e < 0; e += plan.threads) {"),
        ], None),
    "diag_a_no_fft": ([
        (_A, "const float2* zo = nrf::fft_frames_large<false, ODD, false>(\n"
             "             s.z, s.sc, m, t.fe, s.stw, sg, plan);", "const float2* zo = s.z;"),
        (_A, "const float2* zo =\n"
             "             nrf::p2::fft_frames(s.z, s.sc, log2m, nrf::p2::radix(M, 1), t.fe, s.stw, sg);",
         "const float2* zo = s.z;")], None),
    "diag_a_no_unpack": ([
        (_A, "for (int e = sg.lane; e < nf * half; e += plan.threads) {",
         "for (int e = sg.lane; e < 0; e += plan.threads) {"),
        (_A, "e < min(t.fe << log2s, seg_end >> shift); e += step) {",
         "e < 0; e += step) {")], None),
    "diag_d_no_pre": ([
        (_D, "for (int e = sg.lane; e < nf * half; e += plan.threads) {",
         "for (int e = sg.lane; e < 0; e += plan.threads) {")], None),
    "diag_d_no_fft": ([(_D, "      nrf::fft_frames<true, ODD>(z, m, ge, stw, sg, plan);\n",
                        "")], None),
    "diag_d_no_ola": ([(_D, "for (int i0 = W * tid; i0 < ring;", "for (int i0 = W * tid; i0 < 0;")],
                      None),
    # D's complex-frame walk: runs of the geometry's length, not shortened
    # to fill the grid
    "cplx_fixed_run": (None, "longest"),
    # the global chirp route's rows pass at two blocks an SM (64 registers,
    # no spill), and its column passes at three too
    "g_rows2": ([(_G, "__launch_bounds__(nrf::GLOBAL_THREADS, 3)",
                  "__launch_bounds__(nrf::GLOBAL_THREADS, 2)")], None),
    "g_lb3": ([(f, "__launch_bounds__(nrf::GLOBAL_THREADS, 2)",
                "__launch_bounds__(nrf::GLOBAL_THREADS, 3)") for f in (_AG, _DG)], None),
    # kernel A's complex-frame kernel without room for the laid twiddles
    # (wrong outputs wherever a stage reads them: to time a build that
    # reads none, 1102 or 442)
    "diag_a_no_laid_room": ([
        (_AC, "R* raw = reinterpret_cast<R*>(stw + ((T + 1) & ~1));",
         "R* raw = reinterpret_cast<R*>(stw);"),
        (_AC, "sizeof(float2) * (Bk::PADDED * 2 + ((slot + 1) & ~1));",
         "sizeof(float2) * Bk::PADDED * 2;")], None),
    # kernel A's complex-frame kernel with every build's tile index in
    # shared memory across the stages, or none (the tile's view, first
    # frame and frames in registers)
    "a_tile_sm_all": ([(_AC, "constexpr bool TILE_SM = BIG || (ODD % 13 == 0 && !LARGE);",
                        "constexpr bool TILE_SM = true;")], None),
    "a_tile_sm_none": ([(_AC, "constexpr bool TILE_SM = BIG || (ODD % 13 == 0 && !LARGE);",
                         "constexpr bool TILE_SM = false;")], None),
}


def checkout_runs(root: pathlib.Path) -> dict:
    """The GateGeometry attributes that give D's runs by the rule of the
    checkout at root (its own ``geometry.py``, loaded beside this tree's),
    for this tree's geometry: the runs its kernels take as given (its
    ``cplx_run`` where it has one, else its ``fft_run``)."""
    spec = importlib.util.spec_from_file_location(
        f"ab_geometry_{abs(hash(str(root)))}", root / "noisereduce_tpu_torch/ops/cuda/geometry.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    theirs = lambda g: mod.GateGeometry(g.scfg, g.view_len)  # noqa: E731
    patches = run_patches(lambda g: theirs(g).fft_run)
    if hasattr(mod.GateGeometry, "cplx_run"):
        patches["cplx_run"] = lambda g, rows, n_out, blocks: theirs(g).cplx_run(rows, n_out, blocks)
    return patches


def old_run(g) -> int:
    """D's run length before whole groups: min(32, 8192 / hop) hop blocks."""
    from noisereduce_tpu_torch.ops.cuda import geometry as G
    return max(1, min(G.FFT_RUN, G.FFT_ACC // g.hop))


def checkout_signatures(root: pathlib.Path) -> dict:
    """The C signatures of the checkout at root (its own ``build.py``,
    loaded beside this tree's)."""
    spec = importlib.util.spec_from_file_location(
        f"ab_build_{abs(hash(str(root)))}", root / "noisereduce_tpu_torch/ops/cuda/build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES


def adapters(signatures) -> dict:
    """Wrappers that call a checkout's entries with this tree's arguments:
    nr_istft_cplx before a big block's two passes took no scratch (y,
    t_lo, n_fr after filt)."""
    from noisereduce_tpu_torch.ops.cuda import build
    ours = build._SIGNATURES["nr_istft_cplx"]
    if len(signatures.get("nr_istft_cplx", ours)) == len(ours) - 3:
        return {"nr_istft_cplx": lambda fn: lambda *a: fn(*a[:27], *a[30:])}
    return {}


def run_patches(rule) -> dict:
    """The GateGeometry attributes that give D's runs under ``rule`` (a
    function of the geometry: every run that rule's; "longest": the
    complex-frame kernel's fft_run, not shortened to fill the grid)."""
    if rule == "longest":
        return {"cplx_run": lambda g, rows, n_out, blocks: g.fft_run}
    return {"fft_run": property(rule), "cplx_run": lambda g, rows, n_out, blocks: rule(g)}


def ab_library(csrc: pathlib.Path, patches, out: pathlib.Path, sources, entries,
               signatures=None):
    """The kernels of ``sources`` in csrc (with ``patches`` applied to a
    copy) built with this tree's flags into out, loaded with ``entries``
    (their C signatures from ``signatures``, by default this tree's), and
    their ptxas -v reports' registers and spills by kernel."""
    from noisereduce_tpu_torch.ops.cuda import build
    src = out / "csrc"
    src.mkdir(parents=True)
    for f in csrc.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (src / f.name).write_text(f.read_text())
    for name, old, new in patches or ():
        text = (src / name).read_text()
        if old not in text:
            raise SystemExit(f"--ab: a patch of {name} does not apply")
        (src / name).write_text(text.replace(old, new))
    nvcc = build._nvcc()
    objs = [out / f"{pathlib.Path(n).stem}.o" for n in sources]
    reports = build._run([[nvcc, *build.COMPILE_FLAGS, "-I", str(src), "-c", "-o", str(o),
                           str(src / n)] for o, n in zip(objs, sources)])
    build._run([[nvcc, *build.LINK_FLAGS, "-o", str(out / "libab.so"), *map(str, objs)]])
    lib = ctypes.CDLL(str(out / "libab.so"))
    for name in entries:
        getattr(lib, name).argtypes = (signatures or build._SIGNATURES)[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib, ptxas_usage(reports)


def ptxas_usage(reports) -> dict:
    """Registers and spill bytes of each kernel in ptxas -v reports, by
    kernel and template arguments as mangled."""
    usage = {}
    for report in reports:
        for e in report.split("Compiling entry function")[1:]:
            m = regex.search(r"\d+(\w+?_kernel)I(\w*?)EE?v", e)
            regs = regex.search(r"Used (\d+) registers", e)
            spill = regex.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
            if m and regs and spill:
                usage[f"{m.group(1)}<{m.group(2)}>"] = (
                    f"{regs.group(1)} registers, {spill.group(1)} / {spill.group(2)} B spill")
    return usage


class Swapped:
    """This tree's kernel library with ``entries`` of another build (each
    called through its ``adapt`` wrapper, if any)."""

    def __init__(self, base, other, entries, adapt=None):
        self.base, self.other, self.entries, self.adapt = base, other, entries, adapt or {}

    def __getattr__(self, name):
        if name not in self.entries:
            return getattr(self.base, name)
        fn = getattr(self.other, name)
        return self.adapt[name](fn) if name in self.adapt else fn


def ab_cells(wanted) -> list:
    """(name, n_fft, hop, samples, sample rate, chunked) of the CELLS (as
    reduce_noise chunks) and LONG_CELLS that ``wanted`` names."""
    return ([(name, n_fft, hop, secs * sr, sr, True) for name, n_fft, hop, secs, sr in CELLS
             if str(n_fft) in wanted]
            + [(name, n_fft, hop, n, sr, chunked)
               for key, name, n_fft, hop, n, sr, chunked in LONG_CELLS if key in wanted])


def ab_main(args, cs) -> None:
    """--ab: the kernels of --ab-kernels of this tree, other checkouts and
    the variants, in one process, interleaved over --rounds rounds."""
    from noisereduce_tpu_torch.config import StftConfig
    from noisereduce_tpu_torch.ops.cuda import build
    from noisereduce_tpu_torch.ops.cuda import geometry as G
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    print(cs.card_line(), flush=True)
    sets = [k for k in args.ab_kernels.split(",") if k]
    sources = tuple(f for k in sets for f in AB_KERNELS[k][0])
    entries = tuple(e for k in sets for e in AB_KERNELS[k][1])
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="fft_ab_", dir=os.environ.get("TMPDIR")))
    here = pathlib.Path(build.CSRC)
    # name: (csrc to build, its patches, D's run patches); None: this tree's
    # library; a checkout's C signatures by name
    plans, sigs = {"change": (None, None, {})}, {}
    for entry in [e for e in args.ab.split(",") if e]:
        name, _, path = entry.rpartition("=")
        root = pathlib.Path(path)
        name = name or "parent"
        plans[name] = (root / "noisereduce_tpu_torch/ops/cuda/csrc", None, checkout_runs(root))
        sigs[name] = checkout_signatures(root)
    # the sources and entries each build swaps: a checkout's, every set's; a
    # variant's, the sets whose sources it patches
    swaps = {name: (sources, entries) for name in plans}
    for v in [v for v in args.variants.split(",") if v]:
        patches, rule = AB_VARIANTS[v]
        plans[v] = (here if patches else None, patches,
                    run_patches(old_run if rule == "run32" else rule) if rule else {})
        # (a header's patch: every set)
        mine = [k for k in sets if any(f in AB_KERNELS[k][0] or f.endswith(".cuh")
                                       for f, _, _ in patches or ())]
        swaps[v] = (tuple(f for k in mine for f in AB_KERNELS[k][0]),
                    tuple(e for k in mine for e in AB_KERNELS[k][1]))
    t0 = time.perf_counter()
    # the other builds beside this tree's own
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = {name: pool.submit(ab_library, csrc, patches, tmp / name, *swaps[name],
                                   sigs.get(name))
                 for name, (csrc, patches, _) in plans.items() if csrc is not None}
        base = build.load()
        built = {name: f.result() for name, f in built.items()}
    print(f"{len(built) + 1} builds in {time.perf_counter() - t0:.1f} s", flush=True)
    usage = ptxas_usage(
        (build.library_path().parent / f"{pathlib.Path(n).stem}.ptxas.txt").read_text()
        for n in sources)
    print(f"change: {json.dumps(usage)}", flush=True)
    trees = {}
    for name, (_, _, runs) in plans.items():
        lib = base
        if name in built:
            lib = Swapped(base, built[name][0], swaps[name][1], adapters(sigs.get(name, {})))
            print(f"{name}: {json.dumps(built[name][1])}", flush=True)
        trees[name] = (lib, runs)
    dtype = getattr(torch, args.dtype)
    wanted = {v for v in args.cells.split(",") if v}
    signals, out = {}, {"dtype": args.dtype, "kernels": sets, "cells": {}}
    for name, n_fft, hop, n, sr, chunked in ab_cells(wanted):
        if sr not in signals or signals[sr].shape[-1] < n:
            signals[sr] = torch.as_tensor(cs.headline_signal(-(-n // sr), sr)).cuda()
        xs = signals[sr][None, :n].to(dtype).contiguous()
        scfg = StftConfig(n_fft=n_fft, hop_length=hop)
        cut = (cs.CHUNK, cs.PADDING) if chunked else (0, 0)
        g = G.gate_geometry(scfg, cs.CHUNK + 2 * cs.PADDING if chunked else n)
        win = (cs.PADDING, cs.CHUNK) if chunked else (0, n)  # D's trimmed output window
        a = (xs, g, *cut)
        mask = None
        cell = out["cells"][name] = {t: {"spectra": [], "istft_ola": []} for t in trees}
        cell["route"] = g.route
        glob = g.route == "global_chirp"
        if glob:  # groups whose scratch stays in the card's L2, beside the geometry's
            slots = (xs.shape[0] * (-(-n // cs.CHUNK) if chunked else 1)
                     * -(-g.n_frames // (2 if g.fft_paired else 1)))
            L = g.fft_layout()[0]
            cell["slots"], cell["group"] = slots, G.global_group(L, slots)
            cell["l2_group"] = l2 = max(1, min(slots, L2_SCRATCH_BYTES // (8 * L)))
            for t in trees:
                cell[t].update(spectra_l2=[], istft_ola_l2=[])
        ref = {}
        for rnd in range(args.rounds):
            order = list(trees) if rnd % 2 == 0 else list(trees)[::-1]
            for t in order:
                lib, runs = trees[t]
                with mock.patch.object(build, "_lib", lib), contextlib.ExitStack() as stack:
                    for attr, value in runs.items():
                        stack.enter_context(mock.patch.object(G.GateGeometry, attr, value))
                    re, im = K.spectra(*a)
                    if mask is None:
                        mask = torch.rand(re.shape, generator=torch.Generator("cuda").manual_seed(0),
                                          device=re.device)
                        cell["views"], cell["frames"] = re.shape[0], re.shape[1]
                        planes = re.numel() * re.element_size()
                        cell["spectra_bound_ms"] = (xs.numel() * xs.element_size() + 2 * planes
                                                    ) / cs.HBM_BYTES_PER_S * 1e3
                        cell["istft_ola_bound_ms"] = (2 * planes + mask.numel() * 4 + re.shape[0]
                                                      * win[1] * xs.element_size()
                                                      ) / cs.HBM_BYTES_PER_S * 1e3
                    d = (re, im, mask, g, *win)
                    y = K.istft_ola(*d)
                    if rnd == 0 and not t.startswith("diag_"):  # bitwise against this tree's
                        if t == "change":
                            ref = dict(re=re, im=im, y=y)
                        else:
                            got = dict(re=re, im=im, y=y)
                            cell[t]["max_abs_diff"] = {
                                k: float((got[k].float() - ref[k].float()).abs().max())
                                for k in ref}
                    if rnd == 0 and glob:  # device ms by launch (profiler)
                        cell[t]["spectra_split"] = cs.device_ms(lambda: K.spectra(*a), args.reps)
                        cell[t]["istft_ola_split"] = cs.device_ms(lambda: K.istft_ola(*d),
                                                                  args.reps)
                    cplx = g.route == "chirp" or g.route == "fft" and not g.fft_real
                    cell[t]["run"] = ("two passes" if cplx and g.cplx_two_pass else
                                      g.cplx_run(re.shape[0], g.out_blocks(*win)[1],
                                                 K.cplx_capacity(g, dtype, kernel="istft_ola"))
                                      if cplx else g.fft_run)
                    cell[t]["spectra"].append(cs.queued_ms(lambda: K.spectra(*a), args.reps))
                    cell[t]["istft_ola"].append(cs.queued_ms(lambda: K.istft_ola(*d), args.reps))
                    if glob:
                        cell[t]["spectra_l2"].append(cs.queued_ms(
                            lambda: K._spectra_on("global_chirp", *a, group=l2), args.reps))
                        cell[t]["istft_ola_l2"].append(cs.queued_ms(
                            lambda: K._istft_ola_on("global_chirp", *d, group=l2), args.reps))
                    del re, im, y, d
        for t in trees:
            for k in ("spectra", "istft_ola", "spectra_l2", "istft_ola_l2"):
                if k not in cell[t]:
                    continue
                v = [x for x in cell[t][k] if x is not None]
                cell[t][f"{k}_min_med_max"] = [min(v), statistics.median(v), max(v)] if v else None
        if args.library:  # torch.stft / torch.istft on the same views (float32)
            # and the card's rate on one elementwise pass over two planes
            re, im = K.spectra(*a)
            both = torch.empty_like(re)
            cell["add_planes_ms"] = cs.queued_ms(lambda: torch.add(re, im, out=both), args.reps)
            cell["add_planes_bound_ms"] = (3 * re.numel() * re.element_size()
                                           / cs.HBM_BYTES_PER_S * 1e3)
            del re, im, both
            xf = xs.float()
            views = (extract_chunks(xf, *cut).reshape(-1, g.view_len) if chunked else xf)
            window = torch.hann_window(g.win, periodic=True, device=xs.device)
            re, im = K.spectra(xf, g, *cut)
            zm = torch.complex(re * mask, im * mask).transpose(1, 2).contiguous()
            cell["torch_stft_ms"] = cs.queued_ms(lambda: torch.stft(
                views.contiguous(), g.n_fft, g.hop, g.win, window, center=True,
                pad_mode="constant", return_complex=True), args.reps)
            istft = lambda: torch.istft(  # noqa: E731
                zm, g.n_fft, g.hop, g.win, window, center=True, length=g.view_len)
            cell["torch_istft_ms"] = cs.time_ms(istft, args.reps)
            # its device time: the profiler's kernels (it waits for the card,
            # so queued_ms cannot hide its host work), summed and by launch
            split = cs.device_ms(istft, args.reps)
            cell["torch_istft_device_ms"] = sum(split.values()) or None
            cell["torch_istft_split"] = split
            del views, zm, re, im
        del mask
        torch.cuda.empty_cache()
        print(f"{name}: {json.dumps(cell)}", flush=True)
        if glob:  # each tree's device ms by launch, A's and D's side by side
            print(f"{name} split: " + json.dumps(
                {t: {k: cell[t].get(f"{k}_split") for k in ("spectra", "istft_ola")}
                 for t in trees} | {"torch.istft": cell.get("torch_istft_split")}), flush=True)
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cells", default="",
                    help="comma-separated n_fft values to time (default: every cell)")
    ap.add_argument("--library", action="store_true",
                    help="also time torch.stft / torch.istft at each cell's shapes")
    ap.add_argument("--ab", default="",
                    help="[NAME=]checkout[,...]: checkouts whose kernels (--ab-kernels) to "
                         "time beside this tree's, in one process")
    ap.add_argument("--ab-kernels", default="real",
                    help=f"--ab: comma-separated sets of kernels to swap ({', '.join(AB_KERNELS)})")
    ap.add_argument("--rounds", type=int, default=4, help="--ab: rounds of alternating order")
    ap.add_argument("--variants", default="",
                    help=f"--ab: comma-separated variants of this tree ({', '.join(AB_VARIANTS)})")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="--ab: the signal's and planes' dtype")
    args = ap.parse_args()
    wanted = {v for v in args.cells.split(",") if v}
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import noisereduce_tpu_torch
    # this tree's chip_smoke.py for the helpers and inputs, whichever
    # package PYTHONPATH puts first
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if args.ab:
        ab_main(args, cs)
        return
    CHUNK, NOISE_SECONDS, PADDING, SR = cs.CHUNK, cs.NOISE_SECONDS, cs.PADDING, cs.SR
    card_line, headline_signal, noise_clip, time_ms = (
        cs.card_line, cs.headline_signal, cs.noise_clip, cs.time_ms)

    def device_ms(fn, reps):  # the device time of one call's kernels, ms, or None
        return sum(cs.device_ms(fn, reps).values()) or None

    def host_ms(fn, reps):  # the host's time to issue one call, ms
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e3

    def times(prefix, fn):
        return {f"{prefix}_ms": time_ms(fn, args.reps),
                f"{prefix}_device_ms": device_ms(fn, args.reps),
                f"{prefix}_host_ms": host_ms(fn, args.reps)}

    from noisereduce_tpu_torch.config import StftConfig
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    print(card_line(), flush=True)
    from noisereduce_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.load()  # before any cell, so that no first call times the build
    print(f"kernel library loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    signals = {SR: torch.as_tensor(headline_signal(960)).cuda()}
    out = {"package": str(pathlib.Path(noisereduce_tpu_torch.__file__).parent), "cells": {}}
    for name, n_fft, hop, secs, sr in CELLS:
        if wanted and str(n_fft) not in wanted:
            continue
        if sr not in signals:
            signals[sr] = torch.as_tensor(headline_signal(secs, sr)).cuda()
        xs = signals[sr][None, : secs * sr].contiguous()
        g = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), CHUNK + 2 * PADDING)
        # a chirp-route cell also with a power-of-two chirp length (a tree
        # that has the route)
        variants = {"": contextlib.nullcontext}
        if getattr(g, "route", None) == "chirp":
            variants[" (chirp length a power of two)"] = lambda: chirp_lengths(pow2_length)
        for tag, lengths in variants.items():
            with lengths():
                a = (xs, g, CHUNK, PADDING)
                K.reset_launch_counts()
                re, im = K.spectra(*a)
                mask = torch.rand(re.shape, generator=torch.Generator("cuda").manual_seed(0),
                                  device=re.device)
                d = (re, im, mask, g, PADDING, CHUNK)
                K.istft_ola(*d)
                routes = K.route_counts()
                planes = re.numel() * re.element_size()
                cell = out["cells"][name + tag] = dict(
                    frames=re.shape[0] * re.shape[1],
                    slot=g.fft_layout()[0] if hasattr(g, "fft_layout") else None,
                    grid=walk_grid(K, g),
                    # bytes bounds: the signal read once and the planes
                    # written once (A); the planes and the mask read once
                    # and the views' cores written once (D)
                    spectra_bound_ms=(xs.numel() * xs.element_size() + 2 * planes)
                    / cs.HBM_BYTES_PER_S * 1e3,
                    istft_ola_bound_ms=(3 * planes + re.shape[0] * CHUNK * 4)
                    / cs.HBM_BYTES_PER_S * 1e3,
                    **times("spectra", lambda: K.spectra(*a)),
                    **times("istft_ola", lambda: K.istft_ola(*d)),
                    routes={k: max(v, key=v.get) for k, v in routes.items()},
                )
                if args.library and not tag:
                    views = extract_chunks(xs, CHUNK, PADDING).reshape(-1, g.view_len).contiguous()
                    window = torch.hann_window(g.win, periodic=True, device=xs.device)
                    zm = torch.complex(re * mask, im * mask).transpose(1, 2).contiguous()
                    cell.update(times("torch_stft", lambda: torch.stft(
                        views, g.n_fft, g.hop, g.win, window, center=True, pad_mode="constant",
                        return_complex=True)))
                    cell.update(times("torch_istft", lambda: torch.istft(
                        zm, g.n_fft, g.hop, g.win, window, center=True, length=g.view_len)))
                    del views, zm
                del re, im, mask
                torch.cuda.empty_cache()
    for key, name, n_fft, hop, n, sr, chunked in LONG_CELLS:
        if key in wanted:
            out["cells"][name] = long_cell(cs, K, times, signals, n_fft, hop, n, sr, chunked,
                                           args)
            torch.cuda.empty_cache()
    if wanted and "1024" not in wanted:
        print(json.dumps(out), flush=True)
        return
    noise = torch.as_tensor(noise_clip(NOISE_SECONDS)).cuda()[None]
    an = (noise, gate_geometry(StftConfig(n_fft=1024, hop_length=256), noise.shape[-1]))
    out["noise_row"] = times("spectra", lambda: K.spectra(*an))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
