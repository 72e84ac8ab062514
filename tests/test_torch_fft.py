"""PyTorch port: the FFT and chirp-z routes of kernels A and D (the
real-FFT kernels ``csrc/spectra_fft.cu`` / ``csrc/istft_fft.cu`` and the
complex-frame kernels ``csrc/spectra_cplx.cu`` / ``csrc/istft_cplx.cu``,
over ``csrc/fft_smem.cuh``), emulated in float64 numpy as the sources
compute them: the frame-tile loader with its view and signal bounds, the
host tables, the Stockham stage order with radices up to 13 and the
large radices 17 to 31 (``stage_large``: its fold and sums through a
second buffer, item by item; a build with them runs its small radices
out of place, ``stage_oop``, with ``stage``'s index math), the real-FFT
split and unsplit, odd n_fft as two frames a complex transform, the
chirp-z convolution with its exact chirp index and host filter spectrum,
and D's overlap-add of runs with halo frames, the envelope table and the
trim; the persistent walks and their span and slab copies, the real-FFT
kernels' laid twiddles and D's overlap-add ring; and frames of 1 to 63
samples (n_fft 2 to 63: slots of 1 to 31 points, or 63 odd, and the chirp
at 37), in tiles and runs of up to a few thousand frames. Held
against the plain versions, which tests/test_torch_kernels.py holds
against the JAX package's STFT. The route predicate is held to
``csrc/fft_route.cuh``, compiled with the host compiler.

Float64 bound: 1e-9 x the plain version's max |value|.
"""
import bisect
import functools
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from noisereduce_tpu_torch.config import StftConfig
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda import build
from noisereduce_tpu_torch.ops.cuda.geometry import (
    FFT_ACC,
    FFT_BIG_ELEMS,
    FFT_BIG_WARPS,
    FFT_ELEMS,
    FFT_RUN,
    CPLX_SMALL_GROUPS,
    FFT_WARP_POINTS,
    FFT_WARPS,
    CHIRP_MAX_N,
    LARGE_RADICES,
    CLUSTER_MAX,
    SMALL_NFFT,
    SMEM_MAX,
    _strip,
    chirp_length,
    cluster_build,
    cluster_chirp_lengths,
    cluster_layout,
    cluster_shape,
    fft_n,
    fft_route,
    gate_geometry,
    global_shape,
    kernels_supported,
    global_split,
    real_kernel,
)
from noisereduce_tpu_torch.parallel.chunking import n_chunks_for

torch.set_num_threads(2)

F64_TOL = 1e-9
TORCH = dict(convention="torch", quantize_window_f32=True)
GEOMS = {
    "nfft512-r4": dict(n_fft=512, hop_length=128),
    "nfft1024-r4": dict(n_fft=1024, hop_length=256),
    "nfft1024-r2": dict(n_fft=1024, hop_length=512),
    "nfft512-r1": dict(n_fft=512, hop_length=512),
    "nfft2048-win1024": dict(n_fft=2048, win_length=1024, hop_length=256),
    "torch-nfft1024-r4": dict(n_fft=1024, hop_length=256, **TORCH),
    "torch-nfft512-r2": dict(n_fft=512, hop_length=256, **TORCH),
    "torch-nfft512-r1": dict(n_fft=512, hop_length=512, **TORCH),
    "torch-nfft2048-win1024": dict(n_fft=2048, win_length=1024, hop_length=512, **TORCH),
    # mixed radix: M = 200 = 2^3 5^2, 240 = 2^4 3 5, 768 = 2^8 3, 441 = 3^2 7^2
    "nfft400-r4": dict(n_fft=400, hop_length=100),
    "nfft480-r4": dict(n_fft=480, hop_length=120),
    "nfft1536-r4": dict(n_fft=1536, hop_length=384),
    "nfft882-r2": dict(n_fft=882, hop_length=441),
    "torch-nfft400-r4": dict(n_fft=400, hop_length=100, **TORCH),
    "torch-nfft480-r4": dict(n_fft=480, hop_length=120, **TORCH),
    "torch-nfft1536-r4": dict(n_fft=1536, hop_length=384, **TORCH),
    "torch-nfft882-r2": dict(n_fft=882, hop_length=441, **TORCH),
    # frames below 64 samples: M = 1 (no stage; 4,096 frames a tile), 2, 8
    # and 20 = 2^2 5 (204 frames a tile)
    "nfft2-r2": dict(n_fft=2, hop_length=1),
    "nfft4-r4": dict(n_fft=4, hop_length=1),
    "nfft16-r4": dict(n_fft=16, hop_length=4),
    "nfft40-r4": dict(n_fft=40, hop_length=10),
    "torch-nfft2-r2": dict(n_fft=2, hop_length=1, **TORCH),
    "torch-nfft4-r4": dict(n_fft=4, hop_length=1, **TORCH),
    "torch-nfft16-r4": dict(n_fft=16, hop_length=4, **TORCH),
    "torch-nfft40-r4": dict(n_fft=40, hop_length=10, **TORCH),
}
# the complex-frame kernels: radix 11 (M = 550 = 2 5^2 11) and 13 (M = 520
# = 2^3 5 13); odd n_fft, two frames a transform (441 = 3^2 7^2, 1323 =
# 3^3 7^2; 5005 = 5 7 11 13 in a big block); the large radices (M = 551
# = 19 x 29; odd 493 = 17 x 29 and 1235 = 5 13 19; M = 713 = 23 x 31, M =
# 609 = 3 7 29, M = 544 = 2^5 17); the chirp-z route (odd 1101 = 3 x 367,
# L = 2304; M = 2053, L = 8192 in a big block)
CPLX_GEOMS = {
    "nfft1100-r4": dict(n_fft=1100, hop_length=275),
    "nfft1040-r4": dict(n_fft=1040, hop_length=260),
    "nfft441-r3": dict(n_fft=441, hop_length=147),
    "nfft1323-r3": dict(n_fft=1323, hop_length=441),
    "nfft5005-r5": dict(n_fft=5005, hop_length=1001),
    "nfft1102-r2": dict(n_fft=1102, hop_length=551),
    "nfft493-r17": dict(n_fft=493, hop_length=29),
    "nfft1235-r5": dict(n_fft=1235, hop_length=247),
    "nfft1426-r2": dict(n_fft=1426, hop_length=713),
    "nfft1218-r3": dict(n_fft=1218, hop_length=406),
    "nfft1088-r4": dict(n_fft=1088, hop_length=272),
    "nfft1101-r3": dict(n_fft=1101, hop_length=367),
    "nfft4106-r2": dict(n_fft=4106, hop_length=2053),
    "torch-nfft1100-r4": dict(n_fft=1100, hop_length=275, **TORCH),
    "torch-nfft441-r3": dict(n_fft=441, hop_length=147, **TORCH),
    "torch-nfft1102-r2": dict(n_fft=1102, hop_length=551, **TORCH),
    "torch-nfft493-r17": dict(n_fft=493, hop_length=29, **TORCH),
    "torch-nfft1101-r3": dict(n_fft=1101, hop_length=367, **TORCH),
    # even n_fft past 8192 in a big block (no cluster shape): n = 4290 = 2 3
    # 5 11 13, n = 5005 = 5 7 11 13
    "nfft8580-r4": dict(n_fft=8580, hop_length=2145),
    "nfft10010-r5": dict(n_fft=10010, hop_length=2002),
    "torch-nfft8580-r4": dict(n_fft=8580, hop_length=2145, **TORCH),
    # frames below 64 samples: odd 3 (2,730 frames a tile) and 63 = 3^2 7,
    # M = 17 and 31 (radix 17 and 31, stage_large), the chirp at odd prime
    # 37 (L = 81)
    "nfft3-r3": dict(n_fft=3, hop_length=1),
    "nfft34-r2": dict(n_fft=34, hop_length=17),
    "nfft37-r37": dict(n_fft=37, hop_length=1),
    "nfft62-r2": dict(n_fft=62, hop_length=31),
    "nfft63-r3": dict(n_fft=63, hop_length=21),
    "torch-nfft3-r3": dict(n_fft=3, hop_length=1, **TORCH),
    "torch-nfft34-r2": dict(n_fft=34, hop_length=17, **TORCH),
    "torch-nfft37-r37": dict(n_fft=37, hop_length=1, **TORCH),
    "torch-nfft62-r2": dict(n_fft=62, hop_length=31, **TORCH),
    "torch-nfft63-r3": dict(n_fft=63, hop_length=21, **TORCH),
    # n_fft 1: a slot of one point, two frames (the torch window; scipy's
    # periodic Hann window of one sample is 0)
    "torch-nfft1-r1": dict(n_fft=1, hop_length=1, **TORCH),
}
# the cluster route: n = 20000 = 100 x 200 on 4 blocks (n_fft 40000), 16384
# = 128 x 128 on 2, odd 19683 = 81 x 243 on 3 (two frames a transform),
# 31250 = 125 x 250 on 5, 8192 = 64 x 128 on 2 (n_fft 16384: a big block's
# size, two blocks of 4096); below a big block's size 8190 = 78 x 105 on 3
# (n_fft 16380), 6000 = 60 x 100 on 2 (12000), odd 4851 = 33 x 147 on 3
CLUSTER_GEOMS = {
    "nfft16380-r4": dict(n_fft=16380, hop_length=4095),
    "nfft12000-r4": dict(n_fft=12000, hop_length=3000),
    "torch-nfft16380-r4": dict(n_fft=16380, hop_length=4095, **TORCH),
    "nfft4851-r3": dict(n_fft=4851, hop_length=1617),
    "nfft16384-r4": dict(n_fft=16384, hop_length=4096),
    "torch-nfft16384-r4": dict(n_fft=16384, hop_length=4096, **TORCH),
    "nfft40000-r4": dict(n_fft=40000, hop_length=10000),
    "torch-nfft40000-r4": dict(n_fft=40000, hop_length=10000, **TORCH),
    "nfft32768-r2": dict(n_fft=32768, hop_length=16384),
    "nfft19683-r3": dict(n_fft=19683, hop_length=6561),
    "torch-nfft19683-r3": dict(n_fft=19683, hop_length=6561, **TORCH),
    "nfft62500-r5": dict(n_fft=62500, hop_length=12500),
}
# the cluster chirp route: odd prime 4801 (L = 9720, 2 blocks; r = 1) and
# odd 4803 = 3 x 1601 (r = 3), even 16386 (n = 3 x 2731, L = 16875 = 3^3
# 5^4, 3 blocks) and 9218 (n = 11 x 419, L = 9375 = 3 5^5, 5 blocks)
CLUSTER_CHIRP_GEOMS = {
    "nfft4801-r1": dict(n_fft=4801, hop_length=4801),
    "torch-nfft4803-r3": dict(n_fft=4803, hop_length=1601, **TORCH),
    "nfft16386-r6": dict(n_fft=16386, hop_length=2731),
    "nfft9218-r2": dict(n_fft=9218, hop_length=4609),
}
CS, PAD, N_SRC = 4000, 700, 9500


def _close(got, ref, tol=F64_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    dev = np.abs(got - ref).max()
    assert dev <= tol * scale, f"max|dev| {dev:.3e} vs {tol:.0e} x {scale:.3e}"


def _twiddles(n_fft):
    t = K._twiddle_np(n_fft)
    return t[:, 0] + 1j * t[:, 1]


def _complex(tab):
    return tab[:, 0] + 1j * tab[:, 1]


def _div(x, d):
    """fft_smem.cuh::Div: x / d as the high half of x * ceil(2^32 / d)."""
    x = np.asarray(x, np.uint64)
    if d == 1:
        return x.astype(np.int64)
    m = np.uint64(0xFFFFFFFF // d + 1)
    return ((x * m) >> np.uint64(32)).astype(np.int64)


def _radices(m):
    """The radices of fft_frames' stages: the power-of-two part of m first
    (8 while 8 of it remain, then 4 or 2), then the 3s, 5s, 7s, 11s and
    13s, then the large radices 17, 19, 23, 29 and 31."""
    out, ns, p2 = [], 1, m & -m
    while ns < p2:
        out.append(min(8, p2 // ns))
        ns *= out[-1]
    for r in (3, 5, 7, 11, 13) + LARGE_RADICES:
        while (m // ns) % r == 0:
            out.append(r)
            ns *= r
    return out


def _dft_r(v, inverse):
    """fft_smem.cuh::dft<R> on (..., R) complex, the sources' formulas with
    their constants in float64: radix 2, 4 and 8 as butterflies, 3, 5, 7,
    11 and 13 as a_m -+ i b_m over t+_k = v[k] + v[R-k], t-_k = v[k] -
    v[R-k] (dft3, dft5, dft7 and dft_odd's loops: the constant of pair k
    in output m at index k m mod R); the large radices 17 to 31 by the same
    formula (stage_large's sums, ``_stage_large``)."""
    R = v.shape[-1]
    rot = 1j if inverse else -1j  # rot<INV>
    if R in (2, 4, 8):
        if R == 2:
            return np.stack([v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]], -1)
        e, o = _dft_r(v[..., 0::2], inverse), _dft_r(v[..., 1::2], inverse)
        o = o * np.exp(rot * 2 * np.pi * np.arange(R // 2) / R)
        return np.concatenate([e + o, e - o], -1)
    h = R // 2
    tp = [v[..., k] + v[..., R - k] for k in range(1, h + 1)]
    tm = [rot * (v[..., k] - v[..., R - k]) for k in range(1, h + 1)]
    out = np.empty_like(v)
    out[..., 0] = v[..., 0] + sum(tp)
    for mm in range(1, h + 1):
        a = v[..., 0] + sum(np.cos(2 * np.pi * (k * mm % R) / R) * tp[k - 1]
                            for k in range(1, h + 1))
        b = sum(np.sin(2 * np.pi * (k * mm % R) / R) * tm[k - 1] for k in range(1, h + 1))
        out[..., mm], out[..., R - mm] = a + b, a - b
    return out


def _stage_large(z, tw, R, ns, inverse, fps):
    """fft_smem.cuh::stage_large on (nf, m) complex, a segment of fps >= nf
    slots, with the table tw of 2m points, item by item as its threads
    take them: nb = fps m/R butterflies a scratch row, items it < (H + 1)
    nb (H = R/2), k = it / nb by the two Divs of the source (m/R, then
    fps), b = it - k nb, slot f = b / (m/R) (items of slots past nf
    skipped), j = b - f m/R. Fold: row 0 the point v[0], rows k and H + k
    t+_k and t-_k of the points v[k], v[R-k] at j + k m/R, j + (R-k) m/R,
    twiddled by tw[2 (j mod ns) k m/(ns R)] (conjugated for the inverse).
    Sums: item (mm, b) adds v[0] and the t+ rows (mm = 0), or forms a =
    v[0] + sum_k c_q t+_k and b = rot(sum_k s_q t-_k), q = k mm mod R
    stepped by mm, (c_q, -s_q) = tw[q 2m/R], and stores a + b at d + mm ns
    and a - b at d + (R - mm) ns, d = (j - j mod ns) R + j mod ns."""
    nf, m = z.shape
    H, mr = R // 2, m // R
    nb = fps * mr
    tstep = 2 * (m // (ns * R))
    items = np.arange((H + 1) * nb)
    k = _div(_div(items, mr), fps)
    assert np.array_equal(k, items // nb)
    b = items - k * nb
    f = _div(b, mr)
    keep = f < nf
    k, b, f = k[keep], b[keep], f[keep]
    j = b - f * mr
    jm = j - _div(j, ns) * ns
    flat = z.reshape(-1)
    S = np.full(R * nb, np.nan, complex)  # the segment's scratch, rows of nb
    base = f * m + j
    k0 = k == 0
    S[b[k0]] = flat[base[k0]]
    kk, bb, bs, jj = k[~k0], b[~k0], base[~k0], jm[~k0]
    wl, wh = tw[jj * kk * tstep], tw[jj * (R - kk) * tstep]
    if inverse:
        wl, wh = np.conj(wl), np.conj(wh)
    lo, hi = flat[bs + kk * mr] * wl, flat[bs + (R - kk) * mr] * wh
    S[kk * nb + bb], S[(H + kk) * nb + bb] = lo + hi, lo - hi
    rot = 1j if inverse else -1j
    out = np.full(nf * m, np.nan, complex)
    d = f * m + (j - jm) * R + jm
    for mm in range(H + 1):
        sel = k == mm  # the items of output pair mm (k is it / nb)
        bm, dm = b[sel], d[sel]
        v0 = S[bm]
        if mm == 0:
            out[dm] = v0 + sum(S[q * nb + bm] for q in range(1, H + 1))
            continue
        a, bsum, q = v0.copy(), np.zeros_like(v0), 0
        for kk in range(1, H + 1):
            q = q + mm - (R if q + mm >= R else 0)
            w = tw[q * tstep * ns]
            a = a + w.real * S[kk * nb + bm]
            bsum = bsum - w.imag * S[(H + kk) * nb + bm]
        out[dm + mm * ns], out[dm + (R - mm) * ns] = a + rot * bsum, a - rot * bsum
    assert not np.isnan(out).any()
    return out.reshape(nf, m)


def _stockham(z, tw, inverse, fps=None):
    """fft_smem.cuh::fft_frames on (slots, m) complex with the table tw of
    2m points: per stage, butterfly j loads z[j + r m/R], twiddles by
    tw[2 (j mod ns) r m/(ns R)] (conjugated for the inverse), takes the
    R-point DFT and stores at (j - j mod ns) R + j mod ns + r ns; j mod ns
    through Div. A large radix takes ``_stage_large`` (a segment of fps
    slots, by default the slots given)."""
    m = z.shape[-1]
    ns = 1
    for R in _radices(m):
        if R in LARGE_RADICES:
            z = _stage_large(z, tw, R, ns, inverse, fps or z.shape[0])
            ns *= R
            continue
        mr = m // R
        j = np.arange(mr)
        jm = j - _div(j, ns) * ns
        w = tw[2 * jm[:, None] * np.arange(R)[None, :] * (m // (ns * R))]
        v = np.stack([z[:, j + r * mr] for r in range(R)], axis=-1) * (np.conj(w) if inverse else w)
        v = _dft_r(v, inverse)
        d = (j - jm) * R + jm
        out = np.empty_like(z)
        for r in range(R):
            out[:, d + r * ns] = v[..., r]
        z = out
        ns *= R
    return z


def _segments(geo, n_slots, route=None):
    """fft_smem.cuh::segment and seg_frames: (first slot, slots) of each
    thread segment of a block among its first n_slots, the idle warps past
    the last whole segment included (they own none); a slot past FFT_ELEMS
    points takes a big block."""
    slot, warps, _ = geo.fft_layout(route)
    block_warps = FFT_BIG_WARPS if slot > FFT_ELEMS else FFT_WARPS
    fps = warps * FFT_WARP_POINTS // slot
    out = []
    for sid in range(-(-block_warps // warps)):
        whole = sid < block_warps // warps
        f0 = sid * fps
        out.append((f0, min(max(n_slots - f0, 0), fps) if whole else 0))
    return out


def _split(zk, zm, w):
    """spectra_fft.cu::split: E = (Z[k] + conj Z[M-k]) / 2, O = -i (Z[k] -
    conj Z[M-k]) / 2; X[k] = E + w O, X[M-k] = conj(E - w O)."""
    e, o = 0.5 * (zk + np.conj(zm)), -0.5j * (zk - np.conj(zm))
    return e + w * o, np.conj(e - w * o)


def _unsplit(yk, ym, w):
    """istft_fft.cu::unsplit: S = Y[k] + conj Y[M-k], t = i conj(w) (Y[k] -
    conj Y[M-k]); Z'[k] = (S + t) / 2, Z'[M-k] = conj(S - t) / 2."""
    s, t = yk + np.conj(ym), 1j * np.conj(w) * (yk - np.conj(ym))
    return 0.5 * (s + t), np.conj(0.5 * (s - t))


def _tiles(x, geo, cs, pad):
    """The frame-tile loader of kernel A (both kernels): per view b and
    tile of fft_tile_frames frames from t0, the tile's windowed frames
    (fe, n_fft), zero past the window, from the zero-filled signal span."""
    rows, n = x.shape
    k_chunks = n_chunks_for(n, cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    T, hop, win, tile = geo.n_frames, geo.hop, geo.win, geo.fft_tile_frames
    ws = K._scaled_window_np(geo.scfg)
    for b in range(rows * k_chunks):
        h, c = divmod(b, k_chunks)
        for t0 in range(0, T, tile):
            fe = min(tile, T - t0)
            p = t0 * hop - geo.bpad + np.arange((fe - 1) * hop + win)
            s = c * stride + start + p
            ok = (p >= 0) & (p < geo.view_len) & (s >= 0) & (s < n)
            span = np.where(ok, x[h, np.clip(s, 0, n - 1)], 0.0)
            u = np.zeros((fe, geo.n_fft))  # the tile's windowed frames, zero past win
            u[:, :win] = ws * span[np.arange(fe)[:, None] * hop + np.arange(win)]
            yield b, t0, u


def _emulate_spectra_fft(x, geo, cs=0, pad=0, fit=7):
    """csrc/spectra_fft.cu: ``fit`` persistent blocks walk the tiles of
    fft_tile_frames frames of each view (``_block_walk``), each tile's
    zero-filled signal span copied as issue_span copies it (``_issue_span``,
    rows at byte address 0); per thread segment, its windowed frames packed
    from the span as M = N/2 complex points, the FFT (its stages out of
    place: the same stages), and the split into the real spectrum, (M + 1)
    / 2 slots a frame."""
    N, M, nb = geo.n_fft, geo.n_fft // 2, geo.n_bins
    hop, win = geo.hop, geo.win
    tw = _twiddles(N)
    ws = K._scaled_window_np(geo.scfg)
    half = (M + 1) // 2
    n_chunks = n_chunks_for(x.shape[1], cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    n_tiles = -(-geo.n_frames // geo.fft_tile_frames)
    re = np.zeros((x.shape[0] * n_chunks, geo.n_frames, nb))
    im = np.zeros_like(re)
    for tiles in _block_walk(re.shape[0] * n_tiles, fit):
        for tile in tiles:
            b, t0, fe, length, p0, s0 = _tile_of(tile, geo, n_tiles, n_chunks, stride, start)
            buf, ph, _ = _issue_span(x[b // n_chunks], s0, p0, length, geo.view_len, 0, 4)
            span = buf[ph : ph + length]
            u = np.zeros((fe, N))  # the tile's windowed frames, zero past win
            u[:, :win] = ws * span[np.arange(fe)[:, None] * hop + np.arange(win)]
            for f0, nf in _segments(geo, fe):
                e = np.arange(nf * M)  # the segment's points, packed
                fl = _div(e, M)
                f, q = f0 + fl, 2 * (e - fl * M)
                Z = _stockham((u[f, q] + 1j * u[f, q + 1]).reshape(nf, M), tw, False).reshape(-1)
                e = np.arange(nf * half)
                fl = _div(e, half)
                k = e - fl * half
                base = fl * M
                lo, hi = _split(Z[base + k], Z[base + np.where(k > 0, M - k, 0)], tw[k])
                X = np.zeros((nf, nb), complex)
                X[fl, k], X[fl, M - k] = lo, hi
                if M % 2 == 0:  # slot 0 also gives the middle bin
                    mid = base[k == 0] + M // 2
                    X[fl[k == 0], M // 2] = _split(Z[mid], Z[mid], tw[M // 2])[0]
                rows = slice(t0 + f0, t0 + f0 + nf)
                re[b, rows], im[b, rows] = X.real, X.imag
    return re, im


def _chirp(geo, slot):
    """The chirp route's host tables as complex: cbar_j (n,) and the filter
    spectrum (slot,)."""
    n = geo.fft_n
    return _complex(K._chirp_np(n)), _complex(K._chirp_filter_np((n, slot)))


def _cplx_tables(geo):
    """The tables of the complex-frame kernel A for the geometry: the core's
    twiddles of 2 slot points, the split's of n_fft, and on the chirp route
    cbar_j and the filter spectrum (else None)."""
    slot = geo.fft_layout()[0]
    cb, filt = _chirp(geo, slot) if geo.route == "chirp" else (None, None)
    return _twiddles(2 * slot), _twiddles(geo.n_fft), cb, filt


def _cplx_transform_unpack(z, geo, tabs, b, t0, fe, re, im):
    """spectra_cplx.cu's transform and unpack of a segment's nf slots z
    (nf, T), the tile's frames t0 + fps f from view b (fe frames in the
    tile, counted from the segment's first), into re / im: the T-point FFT;
    on the chirp route times the filter spectrum and the unscaled inverse;
    then per point pair (k, n - k) (Div by (n + 1) / 2), times cbar on the
    chirp route, the pair's two frames (X_a = (Z[k] + conj Z[n-k]) / 2,
    X_b = -i (Z[k] - conj Z[n-k]) / 2) or the split. A segment's large
    stages take its fps slots' scratch rows (``_stage_large``)."""
    slot, warps, _ = geo.fft_layout()
    seg_slots = warps * FFT_WARP_POINTS // slot
    tw, tws, cb, filt = tabs
    chirp = cb is not None
    n, paired = geo.fft_n, geo.fft_paired
    fps = 2 if paired else 1
    half = (n + 1) // 2
    Z = _stockham(z, tw, False, seg_slots)
    if chirp:
        Z = _stockham(Z * filt, tw, True)
    e = np.arange(len(z) * half)
    sl = _div(e, half)
    k = e - sl * half
    km = np.where(k > 0, n - k, 0)
    zk, zm = Z[sl, k], Z[sl, km]
    if chirp:
        zk, zm = zk * cb[k], zm * cb[km]
    t = t0 + fps * sl
    if paired:
        re[b, t, k], im[b, t, k] = (0.5 * (zk + np.conj(zm))).real, (0.5 * (zk + np.conj(zm))).imag
        xb = -0.5j * (zk - np.conj(zm))
        ok = fps * sl + 1 < fe
        re[b, t[ok] + 1, k[ok]], im[b, t[ok] + 1, k[ok]] = xb.real[ok], xb.imag[ok]
    else:
        lo, hi = _split(zk, zm, tws[k])
        re[b, t, k], im[b, t, k] = lo.real, lo.imag
        re[b, t, n - k], im[b, t, n - k] = hi.real, hi.imag
        if n % 2 == 0:  # k = 0 also gives the middle bin
            zh = Z[sl[k == 0], n // 2] * (cb[n // 2] if chirp else 1.0)
            mid = _split(zh, zh, tws[n // 2])[0]
            re[b, t[k == 0], n // 2], im[b, t[k == 0], n // 2] = mid.real, mid.imag


def _emulate_spectra_cplx(x, geo, cs=0, pad=0):
    """csrc/spectra_cplx.cu: the tiles of kernel A; per thread segment, its
    slots of T points: an even n_fft's frame packed as z[q] = u[2q] + i
    u[2q+1] (n = M), an odd one's frame pair as z[j] = u_a[j] + i u_b[j]
    (n = N, a zero frame b past the tile's last); on the chirp route times
    cbar_j and zero past n; then ``_cplx_transform_unpack``."""
    slot = geo.fft_layout()[0]
    n, nb, paired = geo.fft_n, geo.n_bins, geo.fft_paired
    fps = 2 if paired else 1
    tabs = _cplx_tables(geo)
    cb = tabs[2]
    B = x.shape[0] * (n_chunks_for(x.shape[1], cs) if cs else 1)
    re = np.zeros((B, geo.n_frames, nb))
    im = np.zeros_like(re)
    for b, t0, u in _tiles(x, geo, cs, pad):
        fe = len(u)
        for f0, nf in _segments(geo, -(-fe // fps)):
            if not nf:
                continue
            z = np.zeros((nf, slot), complex)
            for sl in range(nf):
                f = fps * (f0 + sl)
                if paired:
                    z[sl, :n] = u[f] + 1j * (u[f + 1] if f + 1 < fe else 0.0)
                else:
                    z[sl, :n] = u[f, 0::2] + 1j * u[f, 1::2]
            if cb is not None:
                z[:, :n] *= cb
            _cplx_transform_unpack(z, geo, tabs, b, t0 + fps * f0, fe - fps * f0, re, im)
    return re, im


def _big_block_pack(x, geo, tile, n_tiles, n_chunks, stride, start):
    """spectra_cplx.cu's pack in a big block (one slot a tile): each point
    q of the slot from the frame's samples read straight from the plane
    behind the span's guards (tile_span.cuh::span_bounds: span sample i is
    row sample s0 + i for lo <= i < hi, else zero) and the window by index:
    z[q] = w[2q] x(2q) + i w[2q+1] x(2q+1) (an even n_fft), or w[q] (x_a(q)
    + i x_b(q)) for the slot's frames a and b = a + 1 (zero past the
    tile's last); zero past n and the window; times cbar_q on the chirp
    route. Returns (view, first frame, frames, z)."""
    slot = geo.fft_layout()[0]
    n, win, hop = geo.fft_n, geo.win, geo.hop
    b, t0, fe, length, p0, s0 = _tile_of(tile, geo, n_tiles, n_chunks, stride, start)
    row = x[b // n_chunks]
    lo = min(length, max(0, -p0, -s0))
    hi = max(lo, min(length, geo.view_len - p0, len(row) - s0))
    ws = K._scaled_window_np(geo.scfg)

    def smp(i):
        ok = (i >= lo) & (i < hi)
        return np.where(ok, row[np.clip(s0 + i, 0, len(row) - 1)], 0.0)

    def wnd(i):
        return np.where(i < win, ws[np.minimum(i, win - 1)], 0.0)

    q = np.arange(slot)
    if geo.fft_paired:
        ua = np.where(q < win, wnd(q) * smp(q), 0.0)
        ub = np.where(q < win, wnd(q) * smp(hop + q), 0.0) if fe > 1 else 0.0
        z = ua + 1j * ub
    else:
        u = 2 * q
        z = (np.where(u < win, wnd(u) * smp(u), 0.0)
             + 1j * np.where(u + 1 < win, wnd(u + 1) * smp(u + 1), 0.0))
    z = np.where(q < n, z, 0.0)
    if geo.route == "chirp":
        z[:n] *= _cplx_tables(geo)[2]
    return b, t0, fe, z


def _emulate_spectra(x, geo, cs=0, pad=0):
    """Kernel A on the geometry's route: the real-FFT or the complex-frame
    kernel."""
    assert geo.route in ("fft", "chirp")
    emulate = _emulate_spectra_fft if geo.fft_real else _emulate_spectra_cplx
    return emulate(x, geo, cs, pad)


def _ola(re, im, mask, geo, out_off, out_len, run, invert):
    """Kernel D's runs (both kernels): per run of output hop blocks, the
    covering frames (the run plus r - 1 halo frames; from an even frame
    for an odd n_fft, two frames a slot) in groups of fft_tile_frames;
    ``invert(b, tg, ge)`` gives the group's time frames (ge, N), unscaled;
    each sample sums its frames' post[u] y_t[u] in ascending t; then the
    envelope (the host table where all r frames exist, else summed) and
    the trim."""
    B, T, nb = re.shape
    hop, r, win = geo.hop, geo.r, geo.win
    G, run = geo.fft_tile_frames, run or geo.fft_run
    post = K._post_window_np(geo.scfg)
    j0, n_out = geo.out_blocks(out_off, out_len)
    out = np.zeros((B, out_len))
    for b in range(B):
        for ja in range(j0, j0 + n_out, run):
            je = min(run, j0 + n_out - ja)
            acc = np.zeros(je * hop)
            t_lo, t_hi = max(0, ja - r + 1), min(T - 1, ja + je - 1)
            t_lo -= t_lo % (2 if geo.fft_paired else 1)
            for tg in range(t_lo, t_hi + 1, G):
                ge = min(G, t_hi - tg + 1)
                y = invert(b, tg, ge)
                for i in range(ge):
                    l = (tg + i - ja) * hop + np.arange(win)
                    keep = (l >= 0) & (l < je * hop)
                    acc[l[keep]] += post[keep] * y[i, :win][keep]
            l = np.arange(je * hop)
            _finish(out, b, ja + l // hop, l % hop, acc, geo, T, out_off)
    return out


def _finish(out, b, jj, q, a, geo, T, out_off, written=None):
    """Kernel D's last step for samples q of hop blocks jj of row b with
    overlap-add sums a: divided by the envelope (the host table where all
    r frames exist, else the window's squares of the frames that exist,
    in ascending t and the table's dtype), zero past the istft length,
    written to out where they fall in the trimmed window (and counted in
    ``written``, where given)."""
    hop, r = geo.hop, geo.r
    wsq, env_int = K._window_squares_np(geo.scfg), K._interior_envelope_np(geo.scfg)
    s = jj * hop + q - geo.bpad
    env = np.zeros(len(jj), wsq.dtype)
    for i in reversed(range(r)):
        env += ((jj - i >= 0) & (jj - i < T)) * wsq[i * hop + q]
    env = np.where((jj - r + 1 >= 0) & (jj < T), env_int[q], env)
    y = np.where(s < geo.istft_len, a / np.where(env > geo.env_floor, env, 1.0), 0.0)
    o = s - out_off
    keep = (o >= 0) & (o < out.shape[1])
    out[b, o[keep]] = y[keep]
    if written is not None:
        np.add.at(written[b], o[keep], 1)


def _ola_ring(re, im, mask, geo, out_off, out_len, run, invert):
    """csrc/istft_fft.cu's and csrc/istft_cplx.cu's runs: per run of output
    hop blocks, the covering frames (the run plus r - 1 halo frames, from
    an even frame for an odd n_fft, two frames a slot) in groups of
    fft_tile_frames (``invert(b, tg, ge)``: the group's time frames); a
    ring of NB = G + r - 1 hop blocks of sums, block jj in slot jj mod NB
    (the slot by the Div of the hop; for an even hop a thread takes a pair
    of samples in one block), each sample adding its frames' post[u]
    y_t[u] in ascending t; after each group the blocks below tg +
    G (all of them after the run's last group) leave the ring: a sample of
    the run finished (``_finish``), the slot zeroed. A run that no frame
    reaches finishes sums of 0, and so do a run's blocks past the ring of
    its last group tl, from tl + NB on, where the run reaches past its
    last frame's reach. The output starts as NaN: every sample of the
    window is written exactly once."""
    B, T, _ = re.shape
    hop, r, win = geo.hop, geo.r, geo.win
    G, run = geo.fft_tile_frames, run or geo.fft_run
    NB = G + r - 1
    post = K._post_window_np(geo.scfg)
    j0, n_out = geo.out_blocks(out_off, out_len)
    out = np.full((B, out_len), np.nan)
    written = np.zeros(out.shape, int)
    i = np.arange(NB * hop)
    slot = _div(i, hop)
    q = i - slot * hop
    if hop % 2 == 0:  # the kernel's pairs (2l, 2l + 1) share a block, q even first
        assert np.array_equal(slot[0::2], slot[1::2]) and (q[0::2] % 2 == 0).all()
    for b in range(B):
        for ja in range(j0, j0 + n_out, run):
            je = min(run, j0 + n_out - ja)
            t_lo, t_hi = max(0, ja - r + 1), min(T - 1, ja + je - 1)
            t_lo -= t_lo % (2 if geo.fft_paired else 1)
            if t_lo > t_hi:
                l = np.arange(je * hop)
                _finish(out, b, ja + l // hop, l % hop, np.zeros(len(l)), geo, T, out_off,
                        written)
                continue
            acc = np.zeros(NB * hop)
            for tg in range(t_lo, t_hi + 1, G):
                ge = min(G, t_hi - tg + 1)
                y = invert(b, tg, ge)
                jj = tg + slot - tg % NB + np.where(slot < tg % NB, NB, 0)
                assert (np.sort(jj) == np.repeat(tg + np.arange(NB), hop)).all()
                for t in range(tg, tg + ge):  # ascending t
                    u = (jj - t) * hop + q
                    ok = (u >= 0) & (u < win)
                    acc[ok] += post[u[ok]] * y[t - tg, u[ok]]
                leave = np.full(len(i), tg + G > t_hi) | (jj < tg + G)
                fin = leave & (jj >= ja) & (jj < ja + je)
                _finish(out, b, jj[fin], q[fin], acc[fin], geo, T, out_off, written)
                acc[leave] = 0.0
            if t_hi + r < ja + je:  # past the last frame's reach
                tl = t_lo + (t_hi - t_lo) // G * G
                l = np.arange((tl + NB - ja) * hop, je * hop)
                _finish(out, b, ja + l // hop, l % hop, np.zeros(len(l)), geo, T, out_off,
                        written)
    assert (written == 1).all()
    return out


def _slab(plane, b, tg, ge, addr0=0):
    """istft_fft.cu's slab of one plane: frames [tg, tg + ge) of row b, a
    contiguous run of ge x n_bins values copied as issue_copy copies it
    (``_issue_copy``; float32 elements, the plane at byte address addr0):
    value f n_bins + q is bin q of frame tg + f."""
    T, nb = plane.shape[-2:]
    length = ge * nb
    buf, ph, _ = _issue_copy(plane.reshape(-1), (b * T + tg) * nb, 0, length, length, addr0, 4)
    return buf[ph : ph + length]


def _pre_step_from_slab(sre, sim, smk, geo, f0, nf):
    """istft_fft.cu's pre-step of a segment's frames [f0, f0 + nf) of a
    group, straight from its slab: slot e (< nf (M + 1) / 2) is frame f =
    f0 + e / ((M + 1) / 2) (the plan's Div) and pair k; it reads Y at bins
    k and M - k (slot 0: 0 and M, and M/2 for an even M) of the slab's row
    f n_bins, no imaginary DC or Nyquist part: Z' (nf, M)."""
    nb, M = geo.n_bins, geo.n_fft // 2
    tw = _twiddles(geo.n_fft)
    half = (M + 1) // 2
    e = np.arange(nf * half)
    fl = _div(e, half)
    k = e - fl * half
    row = (f0 + fl) * nb

    def Y(q, row=row):
        return (sre[row + q] + 1j * sim[row + q] * ((q > 0) & (q < M))) * smk[row + q]

    z = np.full(nf * M, np.nan, complex)
    lo, hi = _unsplit(Y(k), Y(np.where(k > 0, M - k, M)), tw[k])
    z[fl * M + k] = lo
    z[(fl * M + M - k)[k > 0]] = hi[k > 0]
    if M % 2 == 0:  # slot 0 also turns the middle point
        yh = Y(np.full((k == 0).sum(), M // 2), row[k == 0])
        z[fl[k == 0] * M + M // 2] = _unsplit(yh, yh, tw[M // 2])[0]
    assert not np.isnan(z).any()
    return z.reshape(nf, M)


def _emulate_istft_fft(re, im, mask, geo, out_off, out_len, run=None):
    """csrc/istft_fft.cu: per group, its slab of re, im and the mask
    (``_slab``); per thread segment, the pre-step from the slab
    (``_pre_step_from_slab``) and the unscaled inverse FFT; the runs and
    ring of ``_ola_ring`` (``geo.fft_run``: whole groups)."""
    tw = _twiddles(geo.n_fft)

    def invert(b, tg, ge):
        sre, sim, smk = (_slab(a, b, tg, ge) for a in (re, im, mask))
        y = np.zeros((ge, geo.n_fft))
        for f0, nf in _segments(geo, ge):
            if nf:
                zz = _stockham(_pre_step_from_slab(sre, sim, smk, geo, f0, nf), tw, True)
                y[f0 : f0 + nf, 0::2], y[f0 : f0 + nf, 1::2] = zz.real, zz.imag
        return y

    return _ola_ring(re, im, mask, geo, out_off, out_len, run, invert)


def _cplx_group_frames(geo, tg, ge):
    """The frames istft_cplx.cu's pre-step reads for group [tg, tg + ge):
    its frames, and for an odd n_fft the partner of an odd group's last
    frame where it exists (frames [tg, tg + 2 ceil(ge / 2)) within the
    row)."""
    fps = 2 if geo.fft_paired else 1
    return min(fps * -(-ge // fps), geo.n_frames - tg)


def _cplx_pre_step(sre, sim, smk, geo, f0, nf, slot, chirp=None):
    """istft_cplx.cu's pre-step of a segment's slots [f0, f0 + nf) of a
    group from the planes (bin q of the group's frame f at f n_bins + q of
    the group's frames, ``_cplx_group_frames``): an even n_fft's slot e <
    nf (n + 1) / 2 (the Div by (n + 1) / 2)
    unsplits the pair (k, n - k) (0 with Y[n], and n/2 for an even n); an
    odd one's slot bin e < nf n_bins (the Div by n_bins) gives W[k] and
    W[n - k] from bin k of frames 2 sl and 2 sl + 1 (a zero frame past
    the slab's last); times c_k (conj cbar_k) and zero past n on the
    chirp route: (nf, slot) points."""
    N, n, nb = geo.n_fft, geo.fft_n, geo.n_bins
    tws = _twiddles(N)
    frames = len(smk) // nb

    def Y(f, q):  # Y = Z * mask, no imaginary DC or Nyquist part
        o = f * nb + q
        return (sre[o] + 1j * sim[o] * ((q > 0) & (q < N / 2))) * smk[o]

    z = np.full((nf, slot), np.nan, complex)
    z[:, n:] = 0.0
    if geo.fft_paired:
        e = np.arange(nf * nb)
        sl = _div(e, nb)
        k = e - sl * nb
        fa = 2 * (f0 + sl)
        ya = Y(fa, k)
        yb = np.where(fa + 1 < frames, Y(np.minimum(fa + 1, frames - 1), k), 0.0)
        z[sl, k] = ya + 1j * yb
        z[sl[k > 0], n - k[k > 0]] = np.conj(ya[k > 0]) + 1j * np.conj(yb[k > 0])
    else:
        half = (n + 1) // 2
        e = np.arange(nf * half)
        sl = _div(e, half)
        k = e - sl * half
        f = f0 + sl
        lo, hi = _unsplit(Y(f, k), Y(f, np.where(k > 0, n - k, n)), tws[k])
        z[sl, k] = lo
        z[sl[k > 0], n - k[k > 0]] = hi[k > 0]
        if n % 2 == 0:
            yh = Y(f[k == 0], np.full((k == 0).sum(), n // 2))
            z[sl[k == 0], n // 2] = _unsplit(yh, yh, tws[n // 2])[0]
    assert not np.isnan(z).any()
    if chirp is not None:
        z[:, :n] *= np.conj(chirp)
    return z


def _emulate_istft_cplx(re, im, mask, geo, out_off, out_len, run=None, fit=3):
    """csrc/istft_cplx.cu: per group (from an even frame for an odd n_fft,
    two frames a slot) and thread segment, the pre-step from the group's
    frames of re, im and the mask (``_cplx_group_frames``,
    ``_cplx_pre_step``); on the chirp route the T-point FFT,
    times the conjugate filter spectrum, the unscaled inverse and c_j on
    the first n points; else the unscaled n-point inverse; the runs and
    ring of ``_ola_ring``, or for a big block (``geo.cplx_two_pass``) the
    window's frames in groups walked by ``fit`` blocks
    (``_cplx_two_pass_walk``), each written once to the (rows, frames, win)
    scratch, then the overlap-add pass (``_cluster_ola``)."""
    slot, warps, _ = geo.fft_layout()
    seg_slots = warps * FFT_WARP_POINTS // slot
    chirp = geo.route == "chirp"
    N, n, paired = geo.n_fft, geo.fft_n, geo.fft_paired
    fps = 2 if paired else 1
    tw = _twiddles(2 * slot)
    cb, filt = _chirp(geo, slot) if chirp else (None, None)

    def invert(b, tg, ge):
        fe = _cplx_group_frames(geo, tg, ge)
        sre, sim, smk = (a[b, tg : tg + fe].reshape(-1) for a in (re, im, mask))
        y = np.zeros((ge, N))
        for f0, nf in _segments(geo, -(-ge // fps)):
            if not nf:
                continue
            z = _cplx_pre_step(sre, sim, smk, geo, f0, nf, slot, cb)
            if chirp:
                Z = _stockham(_stockham(z, tw, False) * np.conj(filt), tw, True)
                Z[:, :n] *= np.conj(cb)
            else:
                Z = _stockham(z, tw, True, seg_slots)
            for sl in range(nf):
                f = fps * (f0 + sl)
                if paired:
                    y[f] = Z[sl, :n].real
                    if f + 1 < ge:
                        y[f + 1] = Z[sl, :n].imag
                else:
                    y[f, 0::2], y[f, 1::2] = Z[sl, :n].real, Z[sl, :n].imag
        return y

    if not geo.cplx_two_pass:
        return _ola_ring(re, im, mask, geo, out_off, out_len, run, invert)
    B, T = re.shape[:2]
    walk, t_lo, n_fr = _cplx_two_pass_walk(geo, B, out_off, out_len, fit)
    y = np.full((B, n_fr, geo.win), np.nan)
    written = np.zeros(y.shape, int)
    for b, tg, ge in (g for groups in walk for g in groups):
        y[b, tg - t_lo : tg - t_lo + ge] = invert(b, tg, ge)[:, : geo.win]
        written[b, tg - t_lo : tg - t_lo + ge] += 1
    assert (written == 1).all()
    j0, n_out = geo.out_blocks(out_off, out_len)
    return _cluster_ola(y, geo, B, T, j0, n_out, t_lo, n_fr, out_off, out_len)


def _cplx_two_pass_walk(geo, rows, out_off, out_len, fit):
    """istft_cplx.cu's first pass on a big block: the frames t_lo to t_lo
    + n_fr - 1 of each row (``cluster_frames``) in items of G frames (item
    i of row b: frames from t_lo + i G, ceil(n_fr / G) items a row),
    min(items, fit) persistent blocks, block x taking items x, x + grid,
    ...: (per block its groups (b, tg, ge) in order, t_lo, n_fr)."""
    G = geo.fft_tile_frames
    t_lo, n_fr = geo.cluster_frames(*geo.out_blocks(out_off, out_len))
    n_items = -(-n_fr // G)
    total = rows * n_items
    walk = []
    for x in range(min(total, fit)):
        groups = []
        for item in range(x, total, min(total, fit)):
            b, i = divmod(item, n_items)
            tg = t_lo + i * G
            groups.append((b, tg, min(t_lo + n_fr, tg + G) - tg))
        walk.append(groups)
    return walk, t_lo, n_fr


def _pre_step(Y, nyq, tws):
    """The unsplit of one frame, Y (M,) and Y[M]: Z' (M,)."""
    M = len(Y)
    z = Y.copy()
    k = np.arange((M + 1) // 2)
    ym = np.where(k == 0, nyq, z[np.where(k > 0, M - k, 0)])
    lo, hi = _unsplit(z[k], ym, tws[k])
    z[k], z[M - k[1:]] = lo, hi[1:]
    if M % 2 == 0:
        z[M // 2] = _unsplit(z[M // 2], z[M // 2], tws[M // 2])[0]
    return z


def _emulate_istft(re, im, mask, geo, out_off, out_len, run=None):
    """Kernel D on the geometry's route: the real-FFT or the complex-frame
    kernel."""
    assert geo.route in ("fft", "chirp")
    emulate = _emulate_istft_fft if geo.fft_real else _emulate_istft_cplx
    return emulate(re, im, mask, geo, out_off, out_len, run)


def _route_sizes():
    """Every n_fft the FFT and chirp routes serve (to 16383: n within a big
    block; from 1)."""
    sizes = range(1, 2 * FFT_BIG_ELEMS + 1)
    return [n for n in sizes if fft_route(StftConfig(n_fft=n)) in ("fft", "chirp")]


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096, 8192,
                                   96, 400, 480, 882, 1200, 1536, 1100, 1040, 286])
def test_stockham_stages_are_the_dft(n_fft):
    """The stage order, the sources' R-point formulas, the autosort indices
    and the host twiddle table give the FFT and its unscaled inverse, for
    power-of-two and mixed-radix halves M (48, 200, 240, 441, 600, 768; 550
    with radix 11, 520 with 13, 143 with both)."""
    m = n_fft // 2
    rng = np.random.default_rng(n_fft)
    z = rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
    tw = _twiddles(n_fft)
    _close(_stockham(z, tw, False), np.fft.fft(z, axis=-1))
    _close(_stockham(z, tw, True), m * np.fft.ifft(z, axis=-1))
    assert np.prod(_radices(m)) == m


@pytest.mark.parametrize("m", [441, 1323, 4851, 1001, 2197, 1120, 2205, 1152, 2304, 8192,
                               6561, 551, 493, 544, 713, 609, 1235, 3596, 3844, 3757, 3990,
                               4096 - 4096 % 31])
def test_stockham_stages_of_any_slot_are_the_dft(m):
    """The same for the complex-frame kernels' slots: an odd n_fft's N
    points (441, 1323, 4851 = 3^2 7^2 11 past a block, 1001 = 7 11 13,
    2197 = 13^3) and chirp lengths (1120 = 2^5 5 7, 2205 = 3^2 5 7^2, 1152
    = 2^7 3^2, 2304, 8192; 6561 = 3^8), each with the table of 2m points;
    and 31-smooth slots within a block, whose large radices take
    stage_large (551 = 19 29, 493 = 17 29, 544 = 2^5 17, 713 = 23 31, 609
    = 3 7 29, 1235 = 5 13 19, 3596 = 2^2 29 31, 3844 = 2^2 31^2, 3757 = 13
    17^2, 3990 = 2 3 5 7 19, 4092 = 2^2 3 11 31), also as a segment of more
    slots than it holds frames (its scratch rows past them unused)."""
    rng = np.random.default_rng(m)
    z = rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))
    tw = _twiddles(2 * m)
    _close(_stockham(z, tw, False), np.fft.fft(z, axis=-1))
    _close(_stockham(z, tw, True), m * np.fft.ifft(z, axis=-1))
    assert np.prod(_radices(m)) == m and len(_radices(m)) <= 12
    if any(m % r == 0 for r in LARGE_RADICES):
        _close(_stockham(z, tw, False, fps=3), np.fft.fft(z, axis=-1))


@pytest.mark.parametrize("radix", [2, 3, 4, 5, 7, 8, 11, 13, 17, 19, 23, 29, 31])
def test_radix_formulas_are_the_dft(radix):
    """fft_smem.cuh's R-point DFTs, forward and inverse."""
    v = np.random.default_rng(radix).standard_normal((4, radix, 2)) @ [1, 1j]
    n = np.arange(radix)
    for inverse, sign in ((False, -1), (True, 1)):
        want = v @ np.exp(sign * 2j * np.pi * np.outer(n, n) / radix)
        _close(_dft_r(v, inverse), want, 1e-14)


def test_radix_11_and_13_constants_are_the_sources():
    """dft_odd's float32 tables in fft_smem.cuh are cos and sin(2 pi j / R)
    rounded from float64."""
    src = (build.CSRC / "fft_smem.cuh").read_text()
    for R in (11, 13):
        body = src[src.index(f"if constexpr (R == {R})" if R == 11 else "static_assert(R == 13"):]
        for name, fn in (("c", np.cos), ("s", np.sin)):
            decl = body.index(f"constexpr float {name}[{R}] = {{")
            text = body[decl : body.index("};", decl)].split("{", 1)[1]
            vals = np.array([float(v.strip().rstrip("f")) for v in text.split(",")])
            want = fn(2 * np.pi * np.arange(R) / R).astype(np.float32)
            assert np.array_equal(vals.astype(np.float32), want), (R, name)


def test_large_radix_scratch_stays_in_its_segment():
    """A segment's stages run while the block's other segments run theirs,
    so on every geometry with a large radix each segment's
    ``stage_large`` scratch rows (its nb = fps m/R butterflies' R rows,
    contiguous from pad(base0) of the other buffer) lie within the span of
    that segment's own padded points, where its out-of-place stages
    (``stage_oop``) store, and so on no other segment's points."""
    for n_fft in _route_sizes():
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=n_fft), 4 * n_fft)
        m, warps, _ = geo.fft_layout()
        if not any(m % r == 0 for r in LARGE_RADICES):
            continue
        fps = warps * FFT_WARP_POINTS // m
        spans = []
        for f0, _nf in _segments(geo, FFT_ELEMS):
            if not _nf:
                continue
            first, last = f0 * m, (f0 + fps) * m - 1  # the segment's points
            lo, hi = first + first // 16, last + last // 16  # their padded span
            for R in set(_radices(m)) & set(LARGE_RADICES):
                assert lo + R * fps * (m // R) - 1 <= hi, n_fft  # rows from pad(base0)
            spans.append((lo, hi))
        spans.sort()
        assert all(a[1] < b[0] for a, b in zip(spans, spans[1:])), n_fft


@pytest.mark.parametrize("radix", LARGE_RADICES)
def test_large_radix_roots_are_the_twiddle_table(radix):
    """stage_large's roots (c_q, -s_q) are the twiddle table's tw[q 2m/R]
    for every slot m it serves: that table is built in float64 on the host
    and rounded once to float32 on the card, and each such entry, so
    rounded, is cos and sin(2 pi q / R) rounded from float64, whatever m;
    so every slot with radix R computes with the same float32 roots, those
    a constant table would hold."""
    want = np.exp(-2j * np.pi * np.arange(radix) / radix)
    want32 = np.stack([want.real, want.imag], -1).astype(np.float32)
    slots = [m for m in range(radix, FFT_ELEMS + 1, radix)
             if _strip(m, (2, 3, 5, 7, 11, 13) + LARGE_RADICES) == 1]
    assert slots
    for m in slots:
        tab32 = K._twiddle_np(2 * m).astype(np.float32)
        assert np.array_equal(tab32[np.arange(radix) * (2 * m // radix)], want32), m


def _stage_divisors(m):
    """The Divs of an m-point plan's stages: m / R and ns of each."""
    out, ns = set(), 1
    for r in _radices(m):
        out.update((m // r, ns))
        ns *= r
    return out


def test_multiply_high_division_is_exact():
    """Div's x / d is exact for every divisor the kernels use and every x
    past every index they divide: on the FFT and chirp routes (the slot m,
    (m + 1) / 2, m / R and ns of each stage, for every n_fft they serve; a
    frame's pairs (n + 1) / 2 and bins, 5006 at n_fft 10010; a segment's
    warps and slots, the latter stage_large's items' second divisor, whose
    items stay below 2^14) every x below 2^14; on the cluster route (n1, n2, a block's
    columns n1 / c and rows n2 / c, the stages of the n1- and n2-point
    FFTs, for every n_fft to 131072 it serves; on the cluster chirp route
    the same for every chirp length, and the runs of both of its pulls in
    their values, rows ldc and cols ldr, halved where even) every x below
    2^17, past a transform's n <= 2^16 points. Every plan fits
    fft_smem.cuh's MAX_STAGES (12)."""
    ds = set(range(1, FFT_BIG_WARPS + 1))
    for n_fft in _route_sizes():
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=n_fft), 4 * n_fft)
        m, warps, _ = geo.fft_layout()
        assert len(_radices(m)) <= 12
        fps = warps * FFT_WARP_POINTS // m  # stage_large's second Div
        ds.update((m, (m + 1) // 2, (geo.fft_n + 1) // 2, geo.n_bins, fps), _stage_divisors(m))
        for r in set(_radices(m)) & set(LARGE_RADICES):  # its items it < (R/2 + 1) fps m/R
            assert (r // 2 + 1) * fps * (m // r) < 2**14
    x = np.arange(2**14)
    for d in sorted(ds):
        assert d <= 2**14 and np.array_equal(_div(x, d), x // d), d
    dc = set()
    for n in range(FFT_ELEMS + 1, CLUSTER_MAX * FFT_BIG_ELEMS + 1):
        shape = cluster_shape(n)
        if shape and fft_route(StftConfig(n_fft=2 * n)) == "cluster":
            c, n1, n2 = shape
            assert len(_radices(n1)) <= 12 and len(_radices(n2)) <= 12
            dc.update((n1, n2, n1 // c, n2 // c, (n1 + 1) // 2, (n2 + 1) // 2),
                      _stage_divisors(n1), _stage_divisors(n2))
    for L in cluster_chirp_lengths():
        c, n1, n2 = cluster_shape(L)
        ldc, ldr, _ = cluster_layout(L)
        runs = [run // 2 if run % 2 == 0 else run for run in (n2 // c * ldc, n1 // c * ldr)]
        assert len(_radices(n1)) <= 12 and len(_radices(n2)) <= 12
        dc.update((n1, n2, n1 // c, n2 // c, *runs), _stage_divisors(n1), _stage_divisors(n2))
    x = np.arange(2**17)
    for d in sorted(dc - ds):
        assert d <= 2**13 and np.array_equal(_div(x, d), x // d), d


def test_twiddle_table_is_exact_at_quarter_turns():
    tw = K._twiddle_np(1024)
    assert tuple(tw[0]) == (1.0, 0.0) and tuple(tw[256]) == (0.0, -1.0)
    assert tuple(tw[512]) == (-1.0, 0.0) and tuple(tw[768]) == (0.0, 1.0)
    _close(tw[:, 0] + 1j * tw[:, 1], np.exp(-2j * np.pi * np.arange(1024) / 1024))


@pytest.mark.parametrize("n", [17, 551, 1101, 2053, 4093, 4801, 8193, 8470, 32767])
def test_chirp_z_is_the_dft(n):
    """The chirp routes' arithmetic: cbar_j times the points, the L-point
    FFT, times the host filter spectrum, the unscaled inverse, cbar_k:
    the n-point DFT (L = 2^a 3^b, or 8192 past a block; past a big block
    the cluster chirp lengths 9720, 16875, 17280 and 65536; 4093 at j^2 up
    to 2^24, 32767 up to 2^30). The chirp table's index is exact: cbar_j
    for j near n agrees with e^{-i pi j^2 / n} taken in exact integers."""
    L = chirp_length(n)
    assert L >= 2 * n - 1
    assert L == FFT_BIG_ELEMS or L <= FFT_ELEMS or L in cluster_chirp_lengths()
    cb, filt = _complex(K._chirp_np(n)), _complex(K._chirp_filter_np((n, L)))
    rng = np.random.default_rng(n)
    z = np.zeros((2, L), complex)
    z[:, :n] = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))) * cb
    tw = _twiddles(2 * L)
    got = _stockham(_stockham(z, tw, False) * filt, tw, True)[:, :n] * cb
    _close(got, np.fft.fft(z[:, :n] / cb, axis=-1), 1e-12)
    j = np.arange(n - 3, n)
    q = [(int(v) * int(v)) % (2 * n) for v in j]  # Python integers
    _close(cb[j], np.exp(-1j * np.pi * np.array(q) / n), 1e-15)


def _check_spectra(kw, chunked, emulate):
    x = np.random.default_rng(31).standard_normal((2, N_SRC))
    cs, pad = (CS, PAD) if chunked else (0, 0)
    geo = gate_geometry(StftConfig(**kw), CS + 2 * PAD if chunked else N_SRC)
    re, im = K.spectra_ref(torch.as_tensor(x), geo, cs, pad)
    ere, eim = emulate(x, geo, cs, pad)
    _close(ere, re.numpy())
    _close(eim, im.numpy())
    return geo


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
@pytest.mark.parametrize("kw", GEOMS.values(), ids=GEOMS.keys())
def test_spectra_fft_emulation_matches_plain_version(kw, chunked):
    geo = _check_spectra(kw, chunked, _emulate_spectra_fft)
    assert geo.route == "fft" and geo.fft_real


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
@pytest.mark.parametrize("kw", CPLX_GEOMS.values(), ids=CPLX_GEOMS.keys())
def test_spectra_cplx_emulation_matches_plain_version(kw, chunked):
    geo = _check_spectra(kw, chunked, _emulate_spectra_cplx)
    assert geo.route in ("fft", "chirp") and not geo.fft_real


@pytest.mark.parametrize("kw,length", [(dict(n_fft=2036, hop_length=509), 2048),
                                       (dict(n_fft=2035, hop_length=407), 4096)],
                         ids=["nfft2036-r4", "nfft2035-r5"])
def test_chirp_emulation_with_a_power_of_two_length(kw, length):
    """The chirp route where the smallest 2^a 3^b >= 2n - 1 is a power of
    two (n = 1018 = 2 x 509 and, odd, 2035 = 5 11 37), as the kernels'
    power-of-two builds within a block take it: kernels A and D alike
    (n = 1020 = 2^2 3 5 17 of n_fft 2040 took this case before the large
    radices moved it to the FFT route)."""
    geo = gate_geometry(StftConfig(**kw), N_SRC)
    assert geo.route == "chirp" and geo.fft_layout()[0] == length
    x = np.random.default_rng(36).standard_normal((1, N_SRC))
    re, im = K.spectra_ref(torch.as_tensor(x), geo)
    ere, eim = _emulate_spectra_cplx(x, geo)
    _close(ere, re.numpy())
    _close(eim, im.numpy())
    mask = np.random.default_rng(37).random(re.shape)
    ref = K.istft_ola_ref(re, im, torch.as_tensor(mask), geo, 0, N_SRC)
    _close(_emulate_istft_cplx(re.numpy(), im.numpy(), mask, geo, 0, N_SRC), ref.numpy())


def test_spectra_fft_emulation_of_a_short_noise_row():
    """One frame, most of its span outside the signal (TPU row 3's clip)."""
    x = np.random.default_rng(32).standard_normal((1, 100))
    geo = gate_geometry(StftConfig(), 100)
    re, im = K.spectra_ref(torch.as_tensor(x), geo)
    ere, eim = _emulate_spectra_fft(x, geo)
    assert ere.shape == (1, 1, 513)
    _close(ere, re.numpy())
    _close(eim, im.numpy())


@pytest.mark.parametrize("name", ["nfft1100-r4", "nfft441-r3", "nfft1102-r2", "nfft1101-r3"])
def test_spectra_cplx_emulation_of_a_short_noise_row(name):
    """The same on the complex-frame kernels: a row of 100 samples, one
    frame (an odd n_fft: a zero second frame in the slot) or two."""
    x = np.random.default_rng(32).standard_normal((1, 100))
    geo = gate_geometry(StftConfig(**CPLX_GEOMS[name]), 100)
    re, im = K.spectra_ref(torch.as_tensor(x), geo)
    ere, eim = _emulate_spectra_cplx(x, geo)
    assert ere.shape == (1, geo.n_frames, geo.n_bins) and geo.n_frames <= 2
    _close(ere, re.numpy())
    _close(eim, im.numpy())


# kernel A's big blocks: even 4106 (the chirp, L = 8192), 8580 and 10010,
# odd 5005 (two frames a slot)
SPECTRA_BIG_GEOMS = ["nfft4106-r2", "nfft8580-r4", "nfft5005-r5", "nfft10010-r5",
                     "torch-nfft8580-r4"]


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
@pytest.mark.parametrize("name", SPECTRA_BIG_GEOMS)
def test_spectra_cplx_big_block_pack_reads_the_plane(name, chunked):
    """Kernel A's big block packs its slot straight from the plane and the
    window by index, with no span or window in shared memory
    (``_big_block_pack``): each tile's slot is, exactly, the one the
    span's pack gives, and the spectra from those slots match
    ``_emulate_spectra_cplx`` and the plain version."""
    x = np.random.default_rng(43).standard_normal((2, N_SRC))
    cs, pad = (CS, PAD) if chunked else (0, 0)
    geo = gate_geometry(StftConfig(**CPLX_GEOMS[name]), CS + 2 * PAD if chunked else N_SRC)
    n, paired = geo.fft_n, geo.fft_paired
    assert geo.fft_layout()[0] > FFT_ELEMS and geo.fft_tile_frames == (2 if paired else 1)
    n_chunks = n_chunks_for(x.shape[1], cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    n_tiles = -(-geo.n_frames // geo.fft_tile_frames)
    tabs = _cplx_tables(geo)
    re = np.zeros((x.shape[0] * n_chunks, geo.n_frames, geo.n_bins))
    im = np.zeros_like(re)
    spans = _tiles(x, geo, cs, pad)  # the same tiles, in the same order
    for tile in range(re.shape[0] * n_tiles):
        b, t0, fe, z = _big_block_pack(x, geo, tile, n_tiles, n_chunks, stride, start)
        tb, tt, u = next(spans)
        assert (tb, tt, len(u)) == (b, t0, fe)
        ref = np.zeros_like(z)
        ref[:n] = (u[0] + 1j * (u[1] if fe > 1 else 0.0) if paired
                   else u[0, 0::2] + 1j * u[0, 1::2])
        if tabs[2] is not None:
            ref[:n] *= tabs[2]
        assert np.array_equal(z, ref), tile
        _cplx_transform_unpack(z[None], geo, tabs, b, t0, fe, re, im)
    pre, pim = K.spectra_ref(torch.as_tensor(x), geo, cs, pad)
    ere, eim = _emulate_spectra_cplx(x, geo, cs, pad)
    _close(re, ere)
    _close(im, eim)
    _close(re, pre.numpy())
    _close(im, pim.numpy())


@pytest.mark.parametrize("name", ["nfft1024-r4", "nfft1536-r4", "nfft1100-r4", "nfft441-r3",
                                  "nfft5005-r5", "nfft1102-r2", "nfft1101-r3",
                                  "nfft4106-r2", "nfft40-r4", "nfft2-r2", "nfft3-r3",
                                  "nfft37-r37"])
def test_silent_row_gives_exact_zeros(name):
    """A silent row gives exact zeros on every route: its spectra, and the
    inverse of zero spectra under any mask."""
    geo = gate_geometry(StftConfig(**{**GEOMS, **CPLX_GEOMS}[name]), N_SRC)
    x = np.zeros((1, N_SRC))
    re, im = _emulate_spectra(x, geo)
    assert not re.any() and not im.any()
    mask = np.random.default_rng(38).random(re.shape)
    assert not _emulate_istft(re, im, mask, geo, 0, N_SRC).any()


def _istft_window(window):
    return {"core": (PAD, CS), "whole": (0, CS + 2 * PAD), "middle": (3000, 1500),
            "past-end": (4500, 2000)}[window]


def _check_istft(kw, window, emulate):
    view = CS + 2 * PAD
    geo = gate_geometry(StftConfig(**kw), view)
    rng = np.random.default_rng(33)
    re, im = rng.standard_normal((2, 3, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    out_off, out_len = _istft_window(window)
    ref = K.istft_ola_ref(*(torch.as_tensor(a) for a in (re, im, mask)), geo, out_off, out_len)
    _close(emulate(re, im, mask, geo, out_off, out_len), ref.numpy())


@pytest.mark.parametrize("window", ["core", "whole", "middle", "past-end"])
@pytest.mark.parametrize("kw", GEOMS.values(), ids=GEOMS.keys())
def test_istft_fft_emulation_matches_plain_version(kw, window):
    _check_istft(kw, window, _emulate_istft_fft)


@pytest.mark.parametrize("window", ["core", "whole", "middle", "past-end"])
@pytest.mark.parametrize("kw", CPLX_GEOMS.values(), ids=CPLX_GEOMS.keys())
def test_istft_cplx_emulation_matches_plain_version(kw, window):
    _check_istft(kw, window, _emulate_istft_cplx)


@pytest.mark.parametrize("name", ["nfft1024-r4", "torch-nfft512-r2", "nfft1536-r4",
                                  "nfft512-r1", "nfft441-r3", "nfft1323-r3", "nfft1102-r2",
                                  "nfft1101-r3", "nfft40-r4", "nfft63-r3"])
def test_istft_fft_output_does_not_depend_on_the_run(name):
    """Each sample sums the same products in ascending frame order whatever
    run or group its frames land in: runs of 1, 3, fft_run (on the
    real-FFT kernel whole groups: 29 at hop 256; below 64 samples the
    groups' own length, 201 at n_fft 40, 127 at odd 63) and the complex-frame
    kernels' min(32, 8192 / hop) (the real-FFT kernel's before it) give the
    same bits; an odd n_fft's groups of an odd frame count pad their last
    slot with a zero frame. Past the end (runs of 1 there reach no frame)
    the runs of 1 also hold the plain version."""
    geo = gate_geometry(StftConfig(**{**GEOMS, **CPLX_GEOMS}[name]), CS + 2 * PAD)
    rng = np.random.default_rng(34)
    re, im = rng.standard_normal((2, 1, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    runs = (1, 3, None, min(32, FFT_ACC // geo.hop))
    for window in ("core", "past-end"):
        outs = [_emulate_istft(re, im, mask, geo, *_istft_window(window), run) for run in runs]
        assert all(np.array_equal(outs[0], out) for out in outs[1:])
    ref = K.istft_ola_ref(*(torch.as_tensor(a) for a in (re, im, mask)), geo,
                          *_istft_window("past-end"))
    _close(outs[0], ref.numpy())


ROUTE_MAX_NFFT = 262144  # the route predicate's sweep: n_fft 1 to this

_ROUTE_MAIN = r"""
#include <algorithm>
#include <cstdio>
#include <vector>
#include "fft_route.cuh"
// per n_fft from 1 to ROUTE_MAX_NFFT: its route, real_kernel and cluster
// shape (c n1 n2, or 0 0 0); then, for each line "n L" on the standard
// input, whether chirp_length_ok(n, L), the smallest L' >= 2n - 1 it
// takes, and L's global split (L1 L2, or 0 0). Past CHIRP_MAX_N points the
// smallest is looked up among the lengths global_chirp_length_ok takes.
int main() {
  for (int n_fft = 1; n_fft <= ROUTE_MAX_NFFT; ++n_fft) {
    int c = 0, n1 = 0, n2 = 0;
    if (!nrf::cluster_shape(nrf::fft_n(n_fft), c, n1, n2)) c = n1 = n2 = 0;
    std::printf("%d %d %d %d %d\n", nrf::route_of(n_fft), nrf::real_kernel(n_fft), c, n1, n2);
  }
  std::vector<int> global;
  for (int L = 2 * nrf::CHIRP_MAX_N + 1; L <= 2 * ROUTE_MAX_NFFT + (1 << 16); ++L)
    if (nrf::global_chirp_length_ok(L)) global.push_back(L);
  int n, L;
  while (std::scanf("%d %d", &n, &L) == 2) {
    int least = 2 * n - 1;
    if (n > nrf::CHIRP_MAX_N)
      least = *std::lower_bound(global.begin(), global.end(), least);
    else
      while (!nrf::chirp_length_ok(n, least)) ++least;
    int L1 = 0, L2 = 0;
    if (!nrf::global_split(L, L1, L2)) L1 = L2 = 0;
    std::printf("%d %d %d %d\n", nrf::chirp_length_ok(n, L), least, L1, L2);
  }
}
""".replace("ROUTE_MAX_NFFT", str(ROUTE_MAX_NFFT))


def test_route_predicate(tmp_path):
    """Every n_fft takes the FFT route when its transform's n (n_fft/2, or
    n_fft when odd) has no prime factor above 13 and fits a block's 4096
    points, the cluster route when such an n past a block
    has a cluster shape (12000 on 2 blocks, 16380 and odd 4851 on 3, 16384
    on 2), the FFT route's big block when it has none and is below 8192
    points (8580, 10010, odd 5005), else the chirp route when 2n - 1 fits a
    big block, else the cluster chirp route when n is at most CHIRP_MAX_N
    (32,768) points, else the global chirp route (every n past CHIRP_MAX_N
    points with no cluster route, to 8,388,608 points); no n_fft from 1
    to 262,144 is left without a route (ROUTE_NONE), and none takes the
    retired DFT-product route, which once took the n_fft below 64 and
    212,771 n_fft (81,699 of them to 131,072: 49,125 odd from 32,769, 32,574
    even from 65,538) before the global chirp route. Below 64 every n_fft
    takes the FFT route (22 of them the real-FFT kernels, 2 to 60; n of 1
    to 31 points, or odd 63) but the odd primes 37 to 61, which take the
    chirp route. An n of at most
    4096 points with no prime factor above 31 takes the FFT route too
    (radices 17 to 31: 776 n_fft from 68 to 8192 that took the chirp
    route before them). 1100 (M = 2 5^2 11), 1102 (M = 19 x 29), 493 (17 x
    29), 1088 (M = 2^5 17) and 2040 (M = 2^2 3 5 17) take the FFT route,
    1101 (3 x 367), 4106 (M = 2053) and 2035 (5 11 37) the chirp route,
    40000 (n = 20000) the cluster route, 4801 (prime), 8194 (n = 17 x 241), 16386
    (n = 3 x 2731), 16940 (n = 2 5 7 11^2, no cluster shape) and 65534 (n
    = 7 31 151) the cluster chirp route (2,005 odd n_fft from 4097 to 8191,
    7,967 n_fft from 8193 to 16384 and 32,253 from 16385 to 65536 that took
    the product route before it); 40001, 40005, 65535, 65538, 144000 and
    192000 the global chirp route. geometry.fft_route, real_kernel and
    cluster_shape agree with csrc/fft_route.cuh (compiled with the host
    compiler) on every n_fft from 1 to 262,144; the kernels take every
    chirp length the geometry picks (2^a 3^b and power of two within a big
    block, 2^a 3^b 5^c and 2^a 3^b past it, 2^a 3^b 5^c with a global split
    past CHIRP_MAX_N points), the default is the smallest they take, and
    the two sides split it alike; the geometry alone decides."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler compiles csrc/fft_route.cuh"
    (tmp_path / "route.cpp").write_text(_ROUTE_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O2", "-I", str(build.CSRC), "-o",
                    str(tmp_path / "route"), str(tmp_path / "route.cpp")], check=True)
    routes = {n_fft: fft_route(StftConfig(n_fft=n_fft)) for n_fft in range(1, ROUTE_MAX_NFFT + 1)}
    chirps = [n_fft if n_fft % 2 else n_fft // 2 for n_fft, r in routes.items()
              if r in ("chirp", "cluster_chirp")]
    globals_ = sorted({n_fft if n_fft % 2 else n_fft // 2 for n_fft, r in routes.items()
                       if r == "global_chirp"})
    # the geometry's length, and the one tools/fft_route_timing.py times in
    # its place: a power of two within a big block, 2^a 3^b past it; the
    # global chirp route's own length alone
    asked = [(n, L) for n in chirps for L in (chirp_length(n), _other_length(n))]
    asked += [(n, chirp_length(n)) for n in globals_]
    lines = subprocess.run([str(tmp_path / "route")], check=True, capture_output=True,
                           text=True, input="".join(f"{n} {L}\n" for n, L in asked)
                           ).stdout.splitlines()
    names = {0: None, 1: "fft", 2: "chirp", 3: "cluster", 4: "cluster_chirp",
             5: "global_chirp"}
    unrouted, was_product, left = [], {}, []
    for n_fft, line in zip(range(1, ROUTE_MAX_NFFT + 1), lines):
        route, real, *shape = map(int, line.split())
        assert routes[n_fft] == names[route], n_fft
        assert real_kernel(n_fft) == bool(real), n_fft
        assert (cluster_shape(n_fft if n_fft % 2 else n_fft // 2) or (0, 0, 0)) == tuple(shape)
        if route == 0:
            unrouted.append(n_fft)
        if route == 4:  # the product route's before the cluster chirp route
            band = next(b for b in ((4097, 8191), (8193, 16384), (16385, 65536))
                        if b[0] <= n_fft <= b[1])
            was_product[band] = was_product.get(band, 0) + 1
        if route == 5:  # the product route's before the global chirp route
            left.append(n_fft)
    for (n, L), line in zip(asked, lines[ROUTE_MAX_NFFT:]):
        ok, least, L1, L2 = map(int, line.split())
        assert ok and L >= 2 * n - 1, (n, L)
        assert chirp_length(n) == least, n
        if n > CHIRP_MAX_N:
            assert global_split(L) == (L1, L2) and L1 * L2 == L and L1 <= L2 <= FFT_ELEMS, n
    assert len(lines) == ROUTE_MAX_NFFT + len(asked)
    assert unrouted == [] and None not in routes.values() and "product" not in routes.values()
    small = range(1, SMALL_NFFT)
    assert [n for n in small if routes[n] != "fft"] == [37, 41, 43, 47, 53, 59, 61]
    assert all(routes[n] == "chirp" for n in (37, 41, 43, 47, 53, 59, 61))
    assert [n for n in small if real_kernel(n)] == [
        n for n in range(2, SMALL_NFFT, 2) if _strip(n // 2, (2, 3, 5, 7)) == 1]
    assert sum(real_kernel(n) for n in small) == 22
    assert was_product == {(4097, 8191): 2005, (8193, 16384): 7967, (16385, 65536): 32253}
    assert len(left) == 212771 and sum(n <= 131072 for n in left) == 81699
    assert sum(n % 2 for n in left if n <= 131072) == 49125
    assert all(fft_n(n) > CHIRP_MAX_N for n in left)
    for n in (32769, 40001, 40005, 65535, 65538, 131074, 144000, 192000, 262144):
        assert routes[n] == fft_route(StftConfig(n_fft=n, **TORCH)) == "global_chirp"
    assert [chirp_length(fft_n(n)) for n in (40005, 65538, 144000, 192000)] == [
        81000, 65610, 144000, 192000]
    assert [global_split(L) for L in (81000, 65610, 144000, 192000)] == [
        (270, 300), (243, 270), (375, 384), (400, 480)]
    assert routes[2] == routes[32] == routes[40] == routes[63] == routes[1] == "fft"
    for n in (64, 512, 1024, 2048, 8192, 1536, 1000, 400, 882, 1100, 441, 1323, 5005,
              8580, 10010, 1102, 493, 1088, 2040, 1235, 1426, 1218, 8192 - 8192 % 31):
        assert routes[n] == fft_route(StftConfig(n_fft=n, **TORCH)) == "fft"
    # the FFT route past 13: every n to 4096 points with no prime factor above 31
    large = [n for n in range(64, 2 * FFT_ELEMS + 1)
             if _strip(n if n % 2 else n // 2, (2, 3, 5, 7, 11, 13)) != 1
             and _strip(n if n % 2 else n // 2, (2, 3, 5, 7, 11, 13) + LARGE_RADICES) == 1
             and (n % 2 == 0 or n <= FFT_ELEMS)]
    assert all(routes[n] == "fft" for n in large) and len(large) == 776
    for n in (40000, 32768, 19683, 62500, 16384, 12000, 16380, 4851, 9600, 8820):
        assert routes[n] == "cluster"
    assert not real_kernel(16384) and real_kernel(8192)
    for n in (1101, 4106, 2035, 2 * 37 * 32, 8182, 2 * 4093):
        assert routes[n] == "chirp"
    for n in (4801, 4803, 8194, 16386, 16940, 65534, 32767, 9218):
        assert routes[n] == fft_route(StftConfig(n_fft=n, **TORCH)) == "cluster_chirp"
    assert chirp_length(551) == 1152 and _pow2_length(551) == 2048
    assert [chirp_length(n) for n in (4801, 8193, 8470, 32767)] == [9720, 16875, 17280, 65536]
    geo = gate_geometry(StftConfig(n_fft=1100, hop_length=275), 8000)
    assert geo.r == 4 and geo.route == "fft" and not geo.fft_real
    assert gate_geometry(StftConfig(n_fft=1102, hop_length=551), 8000).route == "fft"
    assert gate_geometry(StftConfig(n_fft=1101, hop_length=367), 8000).route == "chirp"
    assert gate_geometry(StftConfig(n_fft=4099, hop_length=4099), 8000).route == "cluster_chirp"
    assert gate_geometry(StftConfig(n_fft=1536, hop_length=384), 8000).route == "fft"
    assert gate_geometry(StftConfig(n_fft=512), 8000).route == "fft"


@pytest.mark.parametrize("n_fft,served", [(8388609, False), (16777218, False),
                                           (8388607, True), (16777216, True), (40, True)])
def test_kernels_refuse_an_n_past_the_global_chirp_route(n_fft, served):
    """An n past GLOBAL_MAX_L / 2 = 8,388,608 points (odd 8,388,609, even
    16,777,218) has no route and is refused by ``kernels_supported``, so
    it goes to the staged twins; the largest odd and even n_fft of the
    global chirp route and n_fft 40 (the FFT route, the DFT products
    before it) are served. The predicate only: no geometry, table or
    plane is made."""
    scfg = StftConfig(n_fft=n_fft, hop_length=n_fft)
    route = fft_route(scfg)
    assert route == (None if not served else "fft" if n_fft < SMALL_NFFT else "global_chirp")
    assert kernels_supported(scfg) == served


def test_kernels_serve_every_n_fft_they_served():
    """With the DFT-product route retired, ``kernels_supported`` gives the
    answer it gave with it: every n_fft from 1 to 65,536 served, at a hop
    of the frame and of one sample, in both conventions (the DFT products
    took those below 64; each now has an FFT or chirp route); past
    8,388,608 points refused (the F11 sizes, the test above)."""
    for n_fft in range(1, 65537):
        for hop in {1, n_fft}:
            assert kernels_supported(StftConfig(n_fft=n_fft, hop_length=hop)), (n_fft, hop)
    for n_fft in (1, 2, 3, 37, 40, 63, 64, 65536):
        assert kernels_supported(StftConfig(n_fft=n_fft, hop_length=1, **TORCH))
    assert all(fft_route(StftConfig(n_fft=n)) in ("fft", "chirp") for n in range(1, SMALL_NFFT))


def _other_length(n):
    """The chirp length tools/fft_route_timing.py times beside the
    route's own: a power of two within a big block (``_pow2_length``), the
    smallest 2^a 3^b with a cluster shape past it."""
    if 2 * n - 1 <= FFT_BIG_ELEMS:
        return _pow2_length(n)
    return _family_lengths_23()[bisect.bisect_left(_family_lengths_23(), 2 * n - 1)]


@functools.lru_cache(maxsize=None)
def _family_lengths_23():
    return tuple(L for L in cluster_chirp_lengths() if _strip(L, (2, 3)) == 1)


def _pow2_length(n):
    """The least power of two >= 2n - 1, or 8192 past a block."""
    return 8192 if 2 * n - 1 > 4096 else 1 << (2 * n - 2).bit_length()


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (512, 128), (1024, 256), (2048, 2048),
                                       (8192, 2048), (8192, 8192), (1536, 384),
                                       (400, 100), (882, 441), (1100, 275), (441, 147),
                                       (1323, 441), (4851, 1617), (1102, 551),
                                       (4106, 2053), (2, 1), (3, 1), (4, 1), (16, 4),
                                       (34, 17), (37, 1), (40, 10), (62, 31), (63, 21),
                                       (2, 2), (60, 60), (61, 1)])
def test_fft_tiles_fit_a_block(n_fft, hop):
    """A's tile and D's group hold at most a block's points (a big block's
    for a slot past FFT_ELEMS), D's run at most FFT_ACC samples on the
    real-FFT kernel (the complex-frame kernel's FFT_RUN hop blocks from
    SMALL_NFFT up: its ring of sums holds no run), and every tile and run
    holds at least one frame. The thread segments hold whole
    slots within their threads' points, and together every slot of a tile
    exactly once; a power of two M keeps the layout of one frame or 256/M
    frames a warp. On the real-FFT kernels, A's and D's shared memory
    (``_real_smem``) fits a block's 227 KB in float32 and bf16, two blocks
    an SM at n_fft 1024 and 1536, and D's run fills whole groups where
    one of the complex-frame kernels' length would (its halo frames
    included). Below SMALL_NFFT (frames of 1 to 63 samples: up to 4,096
    slots a block, tiles of (G - 1) hop + win samples) D's run grows with
    its group G on both kernels: the run, its r - 1 halo frames and, for
    an odd n_fft, one more fill whole groups, on the real-FFT kernel the
    fewest in which the halo takes at most half (one group), on the
    complex-frame kernel CPLX_SMALL_GROUPS."""
    geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 20000)
    G, halo = geo.fft_tile_frames, geo.r - 1
    if geo.fft_real:
        for elem in (4, 2):
            a, d = _real_smem(geo, elem)
            assert a <= SMEM_MAX and d <= SMEM_MAX
            if n_fft in (1024, 1536):
                assert 2 * a <= SMEM_MAX and 2 * d <= SMEM_MAX
    if n_fft < SMALL_NFFT and not geo.fft_real:
        halo += 1 if n_fft % 2 else 0
        assert geo.fft_run + halo == CPLX_SMALL_GROUPS * G
    elif n_fft < SMALL_NFFT:
        groups = (geo.fft_run + halo) // G
        assert (geo.fft_run + halo) % G == 0 and 2 * halo <= groups * G
        assert groups == 1 or 2 * halo > (groups - 1) * G
        assert groups == 1
    elif geo.fft_real:
        old = max(1, min(32, FFT_ACC // hop))
        whole = (geo.fft_run + halo) % G == 0
        assert geo.fft_run <= old and (whole or old + halo < G)
    slot, warps, tile = geo.fft_layout()
    elems, block_warps = ((FFT_BIG_ELEMS, FFT_BIG_WARPS) if slot > FFT_ELEMS
                          else (FFT_ELEMS, FFT_WARPS))
    fps = 2 if n_fft % 2 else 1
    assert tile >= 1 and tile % fps == 0 and tile // fps * slot <= elems
    if geo.fft_real:
        assert geo.fft_run >= 1 and geo.fft_run * hop <= FFT_ACC
    elif n_fft >= SMALL_NFFT:
        assert geo.fft_run == FFT_RUN
    assert 1 <= warps <= block_warps and warps * FFT_WARP_POINTS >= slot
    slots = tile // fps
    for fe in (1, slots - 1, slots):
        owned = [f for f0, nf in _segments(geo, fe) for f in range(f0, f0 + nf)]
        assert owned == list(range(fe))
    m = n_fft // 2
    if n_fft % 2 == 0 and m & (m - 1) == 0:
        assert warps == max(1, m // FFT_WARP_POINTS) and geo.fft_tile_frames * m == FFT_ELEMS


def _real_smem(geo, elem):
    """Dynamic shared memory of a block of the real-FFT kernels for planes
    of ``elem`` bytes (spectra_fft.cu / istft_fft.cu::smem_bytes): A two
    buffers of FFT_ELEMS padded points, the stages' laid twiddles, the
    span's raw values with their
    slack (tile_span.cuh::run_elems), the window and the span's phase; D
    one buffer, the laid twiddles, the slab (re and im raw, the mask's float32 bits, each with
    its slack), post (r hop floats), the ring of G + r - 1 hop blocks and
    the three phases."""
    padded = FFT_ELEMS + FFT_ELEMS // 16

    def run_elems(length, e):
        V = 16 // e
        return (length + 2 * V - 1) // V * V

    G, laid = geo.fft_tile_frames, geo.n_bins & ~1  # M - 1 laid twiddles, made even
    span = (G - 1) * geo.hop + geo.win
    a = 8 * (2 * padded + laid) + elem * run_elems(span, elem) + 4 * geo.win + 4
    d = (8 * (padded + laid) + 2 * elem * run_elems(G * geo.n_bins, elem)
         + 4 * (run_elems(G * geo.n_bins, 4) + geo.r * geo.hop + (G + geo.r - 1) * geo.hop) + 12)
    return a, d


@pytest.mark.parametrize("n_fft", [64, 128, 512, 1024, 1536, 400, 480, 882, 2048, 8192, 6000])
def test_laid_twiddles_are_the_stages_reads(n_fft):
    """fft_smem.cuh::lay_twiddles (and spectra_fft.cu's power-of-two
    twin): entry v - 1, v in [1, M), of the real kernels' laid table is
    tw[(v mod ns) (v / ns) tstep] of the stage with ns <= v < ns R; so each
    stage's read of point r of butterfly j at r ns + (j mod ns) - 1 (j mod
    ns >= 1) is the table entry tw[(j mod ns) r tstep] it read before, a
    warp's lanes (consecutive j) read consecutive entries, the stages'
    entries fill [ns - 1, ns R - 1) one after another, and the M - 1
    entries fit the region of M + 1 rounded down to even."""
    M = n_fft // 2
    tw = _twiddles(n_fft)
    stages, ns = [], 1
    for R in _radices(M):
        stages.append((ns, R, 2 * (M // (ns * R))))
        ns *= R
    laid = np.full(M - 1, np.nan, complex)
    for v in range(1, M):
        s = max(i for i, (ns, _, _) in enumerate(stages) if ns <= v)
        ns, R, tstep = stages[s]
        assert v < ns * R
        laid[v - 1] = tw[(v % ns) * (v // ns) * tstep]
    assert not np.isnan(laid).any() and M - 1 <= (M + 1) & ~1
    for ns, R, tstep in stages:
        j = np.arange(M // R)
        jm = j % ns
        for r in range(1, R):
            at = r * ns + jm - 1
            keep = jm > 0
            assert ((ns - 1 <= at[keep]) & (at[keep] < ns * R - 1)).all()
            assert np.array_equal(laid[at[keep]], tw[jm[keep] * r * tstep])


def test_segment_layout_keeps_most_lanes_busy():
    """Over every n_fft the FFT and chirp routes serve, no other segment
    width fits more slots in a block, and a tile fills at least half of
    its block's points (the least: one slot just above 2048 points, 2049
    at n_fft 4098 or 2049; a big block's one slot of at least 4097)."""
    fills = []
    for n in _route_sizes():
        geo = gate_geometry(StftConfig(n_fft=n, hop_length=n // 2 if n % 2 == 0 else n), 4 * n)
        slot, warps, tile = geo.fft_layout()
        elems, block_warps = ((FFT_BIG_ELEMS, FFT_BIG_WARPS) if slot > FFT_ELEMS
                              else (FFT_ELEMS, FFT_WARPS))
        ws = [w for w in range(1, block_warps + 1) if slot & (slot - 1) or w & (w - 1) == 0]
        best = max((block_warps // w) * (w * FFT_WARP_POINTS // slot) for w in ws)
        slots = tile // (2 if n % 2 else 1)
        assert slots == best
        fills.append(slots * slot / elems)
    assert min(fills) >= 0.5


def test_route_counts_stay_zero_on_cpu():
    K.reset_launch_counts()
    x = torch.as_tensor(np.random.default_rng(35).standard_normal((1, 8000)))
    for n_fft, hop in ((1024, 256), (1536, 384), (1100, 275), (441, 147), (1102, 551)):
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 8000)
        re, im = K.spectra(x, geo)
        K.istft_ola(re, im, torch.ones_like(re), geo, 0, 8000)
    zero = {"fft": 0, "chirp": 0, "cluster": 0, "cluster_chirp": 0, "global_chirp": 0}
    assert K.ROUTES == tuple(zero) and not hasattr(K.spectra, "product_launches")
    assert K.route_counts() == {"spectra": zero, "istft_ola": zero}


# ---------------------------------------------------------------------------
# the cluster route (csrc/fft_cluster.cuh, spectra_cluster.cu,
# istft_cluster.cu) as its blocks compute it, in float64 numpy: each index
# function of the sources has its twin here
# ---------------------------------------------------------------------------
OLA_THREADS = 256  # istft_cluster.cu: threads of an overlap-add block


def _cluster_walk(total, clusters, c):
    """The persistent grid (``launch_clusters``): clusters x c blocks,
    block x of cluster x // c and rank x mod c; cluster i walks slots i, i
    + clusters, ...: per block, (rank, slots)."""
    out = []
    for x in range(clusters * c):
        cid, rank = divmod(x, c)
        out.append((rank, list(range(cid, total, clusters))))
    return out


def _cstage(load, dst, radices, s, m, nb, ld, tw, inverse):
    """fft_cluster.cuh::cstage: stage s of an m-point FFT over nb batches
    interleaved at stride ld, out of place. Butterfly idx = j nb + b (Div
    by nb) loads load(b, j + r m/R), twiddles by tw[jm r tstep] (jm = j
    mod ns through Div; conjugated for the inverse), takes the R-point DFT
    and stores at ((j - jm) R + jm + r ns) ld + b. Asserts that the stage
    writes each (batch, point) of the layout once."""
    R = radices[s]
    ns = int(np.prod(radices[:s], dtype=np.int64))
    mr, tstep = m // R, 2 * (m // (ns * R))
    idx = np.arange(nb * mr)
    j = _div(idx, nb)
    b = idx - j * nb
    v = np.stack([load(b, j + r * mr) for r in range(R)], axis=-1)
    jm = j - _div(j, ns) * ns
    w = tw[jm[:, None] * np.arange(R)[None, :] * tstep]
    v = _dft_r(v * (np.conj(w) if inverse else w), inverse)
    d = (j - jm) * R + jm
    at = np.concatenate([(d + r * ns) * ld + b for r in range(R)])
    want = (np.arange(m)[:, None] * ld + np.arange(nb)[None, :]).ravel()
    assert np.array_equal(np.sort(at), np.sort(want))
    for r in range(R):
        dst[(d + r * ns) * ld + b] = v[:, r]


def _cluster_stages(first, radices, m, nb, ld, tw, inverse, size):
    """One block's m-point FFTs of nb batches at stride ld
    (fft_cluster.cuh::cluster_fft's loops): the first stage loads through
    ``first(b, i)`` into buffer a, the stages then alternate between the
    block's two buffers, which start as NaN (a read of a value no stage
    wrote shows). Returns the last one written."""
    a, b = np.full(size, np.nan, complex), np.full(size, np.nan, complex)
    _cstage(first, a, radices, 0, m, nb, ld, tw, inverse)
    for s in range(1, len(radices)):
        src = a
        _cstage(lambda bb, i: src[i * ld + bb], b, radices, s, m, nb, ld, tw, inverse)
        a, b = b, a
    return a


def _pull(held, q, c, run):
    """fft_cluster.cuh::pull into block q: value e (a float2, or a float4 of
    two where run is even) of block o = e / run' from o's buffer ``held[o]``
    at q run' + e - o run'. Asserts that it copies the run [q run, (q + 1)
    run) of every block's buffer."""
    wide = run % 2 == 0
    v = run // 2 if wide else run
    e = np.arange(c * v)
    o = _div(e, v)
    width = 2 if wide else 1
    at = ((q * v + e - o * v)[:, None] * width + np.arange(width)[None, :]).ravel()
    assert np.array_equal(at.reshape(c, -1), np.tile(np.arange(q * run, (q + 1) * run), (c, 1)))
    return held[np.repeat(o, width), at]


def _cluster_transform(gather, geo, inverse):
    """fft_cluster.cuh::cluster_fft on one slot of the geometry's FFT (n
    points, or the chirp length L on the cluster chirp route);
    ``gather(q, col, j2)`` gives block q's step-1 point j2 of column col
    (arrays). Step 1's stages take n2 points of each column at stride ldc;
    the pull copies rows [q rows, (q + 1) rows) of every block's last
    buffer, one contiguous run of rows ldc values each (float4s where that
    is even); step 4's first stage reads row r = k2 - q rows of column j1
    from the run of block j1 / cols, times w_n^{j1 k2}; its stages
    alternate at stride ldr. Returns (each block's output buffer, ``at(k)``: output
    point k from the block that holds it, cluster_point)."""
    c, n1, n2 = geo.cluster
    n = geo.fft_layout()[0]
    cols, rows = n1 // c, n2 // c
    ldc, ldr, size = cluster_layout(n)
    tw1, tw2, twn = _twiddles(2 * n1), _twiddles(2 * n2), _twiddles(n)
    rad1, rad2 = _radices(n1), _radices(n2)
    held = np.stack([_cluster_stages(lambda col, j2, q=q: gather(q, col, j2), rad2, n2, cols,
                                     ldc, tw2, inverse, size) for q in range(c)])
    run = rows * ldc  # a block's rows of one block's step-1 buffer

    def exchange(q):
        pulled = _pull(held, q, c, run)

        def load(r, j1):
            owner = _div(j1, cols)
            t = twn[j1 * (q * rows + r)]
            return pulled[owner * run + r * ldc + j1 - owner * cols] * (
                np.conj(t) if inverse else t)
        return load

    out = np.stack([_cluster_stages(exchange(q), rad1, n1, rows, ldr, tw1, inverse, size)
                    for q in range(c)])

    def at(k):  # cluster_point
        k1 = _div(k, n2)
        k2 = k - k1 * n2
        owner = _div(k2, rows)
        return out[owner, k1 * ldr + k2 - owner * rows]

    return out, at


def _cluster_convolve(gather, geo, conj):
    """fft_cluster.cuh::cluster_convolve on one slot of the cluster chirp
    route (L = n1 n2 points): the forward transform (``_cluster_transform``),
    the first stage of the n1-point inverses of each block's rows taking
    point k1 of row r times the host's filter spectrum at (q n1 + k1) rows
    + r (``K._cluster_chirp_filter_np``; ``conj``: its conjugate), then the
    pull back of columns [q cols, (q + 1) cols) of every block's rows (one
    run of cols ldr values each), the first stage of the n2-point inverses
    of the columns taking column col's point k2 from block k2 / rows times
    w_L^{-j1 k2}. Asserts that the filter's layout is H[k], k = q rows + r +
    n2 k1. Returns (each block's columns, ``at(j)``: point j of the result
    from the block that holds it, cluster_column_point)."""
    c, n1, n2 = geo.cluster
    L = geo.fft_layout()[0]
    cols, rows = n1 // c, n2 // c
    ldc, ldr, size = cluster_layout(L)
    tw1, tw2, twn = _twiddles(2 * n1), _twiddles(2 * n2), _twiddles(L)
    h = _complex(K._cluster_chirp_filter_np((geo.fft_n, L)))
    full = _complex(K._chirp_filter_np((geo.fft_n, L)))
    q_, k1_, r_ = np.meshgrid(np.arange(c), np.arange(n1), np.arange(rows), indexing="ij")
    assert np.array_equal(h, full[(q_ * rows + r_ + n2 * k1_).ravel()])
    h = (np.conj(h) if conj else h).reshape(c, n1 * rows)
    fwd, _ = _cluster_transform(gather, geo, False)
    inv = np.stack([_cluster_stages(lambda r, k1, q=q: fwd[q][k1 * ldr + r] * h[q][k1 * rows + r],
                                    _radices(n1), n1, rows, ldr, tw1, True, size)
                    for q in range(c)])
    back = cols * ldr

    def exchange(q):
        pulled = _pull(inv, q, c, back)

        def load(col, k2):
            owner = _div(k2, rows)
            t = np.conj(twn[(q * cols + col) * k2])
            return pulled[owner * back + col * ldr + k2 - owner * rows] * t
        return load

    out = np.stack([_cluster_stages(exchange(q), _radices(n2), n2, cols, ldc, tw2, True, size)
                    for q in range(c)])

    def at(j):  # cluster_column_point
        j2 = _div(j, n1)
        j1 = j - j2 * n1
        owner = _div(j1, cols)
        return out[owner, j2 * ldc + j1 - owner * cols]

    return out, at


def _block_points(geo, q):
    """(k1, r, k) of block q's output points, e = k1 rows + r (Div by
    rows): k = q rows + r + n2 k1, consecutive threads on consecutive k2
    (the unpack of spectra_cluster.cu, the scratch writes of
    istft_cluster.cu)."""
    c, n1, n2 = geo.cluster
    rows = n2 // c
    e = np.arange(rows * n1)
    k1 = _div(e, rows)
    r = e - k1 * rows
    return k1, r, q * rows + r + n2 * k1


def _step1_points(geo, q, col, j2):
    """Block q's step-1 point (col, j2): j = q cols + col + n1 j2."""
    c, n1, _ = geo.cluster
    return q * (n1 // c) + col + n1 * j2


def _block_columns(geo, q, k_end):
    """(j2, col, k) of block q's points k < k_end of the chirp's result, e
    = j2 cols + col (Div by cols) over j2 < ceil(k_end / n1): k = q cols +
    col + n1 j2, consecutive threads on consecutive j1 (the unpack of
    spectra_cluster.cu, the scratch writes of istft_cluster.cu on the
    cluster chirp route)."""
    c, n1, n2 = geo.cluster
    cols = n1 // c
    e = np.arange(cols * min(n2, -(-k_end // n1)))
    j2 = _div(e, cols)
    col = e - j2 * cols
    k = q * cols + col + n1 * j2
    keep = k < k_end
    return j2[keep], col[keep], k[keep]


def _emulate_spectra_cluster(x, geo, cs=0, pad=0, clusters=3):
    """csrc/spectra_cluster.cu: ``clusters`` persistent clusters walk the
    slots (a frame; a frame pair 2s, 2s + 1 for an odd n_fft, zero past
    the last); each block's first stage gathers its points from the
    zero-filled signal (z[q] = u[2q] + i u[2q+1], or u_a + i u_b), the
    cluster's transform, and per bin k of its rows its partner n - k from
    the block that holds it: the split, and the Nyquist bin from k = 0
    (even n_fft), or the pair's two frames (odd). On the cluster chirp
    route the gather takes z_j cbar_j for j < n and zero up to L, the
    cluster's convolution, and the unpack the points k < n (bins k <
    n_bins, odd) of each block's columns times cbar_k, the partner times
    cbar_{n-k}. Asserts that the walk takes every slot once and the blocks'
    bins cover the slot once."""
    N, n, nb, paired = geo.n_fft, geo.fft_n, geo.n_bins, geo.fft_paired
    c = geo.cluster[0]
    L = geo.fft_layout()[0]
    ldc, ldr, _ = cluster_layout(L)
    chirp = geo.route == "cluster_chirp"
    cb = _complex(K._chirp_np(n)) if chirp else None
    tws = _twiddles(N)
    rows, src = x.shape
    k_chunks = n_chunks_for(src, cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    T, hop, win = geo.n_frames, geo.hop, geo.win
    ws = K._scaled_window_np(geo.scfg)
    n_slots = -(-T // 2) if paired else T
    total = rows * k_chunks * n_slots
    re = np.full((rows * k_chunks, T, nb), np.nan)
    im = np.full_like(re, np.nan)
    walk = [w for rank, w in _cluster_walk(total, clusters, c) if rank == 0]
    assert sorted(sum(walk, [])) == list(range(total))
    for slot in sum(walk, []):
        b, s = divmod(slot, n_slots)
        h, ch = divmod(b, k_chunks)
        fa = 2 * s if paired else s
        u = np.zeros((2, N))
        for i in range(2 if paired else 1):
            t = fa + i
            if t >= T:
                continue
            p = t * hop - geo.bpad + np.arange(win)
            s_ = ch * stride + start + p
            ok = (p >= 0) & (p < geo.view_len) & (s_ >= 0) & (s_ < src)
            u[i, :win] = ws * np.where(ok, x[h, np.clip(s_, 0, src - 1)], 0.0)
        pts = u[0] + 1j * u[1] if paired else u[0, 0::2] + 1j * u[0, 1::2]
        if chirp:  # z_j cbar_j, zero past n
            pts = np.concatenate([pts * cb, np.zeros(L - n)])
        gathered = []

        def gather(q, col, j2):
            j = _step1_points(geo, q, col, j2)
            gathered.append(j)
            return pts[j]

        if chirp:
            out, at = _cluster_convolve(gather, geo, False)
        else:
            out, at = _cluster_transform(gather, geo, False)
        assert np.array_equal(np.sort(np.concatenate(gathered)), np.arange(L))
        zk, ks = [], []
        for q in range(c):  # block q's bins, in its own buffer
            if chirp:
                j2, col, k = _block_columns(geo, q, nb if paired else n)
                zk.append(out[q, j2 * ldc + col] * cb[k])
            else:
                k1, rr, k = _block_points(geo, q)
                zk.append(out[q, k1 * ldr + rr])
            ks.append(k)
        k, zk = np.concatenate(ks), np.concatenate(zk)
        assert np.array_equal(np.sort(k), np.arange(nb if chirp and paired else n))
        km = np.where(k > 0, n - k, 0)
        zm = at(km)  # the partner from the block that holds it
        if chirp:
            zm = zm * cb[km]
        if paired:
            keep = k < nb
            xa = 0.5 * (zk + np.conj(zm))
            xb = -0.5j * (zk - np.conj(zm))
            re[b, fa, k[keep]], im[b, fa, k[keep]] = xa.real[keep], xa.imag[keep]
            if fa + 1 < T:
                re[b, fa + 1, k[keep]], im[b, fa + 1, k[keep]] = xb.real[keep], xb.imag[keep]
        else:
            lo, hi = _split(zk, zm, tws[k])
            re[b, fa, k], im[b, fa, k] = lo.real, lo.imag
            nyq = hi[k == 0][0]
            re[b, fa, n], im[b, fa, n] = nyq.real, nyq.imag
    assert not np.isnan(re).any() and not np.isnan(im).any()
    return re, im


def _emulate_istft_cluster(re, im, mask, geo, out_off, out_len, clusters=3):
    """csrc/istft_cluster.cu in its two passes. 1: ``clusters`` persistent
    clusters walk the slots of frames t_lo to t_lo + n_fr - 1 of each row
    (``cluster_frames``), each block's first stage gathering its points
    from the masked planes (even n_fft: unsplit(Y[j], Y[n - j], Y[n] for j
    = 0); odd: W[j] = Y_a[j] + i Y_b[j] below n_bins, conj Y_a[n-j] + i
    conj Y_b[n-j] above), the cluster's unscaled inverse, and each block's
    output points written to the (rows, n_fr, win) scratch. 2: a thread a
    sample l of a row's n_out hop blocks (blocks of OLA_THREADS, per_row a
    row), its frames' post[u] y_t[u] in ascending t from the scratch, the
    envelope (the host table where all r frames exist, else summed) and the
    trim. Asserts that pass 1 writes every scratch value once and pass 2
    every output sample once."""
    N, n, nb, paired = geo.n_fft, geo.fft_n, geo.n_bins, geo.fft_paired
    c = geo.cluster[0]
    L = geo.fft_layout()[0]
    ldc, ldr, _ = cluster_layout(L)
    chirp = geo.route == "cluster_chirp"
    cb = _complex(K._chirp_np(n)) if chirp else None
    tws = _twiddles(N)
    B, T, _ = re.shape
    hop, r, win = geo.hop, geo.r, geo.win
    fps = 2 if paired else 1
    j0, n_out = geo.out_blocks(out_off, out_len)
    t_lo, n_fr = geo.cluster_frames(j0, n_out)
    row_slots = -(-n_fr // fps)
    total = B * row_slots
    kk = np.arange(nb)
    y = np.full((B, n_fr, win), np.nan)
    written = np.zeros(y.shape, int)

    def spectrum(b, t):  # Y = Z * mask, no imaginary DC or Nyquist part
        if t >= T:
            return np.zeros(nb, complex)
        return (re[b, t] + 1j * im[b, t] * ((kk > 0) & (kk < N / 2))) * mask[b, t]

    walk = [w for rank, w in _cluster_walk(total, clusters, c) if rank == 0]
    assert sorted(sum(walk, [])) == list(range(total))
    for slot in sum(walk, []):
        b, si = divmod(slot, row_slots)
        ta = t_lo + si * fps
        ya, yb = spectrum(b, ta), spectrum(b, ta + 1)

        def point(j):
            if paired:
                jm = np.where(j < nb, j, n - j)
                return np.where(j < nb, ya[jm] + 1j * yb[jm],
                                np.conj(ya[jm]) + 1j * np.conj(yb[jm]))
            return _unsplit(ya[j], np.where(j == 0, ya[n], ya[(n - j) % n]), tws[j])[0]

        def gather(q, col, j2):
            j = _step1_points(geo, q, col, j2)
            if chirp:  # W_j c_j, zero past n
                jn = np.minimum(j, n - 1)
                return np.where(j < n, point(jn) * np.conj(cb[jn]), 0.0)
            return point(j)

        if chirp:
            out, _ = _cluster_convolve(gather, geo, True)
        else:
            out, _ = _cluster_transform(gather, geo, True)
        for q in range(c):
            if chirp:  # the points with a sample in the frame, times c_k
                j2, col, k = _block_columns(geo, q, win if paired else -(-win // 2))
                pt = out[q, j2 * ldc + col] * np.conj(cb[k])
            else:
                k1, rr, k = _block_points(geo, q)
                pt = out[q, k1 * ldr + rr]
            i = ta - t_lo
            if paired:
                keep = k < win
                y[b, i, k[keep]] = pt.real[keep]
                written[b, i, k[keep]] += 1
                if ta + 1 < T and i + 1 < n_fr:
                    y[b, i + 1, k[keep]] = pt.imag[keep]
                    written[b, i + 1, k[keep]] += 1
            else:
                for u, v in ((2 * k, pt.real), (2 * k + 1, pt.imag)):
                    keep = u < win
                    y[b, i, u[keep]] = v[keep]
                    written[b, i, u[keep]] += 1
    assert (written == 1).all()
    return _cluster_ola(y, geo, B, T, j0, n_out, t_lo, n_fr, out_off, out_len)


def _cluster_ola(y, geo, B, T, j0, n_out, t_lo, n_fr, out_off, out_len):
    """istft_cluster.cuh::istft_cluster_ola_kernel over the frame scratch
    y (rows, n_fr, win): a thread a sample l of a row's n_out hop blocks
    (blocks of OLA_THREADS, per_row a row), its frames' post[u] y_t[u] in
    ascending t, the envelope (the host table where all r frames exist,
    else summed) and the trim. Asserts that it writes every output sample
    once."""
    hop, r = geo.hop, geo.r
    post = K._post_window_np(geo.scfg)
    wsq, env_int = K._window_squares_np(geo.scfg), K._interior_envelope_np(geo.scfg)
    out = np.full((B, out_len), np.nan)
    per_row = -(-n_out * hop // OLA_THREADS)
    for blk in range(B * per_row):
        b = blk // per_row
        l = (blk - b * per_row) * OLA_THREADS + np.arange(OLA_THREADS)
        l = l[l < n_out * hop]
        jb = l // hop
        q = l - jb * hop
        jj = j0 + jb
        s_ = jj * hop + q - geo.bpad
        o = s_ - out_off
        keep = (o >= 0) & (o < out_len)
        l, q, jj, s_, o = l[keep], q[keep], jj[keep], s_[keep], o[keep]
        acc = np.zeros(len(l))
        for i in range(r):  # t = jj - r + 1 + i: ascending
            t = jj - r + 1 + i
            ok = (t >= 0) & (t < T)
            u = (jj - t) * hop + q
            acc += np.where(ok, post[u] * y[b, np.clip(t - t_lo, 0, max(n_fr - 1, 0)), u]
                            if n_fr else 0.0, 0.0)
        env = np.zeros(len(l), wsq.dtype)  # ascending t, in the table's dtype
        for i in reversed(range(r)):
            env += ((jj - i >= 0) & (jj - i < T)) * wsq[i * hop + q]
        env = np.where((jj - r + 1 >= 0) & (jj < T), env_int[q], env)
        yy = np.where(s_ < geo.istft_len, acc / np.where(env > geo.env_floor, env, 1.0), 0.0)
        assert np.isnan(out[b, o]).all()
        out[b, o] = yy
    assert not np.isnan(out).any()
    return out


# ---------------------------------------------------------------------------
# the global chirp route (csrc/fft_global.cuh, spectra_global.cu,
# istft_global.cu) as its blocks compute it, in float64 numpy
# ---------------------------------------------------------------------------
def _global_convolve(gather, geo, conj, emit):
    """fft_global.cuh's three passes on one slot of L = L1 L2 points
    (``global_shape``: tiles of tc columns, blocks of rb rows, each block's
    two buffers NaN at the start). Pass 1, a tile [c0, c0 + tc) a block:
    ``gather(c0, col, j1)`` gives point j1 of column c0 + col (the block
    computes the tile's columns past L2 from zeros and writes none), the
    L1-point FFTs at stride ldt = tc | 1, each point k1 of column j2 times
    the host's ``_global_twiddle_np`` at k1 L2 + j2 into the slot's
    scratch at k1 L2 + j2. Pass 2, a block of rb rows: the rows copied in
    (point j2 of row r at j2 ldr + r, zero past L1), the L2-point FFTs,
    point k2 of row r times the host's filter (``_global_chirp_filter_np``
    at (q L2 + k2) rb + r; ``conj``: its conjugate) in the first stage of
    the unscaled inverses, the rows copied back. Pass 3, the tiles again:
    column j2's points k1 times the conjugate twiddle, the unscaled
    L1-point inverses, and ``emit(j, v)`` for each point j = j2 + L2 j1,
    tile by tile in place (the emit may write the scratch the tiles read).
    Asserts the host tables' layouts and that the passes write every
    scratch value once."""
    L = geo.fft_layout()[0]
    L1, L2, tc, rb = global_shape(L)
    ldt, ldr = tc | 1, rb | 1
    size = max(L1 * ldt, L2 * ldr)
    size += size % 2
    tw1, tw2 = _twiddles(2 * L1), _twiddles(2 * L2)
    twl = _complex(K._global_twiddle_np(L))
    k1_, j2_ = np.meshgrid(np.arange(L1), np.arange(L2), indexing="ij")
    assert np.abs(twl - np.exp(-2j * np.pi * (k1_ * j2_).ravel() / L)).max() < 1e-15
    filt = _complex(K._global_chirp_filter_np((geo.fft_n, L)))
    full = _complex(K._chirp_filter_np((geo.fft_n, L)))
    q_, k2_, r_ = np.meshgrid(np.arange(-(-L1 // rb)), np.arange(L2), np.arange(rb),
                              indexing="ij")
    k1f = (q_ * rb + r_).ravel()
    assert np.array_equal(filt, np.where(k1f < L1, full[np.minimum(k1f, L1 - 1)
                                                        + L1 * k2_.ravel()], 0.0))
    filt = np.conj(filt) if conj else filt
    rows = np.full(L, np.nan, complex)  # the slot's scratch
    tiles, row_blocks = -(-L2 // tc), -(-L1 // rb)
    e = np.arange(L1 * tc)
    k1, col = _div(e, tc), e - _div(e, tc) * tc
    for t in range(tiles):  # pass 1
        c0 = t * tc
        y = _cluster_stages(lambda cc, j1, c0=c0: gather(c0, cc, j1), _radices(L1), L1, tc,
                            ldt, tw1, False, size)
        keep = col < min(tc, L2 - c0)
        at = k1[keep] * L2 + c0 + col[keep]
        assert np.isnan(rows[at]).all()
        rows[at] = y[k1[keep] * ldt + col[keep]] * twl[at]
    assert not np.isnan(rows).any()
    er = np.arange(rb * L2)
    r, j2 = _div(er, L2), er - _div(er, L2) * L2
    for q in range(row_blocks):  # pass 2
        nr = min(rb, L1 - q * rb)
        staged = np.full(size, np.nan, complex)
        staged[j2 * ldr + r] = np.where(r < nr, rows[np.minimum(q * rb * L2 + er, L - 1)], 0.0)
        x = _cluster_stages(lambda rr, jj: staged[jj * ldr + rr], _radices(L2), L2, rb, ldr, tw2,
                            False, size)
        h = filt[q * L2 * rb : (q + 1) * L2 * rb]
        v = _cluster_stages(lambda rr, k2: x[k2 * ldr + rr] * h[k2 * rb + rr], _radices(L2), L2,
                            rb, ldr, tw2, True, size)
        keep = r < nr
        rows[q * rb * L2 + er[keep]] = v[j2[keep] * ldr + r[keep]]
    for t in range(tiles):  # pass 3
        c0 = t * tc
        cols = min(tc, L2 - c0)

        def load(cc, kk, c0=c0, cols=cols):
            at = np.minimum(kk * L2 + c0 + cc, L - 1)
            return np.where(cc < cols, rows[at] * np.conj(twl[at]), 0.0)

        y = _cluster_stages(load, _radices(L1), L1, tc, ldt, tw1, True, size)
        keep = col < cols
        emit(c0 + col[keep] + L2 * k1[keep], y[k1[keep] * ldt + col[keep]])


def _emulate_spectra_global(x, geo, cs=0, pad=0, group=5):
    """csrc/spectra_global.cu: the slots (a frame; a frame pair 2s, 2s + 1
    for an odd n_fft) in groups of ``group``, each slot's pass 1 gathering
    the windowed points of its tiles' columns j < n times cbar_j from the
    zero-filled signal (zero up to L), ``_global_convolve``, pass 3's
    points j < n times cbar_j back to the slot's scratch, then the unpack:
    a thread a bin k < n (k < n_bins, odd), Z[k] and Z[n - k] from the
    scratch, the split and the Nyquist bin from k = 0 (even n_fft) or the
    pair's two frames (odd). Asserts that every plane value is written
    once."""
    N, n, nb, paired = geo.n_fft, geo.fft_n, geo.n_bins, geo.fft_paired
    L = geo.fft_layout()[0]
    L2 = global_shape(L)[1]
    cb = _complex(K._chirp_np(n))
    tws = _twiddles(N)
    rows, src = x.shape
    k_chunks = n_chunks_for(src, cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    T, hop, win = geo.n_frames, geo.hop, geo.win
    ws = K._scaled_window_np(geo.scfg)
    n_slots = -(-T // 2) if paired else T
    total = rows * k_chunks * n_slots
    re = np.full((rows * k_chunks, T, nb), np.nan)
    im = np.full_like(re, np.nan)
    for g0 in range(0, total, group):
        scratch = {}
        for s in range(min(group, total - g0)):
            b, sl = divmod(g0 + s, n_slots)
            h, ch = divmod(b, k_chunks)
            fa = 2 * sl if paired else sl
            u = np.zeros((2, N))
            for i in range(2 if paired else 1):
                t = fa + i
                if t >= T:
                    continue
                p = t * hop - geo.bpad + np.arange(win)
                s_ = ch * stride + start + p
                ok = (p >= 0) & (p < geo.view_len) & (s_ >= 0) & (s_ < src)
                u[i, :win] = ws * np.where(ok, x[h, np.clip(s_, 0, src - 1)], 0.0)
            pts = u[0] + 1j * u[1] if paired else u[0, 0::2] + 1j * u[0, 1::2]

            def gather(c0, cc, j1):
                j = c0 + cc + L2 * j1
                jn = np.minimum(j, n - 1)
                return np.where((c0 + cc < L2) & (j < n), pts[jn] * cb[jn], 0.0)

            z = np.full(L, np.nan, complex)

            def emit(j, v):
                keep = j < n
                z[j[keep]] = v[keep] * cb[j[keep]]

            _global_convolve(gather, geo, False, emit)
            scratch[s] = z
        for s, z in scratch.items():  # the unpack launch of the group
            b, sl = divmod(g0 + s, n_slots)
            fa = 2 * sl if paired else sl
            k = np.arange(nb if paired else n)
            zk, zm = z[k], z[np.where(k > 0, n - k, 0)]
            if paired:
                xa, xb = 0.5 * (zk + np.conj(zm)), -0.5j * (zk - np.conj(zm))
                assert np.isnan(re[b, fa]).all()
                re[b, fa], im[b, fa] = xa.real, xa.imag
                if fa + 1 < T:
                    re[b, fa + 1], im[b, fa + 1] = xb.real, xb.imag
            else:
                lo, hi = _split(zk, zm, tws[k])
                assert np.isnan(re[b, fa]).all()
                re[b, fa, :n], im[b, fa, :n] = lo.real, lo.imag
                re[b, fa, n], im[b, fa, n] = hi[0].real, hi[0].imag
    assert not np.isnan(re).any() and not np.isnan(im).any()
    return re, im


def _emulate_istft_global(re, im, mask, geo, out_off, out_len, group=5):
    """csrc/istft_global.cu: the slots of frames t_lo to t_lo + n_fr - 1
    of each row (``cluster_frames``) in groups of ``group``, each slot's
    pass 1 gathering point k < n of its tiles' columns from the masked
    planes (even n_fft: unsplit(Y[k], Y[n - k], Y[n] for k = 0); odd: W[k]
    = Y_a[k] + i Y_b[k] below n_bins, conj Y_a[n-k] + i conj Y_b[n-k]
    above) times c_k (zero up to L), ``_global_convolve`` with the
    conjugate filter, pass 3's points with a sample in the frame times c_j
    into the (rows, n_fr, win) frame scratch; then the cluster routes'
    overlap-add pass (``_cluster_ola``). Asserts that pass 3 writes every
    scratch value once."""
    N, n, nb, paired = geo.n_fft, geo.fft_n, geo.n_bins, geo.fft_paired
    L = geo.fft_layout()[0]
    L2 = global_shape(L)[1]
    cb = _complex(K._chirp_np(n))
    tws = _twiddles(N)
    B, T, _ = re.shape
    win = geo.win
    fps = 2 if paired else 1
    j0, n_out = geo.out_blocks(out_off, out_len)
    t_lo, n_fr = geo.cluster_frames(j0, n_out)
    row_slots = -(-n_fr // fps)
    total = B * row_slots
    kk = np.arange(nb)
    y = np.full((B, n_fr, win), np.nan)
    written = np.zeros(y.shape, int)

    def spectrum(b, t):  # Y = Z * mask, no imaginary DC or Nyquist part
        if t >= T:
            return np.zeros(nb, complex)
        return (re[b, t] + 1j * im[b, t] * ((kk > 0) & (kk < N / 2))) * mask[b, t]

    for g0 in range(0, total, group):
        for s in range(min(group, total - g0)):
            b, si = divmod(g0 + s, row_slots)
            ta = t_lo + si * fps
            ya, yb = spectrum(b, ta), spectrum(b, ta + 1)

            def point(j):
                if paired:
                    jm = np.where(j < nb, j, n - j)
                    return np.where(j < nb, ya[jm] + 1j * yb[jm],
                                    np.conj(ya[jm]) + 1j * np.conj(yb[jm]))
                return _unsplit(ya[j], np.where(j == 0, ya[n], ya[(n - j) % n]), tws[j])[0]

            def gather(c0, cc, j1):
                j = c0 + cc + L2 * j1
                jn = np.minimum(j, n - 1)
                return np.where((c0 + cc < L2) & (j < n), point(jn) * np.conj(cb[jn]), 0.0)

            i = ta - t_lo
            k_end = win if paired else -(-win // 2)

            def emit(j, v, b=b, i=i, ta=ta):
                keep = j < k_end
                j, p = j[keep], v[keep] * np.conj(cb[j[keep]])
                if paired:
                    y[b, i, j] = p.real
                    written[b, i, j] += 1
                    if ta + 1 < T and i + 1 < n_fr:
                        y[b, i + 1, j] = p.imag
                        written[b, i + 1, j] += 1
                else:
                    for u, val in ((2 * j, p.real), (2 * j + 1, p.imag)):
                        ok = u < win
                        y[b, i, u[ok]] = val[ok]
                        written[b, i, u[ok]] += 1

            _global_convolve(gather, geo, True, emit)
    assert (written == 1).all()
    return _cluster_ola(y, geo, B, T, j0, n_out, t_lo, n_fr, out_off, out_len)


@pytest.mark.parametrize("kw", CLUSTER_GEOMS.values(), ids=CLUSTER_GEOMS.keys())
def test_cluster_shapes(kw):
    """c blocks, n = n1 n2 with c dividing both, n / c points a block at
    most a big block's, c the fewest that hold n so, n1 the largest factor
    <= n2; a slot a group. Kernel D has no runs on this route: it
    transforms the frames that overlap the output's hop blocks once each,
    from an even frame for an odd n_fft (``cluster_frames``)."""
    geo = gate_geometry(StftConfig(**kw), 3 * kw["n_fft"])
    c, n1, n2 = geo.cluster
    n = geo.fft_n
    assert geo.route == "cluster" and n1 * n2 == n and n1 % c == 0 and n2 % c == 0
    assert n // c <= FFT_BIG_ELEMS and n > FFT_ELEMS and 2 <= c <= CLUSTER_MAX
    assert all(n % (d * d) or n // d > FFT_BIG_ELEMS for d in range(2, c))
    assert n1 <= n2 and geo.fft_layout()[2] == (2 if geo.fft_paired else 1)
    T, r = geo.n_frames, geo.r
    for out_off, out_len in ((0, geo.view_len), (geo.hop * 3 + 5, 2 * geo.hop), (0, 1)):
        j0, n_out = geo.out_blocks(out_off, out_len)
        t_lo, n_fr = geo.cluster_frames(j0, n_out)
        need = {t for jj in range(j0, j0 + n_out) for t in range(jj - r + 1, jj + 1)
                if 0 <= t < T}
        assert set(range(t_lo, t_lo + n_fr)) >= need and t_lo + n_fr - 1 == max(need)
        assert t_lo == (min(need) & ~1 if geo.fft_paired else min(need))


def test_cluster_buffers_fit_shared_memory():
    """Every cluster shape's two buffers, step 1's n2 x ldc and step 4's
    n1 x ldr with odd leading dimensions, the larger made even, fit a
    block's shared memory; and the builds: n's odd primes within {3, 5},
    105 within 3, 5 and 7, 15015 with 11 or 13, each compiling every radix
    of n1 and n2."""
    for n in range(FFT_ELEMS + 1, CLUSTER_MAX * FFT_BIG_ELEMS + 1):
        shape = cluster_shape(n)
        if not shape or fft_route(StftConfig(n_fft=2 * n)) != "cluster":
            continue
        c, n1, n2 = shape
        ldc, ldr, size = cluster_layout(n)
        assert ldc % 2 == ldr % 2 == 1 and n1 // c <= ldc <= n1 // c + 1
        assert 2 * size * 8 <= SMEM_MAX, n
        odd = cluster_build(n)
        assert all(odd % R == 0 for R in _radices(n1) + _radices(n2) if R % 2)

    assert [cluster_build(n) for n in (20000, 16384, 19683, 31250, 7 * 4096, 11 * 2048)] == [
        5, 1, 3, 5, 105, 15015]


def test_cluster_chirp_lengths():
    """Every n of the cluster chirp route (an n_fft whose n takes
    neither the FFT, the cluster nor the chirp route, to CHIRP_MAX_N
    points): its chirp length L >= 2n - 1 is the smallest 2^a 3^b 5^c with
    a cluster shape, whose build is one of the chirp's (1, 3, 5 or 15:
    fft_cluster.cuh::with_chirp_build) and whose two buffers fit a block's
    shared memory; every such L is at most CLUSTER_MAX big blocks, so
    every n to CHIRP_MAX_N has one."""
    lengths = cluster_chirp_lengths()
    family = [L for L in range(FFT_BIG_ELEMS + 1, CLUSTER_MAX * FFT_BIG_ELEMS + 1)
              if _strip(L, (2, 3, 5)) == 1]
    assert lengths == tuple(L for L in family if cluster_shape(L))
    assert lengths[-1] == CLUSTER_MAX * FFT_BIG_ELEMS and lengths[0] == 8640
    for L in lengths:
        assert cluster_build(L) in (1, 3, 5, 15), L
        assert 2 * cluster_layout(L)[2] * 8 <= SMEM_MAX, L
    ns = sorted({n_fft if n_fft % 2 else n_fft // 2 for n_fft in range(1, 2 * CHIRP_MAX_N + 1)
                 if fft_route(StftConfig(n_fft=n_fft)) == "cluster_chirp"})
    assert ns[0] == 4097 and ns[-1] == CHIRP_MAX_N - 1  # 32768 takes the cluster route
    for n in ns:
        L = chirp_length(n)
        assert L >= 2 * n - 1 and cluster_shape(L), n
        below = bisect.bisect_left(family, 2 * n - 1)
        assert not any(cluster_shape(M) for M in family[below:family.index(L)]), n


@pytest.mark.parametrize("c", [2, 3, 4, 5])
@pytest.mark.parametrize("clusters,total", [(1, 7), (4, 4), (6, 41), (64, 41), (33, 5159)])
def test_persistent_walk_covers_every_slot_once(c, clusters, total):
    """The persistent grid: every slot is taken by exactly one cluster, by
    each of its c blocks once (the grid holds min(slots, clusters that
    fit) clusters); D's overlap-add pass writes every sample of every
    output hop block once, whatever the row count."""
    grid = min(total, clusters)
    seen = {}
    for rank, slots in _cluster_walk(total, grid, c):
        for s in slots:
            seen.setdefault(s, []).append(rank)
    assert sorted(seen) == list(range(total))
    assert all(sorted(v) == list(range(c)) for v in seen.values())
    hop, n_out, rows = 1000 * c + 7, total % 9 + 1, clusters % 3 + 1
    per_row = -(-n_out * hop // OLA_THREADS)
    got = np.zeros((rows, n_out * hop), int)
    for blk in range(rows * per_row):
        b = blk // per_row
        l = (blk - b * per_row) * OLA_THREADS + np.arange(OLA_THREADS)
        np.add.at(got[b], l[l < n_out * hop], 1)
    assert (got == 1).all()


# ---------------------------------------------------------------------------
# kernel A's complex-frame builds (csrc/spectra_cplx.cu): persistent
# blocks walk the tiles, each copying the next tile's span behind this
# tile's stages (issue_span)
# ---------------------------------------------------------------------------
BIG_THREADS = FFT_BIG_WARPS * 32


def _block_walk(total, fit):
    """The persistent grid of nr_spectra_cplx's walking builds: min(total,
    fit) blocks, block x taking tiles x, x + grid, ..."""
    grid = min(total, fit)
    return [list(range(x, total, grid)) for x in range(grid)]


def _tile_of(tile, geo, n_tiles, n_chunks, chunk_stride, view_start):
    """spectra_cplx.cu::tile_of: (view b, first frame t0, frames fe, span
    length, view position p0, source sample s0) of a tile."""
    tf = geo.fft_tile_frames
    b, rest = divmod(tile, n_tiles)
    t0 = rest * tf
    fe = min(tf, geo.n_frames - t0)
    p0 = t0 * geo.hop - geo.bpad
    return b, t0, fe, (fe - 1) * geo.hop + geo.win, p0, (b % n_chunks) * chunk_stride + view_start + p0


def _issue_copy(row, s0, lo, hi, length, addr0, elem):
    """tile_span.cuh::issue_copy of row[s0 : s0 + length], a row of plane
    elements of ``elem`` bytes whose element 0 lies at byte address addr0,
    elements [lo, hi) from the row: (buf, ph, how), buf the shared buffer
    (16 bytes of slack), element i at buf[ph + i]; how[i] "zero" (outside
    [lo, hi)), "edge" (a plain copy before or after the 16-byte pieces) or
    "piece" (in a 16-byte cp.async copy, whose shared and global addresses
    are both on 16 bytes)."""
    V = 16 // elem
    ph = (addr0 + s0 * elem) % 16 // elem
    h0 = min(hi, lo + (V - (ph + lo) % V) % V)
    pieces = (hi - h0) // V
    tail = h0 + pieces * V
    buf = np.full(length + V, np.nan)
    how = np.array([None] * length)
    first = h0 + V * np.arange(pieces)  # thread q's 16-byte copy from first[q]
    assert ((ph + first) * elem % 16 == 0).all()
    assert ((addr0 + (s0 + first) * elem) % 16 == 0).all()
    i = (first[:, None] + np.arange(V)).reshape(-1)
    buf[ph + i] = row[s0 + i]
    how[i] = "piece"
    buf[ph : ph + lo] = 0.0
    buf[ph + hi : ph + length] = 0.0
    how[:lo], how[hi:] = "zero", "zero"
    edge = (h0 - lo) + (hi - tail)
    assert edge < 2 * V <= 32
    for t in range(edge):  # thread t's plain copy
        i = lo + t if t < h0 - lo else tail + (t - (h0 - lo))
        buf[ph + i] = row[s0 + i]
        how[i] = "edge"
    return buf, ph, how


def _issue_span(row, s0, p0, length, view_len, addr0, elem):
    """tile_span.cuh::issue_span: ``_issue_copy`` of a tile's span, the
    samples at view positions p0 + i inside the view and the row copied,
    the rest zero."""
    lo = min(length, max(0, -p0, -s0))
    hi = max(lo, min(length, view_len - p0, len(row) - s0))
    return _issue_copy(row, s0, lo, hi, length, addr0, elem)


@pytest.mark.parametrize("fit", [1, 5, 132])
@pytest.mark.parametrize("total", [1, 7, 132, 704, 705, 3000])
def test_cplx_walk_covers_every_tile_once(total, fit):
    """The persistent blocks of the walking builds (grid: min(tiles, the
    blocks the card holds, ``K.cplx_capacity``)): every tile is taken by
    exactly one block, each block walks its tiles in ascending order, and
    no block idles while another holds two more tiles than it."""
    walk = _block_walk(total, fit)
    seen = sorted(t for tiles in walk for t in tiles)
    assert seen == list(range(total))
    assert all(tiles == sorted(tiles) and tiles for tiles in walk)
    assert max(map(len, walk)) - min(map(len, walk)) <= 1


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["nfft8580-r4", "nfft10010-r5", "nfft5005-r5", "nfft4106-r2",
                                  "nfft1102-r2", "nfft493-r17", "nfft1100-r4", "nfft1323-r3",
                                  "nfft1101-r3", "nfft3-r3", "nfft37-r37", "nfft63-r3"])
def test_cplx_walk_span_copy_is_the_guarded_load(name, elem):
    """issue_span's copy of every tile of a complex-frame geometry (a big
    block; a block with a large radix, 1102, odd 493 in frame pairs, or
    with radix 11, 1100; odd 1323; the chirp, 1101; below 64 samples, odd
    3 and 63 and the chirp at 37, tiles of 2,730, 130 and 100 frames at
    hops of 1 and 21), chunked and whole,
    from rows at every 2-byte phase of 16 bytes: the 16-byte pieces, the
    plain edge copies and the zeros together give the one-tile kernel's
    guarded load (zero outside the view and the row), each sample once,
    the pieces on 16 bytes at both ends."""
    _check_span_copies(CPLX_GEOMS[name], elem, real=False)


def _check_span_copies(kw, elem, real):
    """issue_span's copy of every tile of the geometry kw (on the real-FFT
    kernels or not), chunked and whole, from rows at every phase of 16
    bytes for elements of ``elem`` bytes, against the one-tile kernels'
    guarded load: zero outside the view and the row, each sample once."""
    rng = np.random.default_rng(40)
    n_src = 5 * kw["n_fft"] + 3
    row = rng.standard_normal(n_src)
    for chunked in (True, False):
        cs, pad = (2 * kw["n_fft"], kw["n_fft"] // 4) if chunked else (0, 0)
        geo = gate_geometry(StftConfig(**kw), cs + 2 * pad if chunked else n_src)
        assert geo.route in ("fft", "chirp") and geo.fft_real == real
        n_chunks = n_chunks_for(n_src, cs) if cs else 1
        stride, start = (cs, -pad) if cs else (0, 0)
        n_tiles = -(-geo.n_frames // geo.fft_tile_frames)
        for tile in range(n_chunks * n_tiles):
            b, t0, fe, length, p0, s0 = _tile_of(tile, geo, n_tiles, n_chunks, stride, start)
            p = p0 + np.arange(length)
            sidx = s0 + np.arange(length)
            ok = (p >= 0) & (p < geo.view_len) & (sidx >= 0) & (sidx < n_src)
            want = np.where(ok, row[np.clip(sidx, 0, n_src - 1)], 0.0)
            for addr0 in range(0, 16, elem):
                buf, ph, how = _issue_span(row, s0, p0, length, geo.view_len, addr0, elem)
                assert np.array_equal(buf[ph : ph + length], want)
                assert (how != None).all()  # noqa: E711
                assert ((how == "zero") == ~ok).all()


# ---------------------------------------------------------------------------
# the real-FFT kernels' persistent walks (csrc/spectra_fft.cu over A's
# tiles, csrc/istft_fft.cu over D's runs), their cp.async copies
# (tile_span.cuh), laid twiddles, D's ring and shared memory
# ---------------------------------------------------------------------------
REAL_WALK_GEOMS = ["nfft1024-r4", "nfft1536-r4", "nfft512-r4", "nfft400-r4", "nfft882-r2",
                   "torch-nfft512-r2", "nfft2048-win1024", "nfft40-r4", "nfft2-r2"]


@pytest.mark.parametrize("fit", [1, 5, 264])
@pytest.mark.parametrize("name", ["nfft1024-r4", "nfft1536-r4", "nfft400-r4",
                                  "torch-nfft512-r2", "nfft40-r4", "nfft2-r2"])
def test_real_walk_covers_every_tile_once(name, fit):
    """Kernel A's real-FFT blocks (grid: min(tiles, the blocks the card
    holds, ``K.real_capacity``)): every tile of the chunked views is taken
    by exactly one block, each block walks its tiles in ascending order,
    and no block idles while another holds two more tiles than it; the
    planes are bitwise those of one block a tile (a walk of 1) whatever
    the grid."""
    geo = gate_geometry(StftConfig(**GEOMS[name]), CS + 2 * PAD)
    assert geo.fft_real
    total = 2 * n_chunks_for(N_SRC, CS) * -(-geo.n_frames // geo.fft_tile_frames)
    walk = _block_walk(total, fit)
    assert sorted(t for tiles in walk for t in tiles) == list(range(total))
    assert all(tiles == sorted(tiles) and tiles for tiles in walk)
    assert max(map(len, walk)) - min(map(len, walk)) <= 1
    x = np.random.default_rng(41).standard_normal((2, N_SRC))
    one = _emulate_spectra_fft(x, geo, CS, PAD, fit=total)
    for got, want in zip(_emulate_spectra_fft(x, geo, CS, PAD, fit=fit), one):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", REAL_WALK_GEOMS)
def test_real_walk_span_copy_is_the_guarded_load(name, elem):
    """issue_span's copy of every tile of a real-FFT geometry (a power of
    two M, 1024 and 512; mixed radix, 1536, 400, 882; win below n_fft;
    tiles of 204 frames at hop 10, n_fft 40, and of 4,096 at hop 1, 2),
    from rows at every 2-byte phase of 16 bytes: the one-tile kernel's
    guarded load, each sample once, the pieces on 16 bytes at both ends."""
    _check_span_copies(GEOMS[name], elem, real=True)


def _istft_walk(geo, rows, out_off, out_len, fit, run=None):
    """istft_fft.cu's and istft_cplx.cu's persistent walk: min(runs, fit)
    blocks, block x taking runs x, x + grid, ... (run i of row b is item b
    n_runs + i; runs of ``run`` hop blocks, the geometry's by default; an
    odd n_fft's frames from an even one); per block (its runs, the groups
    (run, b, tg, ge) it inverts in order, the slabs (b, tg, ge) it copies
    in order): issue_from(x) first, then after each group's pre-step the
    group after it in its run, or issue_from the next run of the block (the
    first with frames; None past the last)."""
    T, r, G, run = geo.n_frames, geo.r, geo.fft_tile_frames, run or geo.fft_run
    fps = 2 if geo.fft_paired else 1
    j0, n_out = geo.out_blocks(out_off, out_len)
    n_runs = -(-n_out // run)
    total = rows * n_runs
    grid = min(total, fit)

    def run_of(item):
        b, i = divmod(item, n_runs)
        ja = j0 + i * run
        je = min(run, j0 + n_out - ja)
        t_lo = max(0, ja - r + 1)
        return b, ja, je, t_lo - t_lo % fps, min(T - 1, ja + je - 1)

    def issue_from(item):
        for it in range(item, total, grid):
            b, _, _, t_lo, t_hi = run_of(it)
            if t_lo <= t_hi:
                return b, t_lo, min(G, t_hi - t_lo + 1)
        return None

    out = []
    for x in range(grid):
        items, done, issued = list(range(x, total, grid)), [], [issue_from(x)]
        for item in items:
            b, ja, je, t_lo, t_hi = run_of(item)
            for tg in range(t_lo, t_hi + 1, G):
                done.append((item, b, tg, min(G, t_hi - tg + 1)))
                issued.append((b, tg + G, min(G, t_hi - tg - G + 1)) if tg + G <= t_hi
                              else issue_from(item + grid))
        out.append((items, done, issued))
    return out, n_runs, run_of


WALK_VIEW = 20000
WALK_WINDOWS = {"core": (2000, 16000), "whole": (0, WALK_VIEW), "middle": (3000, 9000),
                "past-end": (15000, 15000)}


@pytest.mark.parametrize("fit", [1, 7, 264])
@pytest.mark.parametrize("window", WALK_WINDOWS)
@pytest.mark.parametrize("name", ["nfft1024-r4", "nfft1536-r4", "torch-nfft512-r2",
                                  "nfft882-r2", "nfft512-r1", "nfft40-r4", "nfft2-r2"])
def test_istft_fft_walk_covers_every_run_once(name, window, fit):
    """Kernel D's real-FFT blocks (grid: min(runs, ``K.real_capacity``)):
    every run of every row is taken by exactly one block; each block's
    slab in flight is always the next group it inverts (the copy issued
    after a group's pre-step is the group it takes next, across its runs,
    past runs with no frames) and none is left in flight at its end; the
    groups cover each run's frames, from its first halo frame, each frame
    once a run; the run fills whole groups where it can (below SMALL_NFFT
    always: one group of 204 frames at n_fft 40, of 4,096 at 2). Rows of
    several runs; past the end, runs that no frame reaches."""
    geo = gate_geometry(StftConfig(**GEOMS[name]), WALK_VIEW)
    G, r = geo.fft_tile_frames, geo.r
    assert geo.fft_real and geo.fft_run * geo.hop <= FFT_ACC
    if geo.n_fft < SMALL_NFFT or (min(32, FFT_ACC // geo.hop) + r - 1) >= G:
        assert (geo.fft_run + r - 1) % G == 0
    walk, n_runs, run_of = _istft_walk(geo, 3, *WALK_WINDOWS[window], fit)
    assert n_runs > 1
    empty = [i for i in range(3 * n_runs) if run_of(i)[3] > run_of(i)[4]]
    assert bool(empty) == (window == "past-end")
    assert sorted(i for items, _, _ in walk for i in items) == list(range(3 * n_runs))
    for items, done, issued in walk:
        assert issued[:-1] == [d[1:] for d in done] and issued[-1] is None
        for item in items:
            b, ja, je, t_lo, t_hi = run_of(item)
            frames = [t for it, _, tg, ge in done if it == item for t in range(tg, tg + ge)]
            assert frames == list(range(t_lo, t_hi + 1))


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("n_bins", [513, 769, 201, 4097])
def test_istft_fft_slab_copy_and_division(n_bins, elem):
    """D's slab: a group's ge x n_bins values of a plane copied by
    issue_copy from rows at every phase of 16 bytes hold bin q of frame tg
    + f at f n_bins + q; the pre-step's slot e takes frame f = e / ((M +
    1) / 2) by the plan's multiply-high Div and pair k = e - f (M + 1) / 2,
    and reads bins k, M - k (slot 0: 0, M and M/2) of frame f: the (frame,
    bin) of e' / n_bins, e' % n_bins for the element e' = f n_bins + q it
    reads, which the load by e / n_bins read before. The overlap-add's
    Div of the hop is exact for every sample of a run."""
    M = n_bins - 1
    geo = gate_geometry(StftConfig(n_fft=2 * M, hop_length=M // 2), 20 * M)
    assert geo.fft_real and geo.n_bins == n_bins
    G, T = geo.fft_tile_frames, geo.n_frames
    half = (M + 1) // 2
    plane = np.random.default_rng(n_bins).standard_normal((2, T, n_bins))
    flat = plane.reshape(-1)
    for b, tg in ((0, 0), (1, T - G), (1, 3)):
        ge = min(G, T - tg)
        length = ge * n_bins
        for addr0 in range(0, 16, elem):
            buf, ph, how = _issue_copy(flat, (b * T + tg) * n_bins, 0, length, length, addr0,
                                       elem)
            slab = buf[ph : ph + length]
            assert np.array_equal(slab, plane[b, tg : tg + ge].reshape(-1))
            assert (how != "zero").all() and (how == "piece").sum() >= length - 2 * 16 // elem
        e = np.arange(ge * half)
        f = _div(e, half)
        k = e - f * half
        assert np.array_equal(f, e // half)
        for q in (k, np.where(k > 0, M - k, M), np.full_like(k, M // 2)):
            read = f * n_bins + q
            assert np.array_equal(read // n_bins, f) and np.array_equal(read % n_bins, q)
            assert np.array_equal(slab[read], plane[b, tg + f, q])
    l = np.arange(FFT_ACC)
    assert np.array_equal(_div(l, geo.hop), l // geo.hop)


def _cplx_ring(geo):
    """Bytes of istft_cplx.cu's ring of G + r - 1 hop blocks."""
    return 4 * (geo.fft_tile_frames + geo.r - 1) * geo.hop


def _cplx_smem(geo):
    """istft_cplx.cu::cplx_smem: the slots and the second buffer of the
    stages out of place, the T - 1 laid twiddles (made even) and, on the
    walk (not ``geo.cplx_two_pass``), the ring."""
    slot = geo.fft_layout()[0]
    elems = FFT_BIG_ELEMS if slot > FFT_ELEMS else FFT_ELEMS
    return (8 * ((elems + elems // 16) * 2 + ((slot + 1) & ~1))
            + (0 if geo.cplx_two_pass else _cplx_ring(geo)))


CPLX_WALK_GEOMS = ["nfft1100-r4", "nfft1323-r3", "nfft441-r3", "nfft1102-r2", "nfft1101-r3",
                   "nfft37-r37", "nfft3-r3", "torch-nfft1-r1"]
# the big blocks: even 4106 (the chirp, L = 8192) and 8580, odd 5005 (two
# frames a slot)
CPLX_TWO_PASS_GEOMS = ["nfft4106-r2", "nfft8580-r4", "nfft5005-r5"]


@pytest.mark.parametrize("fit", [1, 7, 132, 264])
@pytest.mark.parametrize("window", WALK_WINDOWS)
@pytest.mark.parametrize("name", CPLX_WALK_GEOMS)
def test_istft_cplx_walk_covers_every_run_once(name, window, fit):
    """Kernel D's complex-frame blocks (grid: min(runs, ``K.cplx_capacity(geo,
    kernel="istft_ola")``)), at the run the kernel takes for the grid
    (``geo.cplx_run``: shorter than the geometry's FFT_RUN only where that
    takes fewer groups of frames a block, the longest such, filling whole
    groups): every run of every
    row is taken by exactly one block; the groups cover each run's frames
    from its first halo frame (an even one for an odd n_fft) once a run;
    an odd n_fft's pre-step reads the partner of an odd group's last frame
    where it exists, never more than a group's frames. Rows of several
    runs; past the end, runs that no frame reaches."""
    geo = gate_geometry(StftConfig(**CPLX_GEOMS[name]), WALK_VIEW)
    G, fps = geo.fft_tile_frames, 2 if geo.fft_paired else 1
    assert not geo.fft_real and not geo.cplx_two_pass
    assert geo.fft_run == FFT_RUN or geo.n_fft < SMALL_NFFT
    n_out = geo.out_blocks(*WALK_WINDOWS[window])[1]
    run = geo.cplx_run(3, n_out, fit)
    assert 1 <= run <= geo.fft_run
    halo = geo.r - 1 + fps - 1
    assert run == geo.fft_run or (run + halo) % G == 0
    cost = lambda rr: -(-3 * -(-n_out // rr) // fit) * (-(-(rr + halo) // G) + 1)  # noqa: E731
    assert cost(run) <= cost(geo.fft_run) and all(cost(rr) > cost(run)
                                                   for rr in range(run + 1, geo.fft_run + 1))
    walk, n_runs, run_of = _istft_walk(geo, 3, *WALK_WINDOWS[window], fit, run)
    empty = [i for i in range(3 * n_runs) if run_of(i)[3] > run_of(i)[4]]
    assert not empty or window == "past-end"
    assert sorted(i for items, _, _ in walk for i in items) == list(range(3 * n_runs))
    for items, done, _ in walk:
        for item in items:
            b, ja, je, t_lo, t_hi = run_of(item)
            assert t_lo % fps == 0 and t_lo <= max(0, ja - geo.r + 1)
            frames = [t for it, _, tg, ge in done if it == item for t in range(tg, tg + ge)]
            assert frames == list(range(t_lo, t_hi + 1))
        for _, _, tg, ge in done:
            fe = _cplx_group_frames(geo, tg, ge)
            assert ge <= fe <= G and tg + fe <= geo.n_frames
            assert fe == min(ge + (ge % fps), geo.n_frames - tg)


@pytest.mark.parametrize("fit", [1, 7, 132, 264])
@pytest.mark.parametrize("window", WALK_WINDOWS)
@pytest.mark.parametrize("name", CPLX_TWO_PASS_GEOMS)
def test_istft_cplx_two_pass_covers_every_frame_once(name, window, fit):
    """Kernel D's complex-frame big blocks (``geo.cplx_two_pass``) in their
    first pass (grid: min(items, ``K.cplx_capacity(geo,
    kernel="istft_ola")``)): every frame of every row that the output
    window needs (``cluster_frames``) is inverted by exactly one block, in
    groups of G frames from the window's first, an even frame for an odd
    n_fft; a group's pre-step reads the partner of an odd group's last
    frame where it exists, never more than a group's frames nor past the
    row's last; the overlap-add pass finds every frame of each of the
    window's hop blocks in the scratch."""
    geo = gate_geometry(StftConfig(**CPLX_GEOMS[name]), WALK_VIEW)
    G, fps, T, r = geo.fft_tile_frames, 2 if geo.fft_paired else 1, geo.n_frames, geo.r
    assert geo.cplx_two_pass and not geo.fft_real and G == fps
    j0, n_out = geo.out_blocks(*WALK_WINDOWS[window])
    walk, t_lo, n_fr = _cplx_two_pass_walk(geo, 3, *WALK_WINDOWS[window], fit)
    assert len(walk) == min(fit, 3 * -(-n_fr // G)) and t_lo % fps == 0
    done = sorted((b, t) for groups in walk for b, tg, ge in groups for t in range(tg, tg + ge))
    assert done == [(b, t) for b in range(3) for t in range(t_lo, t_lo + n_fr)]
    for groups in walk:
        for _, tg, ge in groups:
            assert (tg - t_lo) % G == 0 and 1 <= ge <= G
            fe = _cplx_group_frames(geo, tg, ge)
            assert ge <= fe <= G and tg + fe <= T
    for jj in range(j0, j0 + n_out):
        assert all(t_lo <= t < t_lo + n_fr for t in range(max(0, jj - r + 1), min(jj, T - 1) + 1))


def test_istft_cplx_run_fills_the_grid():
    """The run kernel D's complex-frame walk takes (``geo.cplx_run``): at
    n_fft 1100 / 275 in 5 views of 600,000-sample cores (2,182 hop blocks,
    7 frames a group, 264 blocks), 25 hop blocks a run (2 rounds of the
    grid of 4 groups and the flush, where 32 take 5 and the flush); in 77
    views 32 (21 rounds of 6, where 25 take 26 of 5). A big block (4106 /
    2053) takes two passes, and no run."""
    geo = gate_geometry(StftConfig(n_fft=1100, hop_length=275), 660000)
    n_out = geo.out_blocks(30000, 600000)[1]
    assert (n_out, geo.fft_tile_frames, geo.fft_run, geo.cplx_two_pass) == (2182, 7, 32, False)
    assert geo.cplx_run(5, n_out, 264) == 25
    assert geo.cplx_run(77, n_out, 264) == 32
    assert gate_geometry(StftConfig(n_fft=4106, hop_length=2053), 60 * 48000).cplx_two_pass


@pytest.mark.parametrize("name", ["nfft1100-r4", "nfft1323-r3", "nfft1101-r3", "nfft4106-r2",
                                  "nfft8580-r4", "nfft37-r37", "torch-nfft1-r1"])
def test_istft_cplx_pre_step_reads_and_division(name):
    """D's complex-frame pre-step: slot e takes (even n_fft) frame f = e /
    ((n + 1) / 2) and pair k by the multiply-high Div, reading bins k, n -
    k (slot 0: 0, n and n/2), or (odd) slot bin e / n_bins and bin k of
    frames 2 sl and 2 sl + 1: the (frame, bin) of e' / n_bins, e' % n_bins
    for the element e' = f n_bins + q of the group's frames it reads, none
    past the row's last frame. The ring's Div of the hop is exact for every
    sample of the ring, and a block's shared memory fits."""
    geo = gate_geometry(StftConfig(**CPLX_GEOMS[name]), 4 * CPLX_GEOMS[name]["n_fft"] + 5)
    G, T, nb, n = geo.fft_tile_frames, geo.n_frames, geo.n_bins, geo.fft_n
    plane = np.random.default_rng(nb).standard_normal((2, T, nb))
    for b, tg in ((0, 0), (1, max(0, T - G)), (1, min(3, T - 1))):
        ge = min(G, T - tg)
        fe = _cplx_group_frames(geo, tg, ge)
        frames = plane[b, tg : tg + fe].reshape(-1)
        if geo.fft_paired:
            e = np.arange(-(-ge // 2) * nb)
            sl = _div(e, nb)
            k = e - sl * nb
            assert np.array_equal(sl, e // nb)
            reads = [(2 * sl, k), (2 * sl + 1, k)]
        else:
            half = (n + 1) // 2
            e = np.arange(ge * half)
            f = _div(e, half)
            k = e - f * half
            assert np.array_equal(f, e // half)
            reads = [(f, q) for q in (k, np.where(k > 0, n - k, n), np.full_like(k, n // 2))]
        for f, q in reads:
            ok = tg + f < T  # the kernel's guard: a zero frame past the row's last
            assert (f[ok] < fe).all()
            read = f[ok] * nb + q[ok]
            assert np.array_equal(read // nb, f[ok]) and np.array_equal(read % nb, q[ok])
            assert np.array_equal(frames[read], plane[b, tg + f[ok], q[ok]])
    l = np.arange((G + geo.r - 1) * geo.hop)
    assert np.array_equal(_div(l, geo.hop), l // geo.hop)
    assert _cplx_smem(geo) <= SMEM_MAX
    assert (geo.fft_layout()[0] <= FFT_ELEMS) == (_cplx_smem(geo) < 113 << 10)  # 2 blocks an SM


def test_istft_cplx_fits_shared_memory():
    """Every n_fft of the complex-frame kernels (the FFT route's past the
    real-FFT kernels' and the chirp route's, to a big block), at a hop of
    1, the longest that divides a quarter frame, and a frame: a block's
    two buffers, laid twiddles and ring fit shared memory, and a big
    block's two buffers and laid twiddles (its two passes hold no ring),
    also where the walk's ring would not have fit beside them (n_fft 15972
    at a hop of a frame, and 4001 / 4001, 6920 / 1730 and 12012 / 3003 of
    the card tests' ``WALK_GEOMS``)."""
    for n_fft in range(1, 2 * FFT_BIG_ELEMS + 1, 3):
        scfg = StftConfig(n_fft=n_fft)
        if fft_route(scfg) not in ("fft", "chirp") or real_kernel(n_fft):
            continue
        quarter = max([d for d in range(1, n_fft // 4 + 1) if n_fft % d == 0], default=1)
        for hop in {1, quarter, n_fft}:
            geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 4 * n_fft + 5)
            assert _cplx_smem(geo) <= SMEM_MAX, (n_fft, hop)
            assert geo.cplx_two_pass == (geo.fft_layout()[0] > FFT_ELEMS)
    for n_fft, hop in ((15972, 15972), (4001, 4001), (6920, 1730), (12012, 3003)):
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 12 * n_fft + 5)
        assert geo.cplx_two_pass and _cplx_smem(geo) <= SMEM_MAX < _cplx_smem(geo) + _cplx_ring(geo)


def _spectra_cplx_smem(geo, elem=4):
    """spectra_cplx.cu::cplx_smem: the slots and the second buffer of the
    stages out of place, the T - 1 laid twiddles (made even) and the tile's
    index; a block of 512 threads also its span's raw plane values of
    ``elem`` bytes (with 16 bytes of slack for their phase), the window and
    the span's phase."""
    slot, _, tile = geo.fft_layout()
    elems = FFT_BIG_ELEMS if slot > FFT_ELEMS else FFT_ELEMS
    core = 8 * ((elems + elems // 16) * 2 + ((slot + 1) & ~1)) + 4
    if slot > FFT_ELEMS:
        return core
    length = (tile - 1) * geo.hop + geo.win
    return core + elem * ((length + 16 // elem + 3) // 4 * 4) + 4 * geo.win + 4


def test_spectra_cplx_fits_shared_memory():
    """Every n_fft of kernel A's complex-frame kernel (the FFT route's past
    the real-FFT kernels' and the chirp route's, to a big block, n_fft 8190
    and 8191 among them: the largest block-sized slots), float32 and bf16
    planes, at a hop of 1, the longest that divides a quarter frame, and a
    frame: a block's two buffers, laid twiddles, span and window fit shared
    memory, and a big block's two buffers and laid twiddles. The timed
    cells on block-sized slots keep two blocks an SM, and n_fft 8190 (a
    slot of 4095 points) takes one."""
    for n_fft in sorted(set(range(1, 2 * FFT_BIG_ELEMS + 1, 3)) | {8190, 8191, 4106, 16382}):
        scfg = StftConfig(n_fft=n_fft)
        if fft_route(scfg) not in ("fft", "chirp") or real_kernel(n_fft):
            continue
        quarter = max([d for d in range(1, n_fft // 4 + 1) if n_fft % d == 0], default=1)
        for hop in {1, quarter, n_fft}:
            geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 4 * n_fft + 5)
            for elem in (4, 2):
                assert _spectra_cplx_smem(geo, elem) <= SMEM_MAX, (n_fft, hop, elem)
    two = 113 << 10  # two blocks' shared memory on an SM, each
    for n_fft, hop in ((1100, 275), (1323, 441), (1102, 551), (1101, 367), (37, 1), (441, 147)):
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 60 * 44100)
        assert _spectra_cplx_smem(geo) <= two, n_fft
    geo = gate_geometry(StftConfig(n_fft=8190, hop_length=2730), 4 * 8190)
    assert geo.fft_layout()[0] == 4095 and two < _spectra_cplx_smem(geo) <= SMEM_MAX


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
@pytest.mark.parametrize("kw", CLUSTER_GEOMS.values(), ids=CLUSTER_GEOMS.keys())
def test_spectra_cluster_emulation_matches_plain_version(kw, chunked):
    n_fft = kw["n_fft"]
    x = np.random.default_rng(39).standard_normal((1, 3 * n_fft))
    cs, pad = (2 * n_fft, n_fft // 4) if chunked else (0, 0)
    geo = gate_geometry(StftConfig(**kw), cs + 2 * pad if chunked else 3 * n_fft)
    assert geo.route == "cluster"
    re, im = K.spectra_ref(torch.as_tensor(x), geo, cs, pad)
    ere, eim = _emulate_spectra_cluster(x, geo, cs, pad)
    _close(ere, re.numpy())
    _close(eim, im.numpy())


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
@pytest.mark.parametrize("kw", CLUSTER_CHIRP_GEOMS.values(), ids=CLUSTER_CHIRP_GEOMS.keys())
def test_spectra_cluster_chirp_emulation_matches_plain_version(kw, chunked):
    """Kernel A on the cluster chirp route (the chirp-z convolution over the
    cluster's four-step FFT of the chirp length, the filter spectrum in
    that FFT's order, the inverse back to natural order, the unpack of the
    first n points of each block's columns) against its plain version."""
    n_fft = kw["n_fft"]
    x = np.random.default_rng(41).standard_normal((1, 3 * n_fft))
    cs, pad = (2 * n_fft, n_fft // 4) if chunked else (0, 0)
    geo = gate_geometry(StftConfig(**kw), cs + 2 * pad if chunked else 3 * n_fft)
    assert geo.route == "cluster_chirp" and geo.fft_layout()[0] == chirp_length(geo.fft_n)
    re, im = K.spectra_ref(torch.as_tensor(x), geo, cs, pad)
    ere, eim = _emulate_spectra_cluster(x, geo, cs, pad)
    _close(ere, re.numpy())
    _close(eim, im.numpy())


@pytest.mark.parametrize("window", ["whole", "middle", "past-end"])
@pytest.mark.parametrize("kw", CLUSTER_CHIRP_GEOMS.values(), ids=CLUSTER_CHIRP_GEOMS.keys())
def test_istft_cluster_chirp_emulation_matches_plain_version(kw, window):
    """Kernel D on the cluster chirp route (W_k c_k, the convolution with
    the conjugate filter, the frame's samples times c_j into the scratch,
    the same overlap-add pass) against its plain version."""
    view = 3 * kw["n_fft"]
    geo = gate_geometry(StftConfig(**kw), view)
    assert geo.route == "cluster_chirp"
    rng = np.random.default_rng(42)
    re, im = rng.standard_normal((2, 1, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    out_off, out_len = {"whole": (0, view), "middle": (view // 3, view // 4),
                        "past-end": (view - 500, 2000)}[window]
    ref = K.istft_ola_ref(*(torch.as_tensor(a) for a in (re, im, mask)), geo, out_off, out_len)
    _close(_emulate_istft_cluster(re, im, mask, geo, out_off, out_len), ref.numpy())


@pytest.mark.parametrize("window", ["whole", "middle", "past-end"])
@pytest.mark.parametrize("kw", CLUSTER_GEOMS.values(), ids=CLUSTER_GEOMS.keys())
def test_istft_cluster_emulation_matches_plain_version(kw, window):
    view = 3 * kw["n_fft"]
    geo = gate_geometry(StftConfig(**kw), view)
    rng = np.random.default_rng(40)
    re, im = rng.standard_normal((2, 1, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    out_off, out_len = {"whole": (0, view), "middle": (view // 3, view // 4),
                        "past-end": (view - 500, 2000)}[window]
    ref = K.istft_ola_ref(*(torch.as_tensor(a) for a in (re, im, mask)), geo, out_off, out_len)
    _close(_emulate_istft_cluster(re, im, mask, geo, out_off, out_len), ref.numpy())


# the global chirp route: odd 40005 (r = 5, L = 81,000 = 270 x 300), even
# 65538 (n = 32,769 = 3^2 11 331, L = 65,610 = 243 x 270) and 192000 (n =
# 96,000, 5-smooth past a cluster, L = 192,000 = 400 x 480), odd 40001 =
# 13 x 17 x 181 (L = 80,000 = 250 x 320)
GLOBAL_GEOMS = {
    "nfft40005-r5": dict(n_fft=40005, hop_length=8001),
    "torch-nfft40005-r5": dict(n_fft=40005, hop_length=8001, **TORCH),
    "nfft65538-r3": dict(n_fft=65538, hop_length=21846),
    "torch-nfft65538-r3": dict(n_fft=65538, hop_length=21846, **TORCH),
    "nfft192000-r4": dict(n_fft=192000, hop_length=48000),
    "torch-nfft192000-r4": dict(n_fft=192000, hop_length=48000, **TORCH),
    "nfft40001-r1": dict(n_fft=40001, hop_length=40001),
}


@pytest.mark.parametrize("kw", GLOBAL_GEOMS.values(), ids=GLOBAL_GEOMS.keys())
def test_spectra_global_emulation_matches_plain_version(kw):
    """Kernel A on the global chirp route (the chirp-z convolution of
    length L over the three passes through each slot's scratch, a group
    of slots at a time, the unpack from the scratch) against its plain
    version, on a chunked view of a short signal."""
    n_fft = kw["n_fft"]
    x = np.random.default_rng(43).standard_normal((1, 2 * n_fft + 17))
    cs, pad = n_fft, n_fft // 8
    geo = gate_geometry(StftConfig(**kw), cs + 2 * pad)
    assert geo.route == "global_chirp" and geo.fft_layout()[0] == chirp_length(geo.fft_n)
    re, im = K.spectra_ref(torch.as_tensor(x), geo, cs, pad)
    ere, eim = _emulate_spectra_global(x, geo, cs, pad, group=3)
    _close(ere, re.numpy())
    _close(eim, im.numpy())


@pytest.mark.parametrize("window", ["whole", "middle", "past-end"])
@pytest.mark.parametrize("kw", GLOBAL_GEOMS.values(), ids=GLOBAL_GEOMS.keys())
def test_istft_global_emulation_matches_plain_version(kw, window):
    """Kernel D on the global chirp route (W_k c_k, the convolution with
    the conjugate filter, the frame's samples times c_j into the frame
    scratch, the overlap-add pass) against its plain version, and the
    same output whatever the group of slots a launch takes."""
    n_fft = kw["n_fft"]
    view = 2 * n_fft + n_fft // 4
    geo = gate_geometry(StftConfig(**kw), view)
    assert geo.route == "global_chirp"
    rng = np.random.default_rng(44)
    re, im = rng.standard_normal((2, 1, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    out_off, out_len = {"whole": (0, view), "middle": (view // 3, view // 4),
                        "past-end": (view - 500, 2000)}[window]
    ref = K.istft_ola_ref(*(torch.as_tensor(a) for a in (re, im, mask)), geo, out_off, out_len)
    got = _emulate_istft_global(re, im, mask, geo, out_off, out_len, group=2)
    _close(got, ref.numpy())
    if window == "middle":
        assert np.array_equal(
            got, _emulate_istft_global(re, im, mask, geo, out_off, out_len, group=1))


def test_global_shapes_and_groups():
    """Every global chirp length to 2^20 splits as L1 L2 <= FFT_ELEMS with
    L1 <= L2 the balanced split, a build of the chirp's (1, 3, 5 or 15),
    and a block's two buffers (tiles of tc = FFT_ELEMS // L1 columns, rb =
    FFT_ELEMS // L2 rows, odd leading dimensions) fit shared memory; a
    launch's group takes every slot while their scratch stays within
    GLOBAL_SCRATCH_BYTES, else as many as fit it, at least one."""
    from noisereduce_tpu_torch.ops.cuda.geometry import (
        GLOBAL_SCRATCH_BYTES, global_chirp_lengths, global_group)

    lengths = [L for L in global_chirp_lengths() if L <= 1 << 20]
    assert lengths[0] == 65610 and len(lengths) > 100
    for L in lengths:
        L1, L2, tc, rb = global_shape(L)
        assert L1 * L2 == L and L1 <= L2 <= FFT_ELEMS
        assert not any(L % d == 0 and L // d <= FFT_ELEMS for d in range(L1 + 1, L2))
        assert cluster_build(L) in (1, 3, 5, 15)
        assert 1 <= tc <= L2 and 1 <= rb <= L1 and tc * L1 <= FFT_ELEMS and rb * L2 <= FFT_ELEMS
        size = max(L1 * (tc | 1), L2 * (rb | 1))
        assert 2 * (size + size % 2) * 8 <= SMEM_MAX, L
    assert global_shape(81000) == (270, 300, 15, 13)
    assert global_group(81000, 3234) == 3234  # n_fft 40005 on 960 s: one launch
    assert global_group(81000, 10**6) == GLOBAL_SCRATCH_BYTES // (8 * 81000) == 6628
    assert global_group(81000, 7) == 7
    L = 16777216  # 4096 x 4096: one column a tile, one row a row block
    assert global_shape(L)[2:] == (1, 1)
    assert global_group(L, 100) == GLOBAL_SCRATCH_BYTES // (8 * L) == 32
    assert global_group(1 << 34, 100) == 1
