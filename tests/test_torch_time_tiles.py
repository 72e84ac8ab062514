"""PyTorch port: the time tiles of kernels B ``nonstationary_mask``, E
``stationary_mask`` and F ``torch_nonstationary_mask``
(``csrc/nonstationary_mask.cu``, ``csrc/stationary_mask.cu``,
``csrc/torch_nonstationary_mask.cu`` over ``csrc/time_tiles.cuh``),
emulated in numpy as the sources compute them: float32 where the kernels
round to float, float64 for the carries, the statistics and the
prefixes. B: the per-segment
partials (yl at the segment's end and at offset p_f, wl at its start and at
offset p_b, summed forward), the column walk of the carries with the host
constants of ``kernels._ewma_constants``, the final pass over blocks of
``TILE_SEGS`` segments with one halo on each side of a block, from the
exact carries, with y rounded to float32 before the backward walk, the
tap chain; or, for a halo whose tile does not fit, the raw mask with no
halo and a separate smoothing pass. E: the segment maxima
and their column max, the per-segment float64 sums of the own statistics
added in segment order, the final pass's floor, compare and blend, and
the tap chain. F: the per-segment float64 sums of |Z| and their values at
the four window-start offsets (``kernels._movemean_offsets``), the
column's exclusive scan, the final pass's two prefixes started from those
and slid a frame at a time, the floor rounded to float32 once, ratio,
sigmoid and blend into the block's tile, the tap chain; or, past the
tile, the blend to a plane and the smoothing pass; n_movemean 1, 2, 20,
375 and past T. Segments of 1, 7 and 64 frames, T = 1, T below a segment
and T no multiple of it, 1, 19 and more taps than a segment holds, b at
48 kHz / hop 256 and 16 kHz / hop 128, silent columns and frames, top_db
80 and 40. The plain versions are held against the JAX package by
tests/test_torch_kernels.py, tests/test_torch_stationary.py and
tests/test_torch_tpugate.py.

Bounds: B's emulation within 1e-5 absolute of the plain mask (values in
[0, 1]; ten times tighter than the card's 1e-4): the carries see y before
its rounding to float32, about one float32 rounding of the floor. E with a
given threshold decides every cell as the plain version does, and its mask
is within 1e-6 (the tap chain's fmaf against the plain version's separate
products and sums); with its own statistics every decision that differs
lies within 2e-3 dB of the plain version's threshold. F's emulation
within 1e-6 of the plain mask, and within 1e-7 of it where a window holds
only silent frames (a floor of exactly 0 in both).
"""
import dataclasses
import pathlib
import re as regex

import numpy as np
import pytest
import torch

from noisereduce_tpu_torch.config import iir_b_coefficient
from noisereduce_tpu_torch.ops import dsp
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import (
    FM_LANE,
    FM_THREADS,
    FM_TILE_LANE,
    FM_WARPS,
    PART_COLS,
    SEG_B,
    SEG_E,
    SEG_F,
    SMEM_MAX,
    TILE_COLS,
    TILE_SEGS,
    TimeTilePlan,
    fm_mask_plan,
    fm_smem,
)

torch.set_num_threads(2)

F32 = np.float32
B_48K = iir_b_coefficient(2.0, 48000, 256)  # ~0.0027
B_16K = iir_b_coefficient(2.0, 16000, 128)  # ~0.0040
SEGS = (1, 7, 40, 64)
FRAMES = (1, 5, 150)
TAPS = {"1": dsp.tri_norm(0), "19": dsp.tri_norm(9), "141": dsp.tri_norm(70)}
CSRC = pathlib.Path(K.__file__).parent / "csrc"


def _planes(rows, n_frames, n_bins, seed):
    """Spectra with level drifts, a silent bin, and a silent run of frames
    (finite zeros in the floor)."""
    rng = np.random.default_rng(seed)
    level = np.exp(rng.standard_normal((rows, n_frames, 1)) * 0.5 + np.linspace(
        -1, 1, n_frames)[None, :, None])
    re = (rng.standard_normal((rows, n_frames, n_bins)) * level).astype(F32)
    im = (rng.standard_normal((rows, n_frames, n_bins)) * level).astype(F32)
    re[:, :, 1] = im[:, :, 1] = 0.0
    re[0, n_frames // 3 : n_frames // 2] = im[0, n_frames // 3 : n_frames // 2] = 0.0
    return re, im


def _mag(re, im):
    """time_tiles.cuh::mag_of: products and sum rounded to float32."""
    return np.sqrt(re * re + im * im)


def _fmaf(a, b, c):
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _smooth(raw, fs, t0, t1, n_frames, taps):
    """time_tiles.cuh::zero_frames and smooth_from_tile on (..., frames)
    raw values staged from frame fs: a tile of frames [t0 - n, t1 + n), n =
    len(taps) // 2, zero outside [0, T), then the fmaf chain over every
    tap, ascending, GROUP outputs at a time."""
    half = len(taps) // 2
    tile = np.zeros(raw.shape[:-1] + (t1 - t0 + 2 * half,), F32)
    lo, hi = max(0, t0 - half), min(n_frames, t1 + half)
    tile[..., lo - t0 + half : hi - t0 + half] = raw[..., lo - fs : hi - fs]
    acc = np.zeros(raw.shape[:-1] + (t1 - t0,), F32)  # each frame's chain, side by side
    for d in range(len(taps)):
        acc = _fmaf(F32(taps[d]), tile[..., d : d + t1 - t0], acc)
    return acc


def test_zero_padded_chain_is_the_skipping_chain():
    """fmaf(tap, 0, acc) == acc: the tile's zeros outside the plane give
    the bits of the chain that skips those frames (the column walk's)."""
    rng = np.random.default_rng(5)
    raw = rng.random((3, 40)).astype(F32)
    taps = dsp.tri_norm(9)
    want = np.empty_like(raw)
    for t in range(40):
        acc = np.zeros(3, F32)
        for d in range(max(0, 9 - t), min(19, 40 + 9 - t)):
            acc = _fmaf(F32(taps[d]), raw[:, t + d - 9], acc)
        want[:, t] = acc
    np.testing.assert_array_equal(_smooth(raw, 0, 0, 40, 40, taps), want)


# ---------------------------------------------------------------------------
# B
# ---------------------------------------------------------------------------
def _b_partials(mag, b, L, p_f, p_b):
    """ewma_partials_kernel: per segment, from zero carries, yl at the end
    (0) and at offset p_f (1), wl at the start (2) and at offset p_b (3),
    wl summed forward as sum_u b a^(u - start) yl[u]."""
    a = 1.0 - b
    rows, n_frames, nb = mag.shape
    n_segs = -(-n_frames // L)
    parts = np.zeros((4, rows, n_segs, nb))
    for q in range(n_segs):
        yl, fh, bk, bh = (np.zeros((rows, nb)) for _ in range(4))
        pw = pw2 = b
        for t in range(q * L, min(n_frames, q * L + L)):
            u = t - q * L
            yl = a * yl + b * mag[:, t].astype(np.float64)
            bk, pw = bk + pw * yl, pw * a
            if u >= p_b:
                bh, pw2 = bh + pw2 * yl, pw2 * a
            if u == p_f:
                fh = yl
        parts[:, :, q] = yl, fh, bk, bh
    return parts


def _b_carries(mag, parts, L, p_f, p_b, k):
    """ewma_carries_kernel: y forward from y[-1] = |Z|[0], w backward from
    w[T] = y[T-1]; leaves y[t0 - 1] in slot 0, y at offset p_f in slot 1,
    w[t0] in slot 2 and w at offset p_b in slot 3."""
    a, _, apf1, *ks = k
    full, last = ks[:4], ks[4:]
    n_frames = mag.shape[1]
    n_segs = parts.shape[2]
    n_last = n_frames - (n_segs - 1) * L
    y = mag[:, 0].astype(np.float64)
    for q in range(n_segs):
        n, (an, _, _, _) = (n_last, last) if q == n_segs - 1 else (L, full)
        yl_end = parts[0, :, q].copy()
        if p_f < n:
            parts[1, :, q] = apf1 * y + parts[1, :, q]
        parts[0, :, q] = y
        y = an * y + yl_end
    w = y
    for q in range(n_segs - 1, -1, -1):
        n, (an, r0, rp, ap) = (n_last, last) if q == n_segs - 1 else (L, full)
        yq = parts[0, :, q]
        if p_b < n:
            parts[3, :, q] = ap * w + (rp * yq + parts[3, :, q])
        w = an * w + (r0 * yq + parts[2, :, q])
        parts[2, :, q] = w  # w[t0]
    return parts


def _b_final(mag, parts, b, thresh, slope, L, halo, taps, K=TILE_SEGS):
    """nonstationary_final_kernel over blocks of K segments: each segment's
    y forward from y[t0 - 1] (the block's first from the carry before its
    halo), rounded to float32 in the tile; w backward from w[t1] (the
    block's last from the carry after its halo); the raw mask in float32;
    then each segment's tap chain over the block's tile."""
    a = 1.0 - b
    rows, n_frames, nb = mag.shape
    n_segs = parts.shape[2]
    out = np.empty_like(mag)
    for q0 in range(0, n_segs, K):
        qs = range(q0, min(n_segs, q0 + K))
        T0, T1 = q0 * L, min(n_frames, (qs[-1] + 1) * L)
        tile = np.zeros((rows, nb, T1 - T0 + 2 * halo), F32)  # frames T0 - halo ...
        for q in qs:
            t0, t1 = q * L, min(n_frames, q * L + L)
            fs = max(0, t0 - halo) if q == q0 else t0
            fe = min(n_frames, t1 + halo) if q == qs[-1] else t1
            y = (np.zeros((rows, nb)) if fs == 0 else
                 parts[1, :, (fs - 1) // L] if fs < t0 else parts[0, :, q])
            ys = np.empty((rows, nb, fe - fs), F32)
            for t in range(fs, fe):
                m = mag[:, t].astype(np.float64)
                y = m if t == 0 else a * y + b * m
                ys[..., t - fs] = y
            w = (np.zeros((rows, nb)) if fe == n_frames else
                 parts[3, :, fe // L] if fe > t1 else parts[2, :, q + 1])
            for t in range(fe - 1, fs - 1, -1):
                yt = ys[..., t - fs].astype(np.float64)
                w = yt if t == n_frames - 1 else a * w + b * yt
                wf = w.astype(F32)
                ratio = (mag[:, t] - wf) / np.where(wf == 0, F32(1), wf)
                z = (ratio - F32(thresh)) * F32(slope)
                with np.errstate(over="ignore"):
                    tile[..., t - T0 + halo] = F32(1) / (F32(1) + np.exp(-z))
        for q in qs:
            t0, t1 = q * L, min(n_frames, q * L + L)
            out[:, t0:t1] = np.moveaxis(
                _smooth(tile[..., t0 - T0:], t0 - halo, t0, t1, n_frames, taps), -1, 1)
    return out


def emulate_b(re, im, b, thresh, slope, taps, L, fused=True):
    """Kernel B as the sources compute it, with segments of L frames; not
    ``fused``: the raw mask with no halo, then the smoothing pass."""
    mag = _mag(re, im)
    halo = len(taps) // 2 if fused else 0
    p_f, p_b, k = K._ewma_constants(b, L, mag.shape[1], halo)
    parts = _b_carries(mag, _b_partials(mag, b, L, p_f, p_b), L, p_f, p_b, k)
    if fused:
        return _b_final(mag, parts, b, thresh, slope, L, halo, taps)
    raw = _b_final(mag, parts, b, thresh, slope, L, 0, np.ones(1))
    n_frames = mag.shape[1]
    return np.moveaxis(_smooth(np.moveaxis(raw, 1, -1), 0, 0, n_frames, n_frames, taps), -1, 1)


def _b_ref(re, im, b, taps):
    return K.nonstationary_mask_ref(torch.from_numpy(re), torch.from_numpy(im), b, 2.0,
                                    10.0, taps).numpy()


@pytest.mark.parametrize("b", [B_48K, B_16K], ids=["48k-hop256", "16k-hop128"])
@pytest.mark.parametrize("taps", list(TAPS), ids=[f"taps{k}" for k in TAPS])
@pytest.mark.parametrize("n_frames", FRAMES, ids=[f"T{t}" for t in FRAMES])
@pytest.mark.parametrize("L", SEGS, ids=[f"L{s}" for s in SEGS])
def test_nonstationary_segments_match_plain_mask(L, n_frames, taps, b):
    re, im = _planes(2, n_frames, 5, seed=L * 1000 + n_frames)
    got = emulate_b(re, im, b, 2.0, 10.0, TAPS[taps], L)
    ref = _b_ref(re, im, b, TAPS[taps])
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-5


@pytest.mark.parametrize("L", SEGS, ids=[f"L{s}" for s in SEGS])
@pytest.mark.parametrize("taps", ["19", "141"])
def test_nonstationary_smoothing_launch_matches_plain_mask(L, taps):
    """The path of a halo too wide for the tile: raw mask, then a
    separate smoothing pass over the plane."""
    re, im = _planes(2, 150, 5, seed=L + 7)
    got = emulate_b(re, im, B_16K, 2.0, 10.0, TAPS[taps], L, fused=False)
    assert np.abs(got.astype(np.float64) - _b_ref(re, im, B_16K, TAPS[taps])).max() <= 1e-5


def test_nonstationary_carries_are_the_serial_recurrence():
    """In float64 the combined carries give the serial y and w at the
    offsets they stand for, to 1e-12 x scale."""
    re, im = _planes(1, 150, 3, seed=3)
    mag = _mag(re, im).astype(np.float64)
    a, b = 1.0 - B_48K, B_48K
    y = np.empty_like(mag)
    y[:, 0] = mag[:, 0]
    for t in range(1, 150):
        y[:, t] = a * y[:, t - 1] + b * mag[:, t]
    w = np.empty_like(y)
    w[:, -1] = y[:, -1]
    for t in range(148, -1, -1):
        w[:, t] = a * w[:, t + 1] + b * y[:, t]
    for L, halo in ((7, 9), (64, 9), (64, 70), (1, 0)):
        p_f, p_b, k = K._ewma_constants(b, L, 150, halo)
        parts = _b_carries(mag.astype(F32), _b_partials(mag.astype(F32), b, L, p_f, p_b),
                           L, p_f, p_b, k)
        for q in range(parts.shape[2]):
            n = min(L, 150 - q * L)
            if p_f < n:
                np.testing.assert_allclose(parts[1, :, q], y[:, q * L + p_f], rtol=1e-12)
            if p_b < n:
                np.testing.assert_allclose(parts[3, :, q], w[:, q * L + p_b], rtol=1e-12)


# ---------------------------------------------------------------------------
# E
# ---------------------------------------------------------------------------
def _db(re, im):
    """stationary_mask.cu::db_of, float32 throughout."""
    return np.log(_mag(re, im) + F32(dsp.EPS_F64)) * F32(K._DB_PER_NEPER)


def emulate_e(re, im, thr, prop, taps, L, top_db, n_std=None, fused=True):
    """Kernel E as the sources compute it, with segments of L frames; thr
    (views, bins) or None for the own statistics. Returns (mask,
    decisions)."""
    db = _db(re, im)
    views, n_frames, nb = db.shape
    n_segs = -(-n_frames // L)
    seg = [slice(q * L, min(n_frames, q * L + L)) for q in range(n_segs)]
    mx = np.max([db[:, s].max(axis=1) for s in seg], axis=0)  # maxima, combine
    c = np.maximum(db, (mx - F32(top_db))[:, None])
    if thr is None:
        s1, s2 = np.zeros((views, nb)), np.zeros((views, nb))
        for s in seg:  # db_stats_kernel, then the column sums in order
            d = c[:, s].astype(np.float64) - mx[:, None].astype(np.float64)
            s1, s2 = s1 + d.sum(axis=1), s2 + (d * d).sum(axis=1)
        n = float(n_frames)
        var = np.maximum(s2 - s1 * s1 / n, 0.0) / max(n - 1.0, 1.0)
        th = mx + s1 / n + np.sqrt(var) * n_std
    else:
        th = thr.astype(np.float64)
    dec = c.astype(np.float64) > th[:, None]
    m = np.where(dec, F32(prop), F32(0)) + F32(1 - prop)
    if len(taps) == 1:
        return m * F32(taps[0]), dec
    mt = np.moveaxis(m, 1, -1)
    if not fused:  # the blend to a plane, then the smoothing pass
        return np.moveaxis(_smooth(mt, 0, 0, n_frames, n_frames, taps), -1, 1), dec
    halo = len(taps) // 2
    out = np.empty_like(m)
    for s in seg:
        fs = max(0, s.start - halo)
        tile = mt[..., fs : min(n_frames, s.stop + halo)]
        out[:, s] = np.moveaxis(_smooth(tile, fs, s.start, s.stop, n_frames, taps), -1, 1)
    return out, dec


@pytest.mark.parametrize("top_db", [80.0, 40.0])
@pytest.mark.parametrize("taps", list(TAPS), ids=[f"taps{k}" for k in TAPS])
@pytest.mark.parametrize("n_frames", FRAMES, ids=[f"T{t}" for t in FRAMES])
@pytest.mark.parametrize("L", SEGS, ids=[f"L{s}" for s in SEGS])
def test_stationary_segments_with_a_threshold_decide_as_plain(L, n_frames, taps, top_db):
    re, im = _planes(4, n_frames, 6, seed=L * 100 + n_frames + int(top_db))
    rng = np.random.default_rng(n_frames)
    thr = (_db(re, im).mean(axis=1)[::2] + rng.standard_normal((2, 6))).astype(F32)
    args = (torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(thr), 2)
    got, dec = emulate_e(re, im, np.repeat(thr, 2, axis=0), 0.8, TAPS[taps], L, top_db)
    ref_dec = K.stationary_mask_ref(*args, 1.0, (1.0,), top_db=top_db).numpy() > 0.5
    np.testing.assert_array_equal(dec, ref_dec)
    ref = K.stationary_mask_ref(*args, 0.8, TAPS[taps], top_db=top_db).numpy()
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-6


@pytest.mark.parametrize("top_db", [80.0, 40.0])
@pytest.mark.parametrize("n_frames", FRAMES, ids=[f"T{t}" for t in FRAMES])
@pytest.mark.parametrize("L", SEGS, ids=[f"L{s}" for s in SEGS])
def test_stationary_segments_own_statistics_decide_within_the_rule(L, n_frames, top_db):
    re, im = _planes(3, n_frames, 6, seed=L * 10 + n_frames)
    _, dec = emulate_e(re, im, None, 1.0, np.ones(1), L, top_db, n_std=1.5)
    db = torch.from_numpy(_db(re, im))
    mx = db.amax(dim=-2, keepdim=True)
    db = torch.maximum(db, mx - top_db)
    margin = (db.double() - K._self_threshold(db, mx, 1.5)[:, None, :]).numpy()
    flips = dec != (margin > 0)
    assert not flips.any() or np.abs(margin[flips]).max() <= 2e-3
    ref = K.stationary_mask_ref(torch.from_numpy(re), torch.from_numpy(im), None, 1, 1.0,
                                (1.0,), top_db=top_db, n_std=1.5).numpy()
    assert ((ref > 0.5) != dec).sum() == flips.sum()


def test_double_compare_is_the_float_compare_with_thr_rounded_down():
    """stationary_final_kernel compares a float dB with a double threshold
    as db > __double2float_rd(th): no float lies in (rd(th), th]."""
    rng = np.random.default_rng(21)
    th = rng.uniform(-120, 20, 20000)
    f = th.astype(F32)
    rd = np.where(f.astype(np.float64) > th, np.nextafter(f, F32(-np.inf)), f)
    db = np.concatenate([rd, np.nextafter(rd, F32(np.inf)), np.nextafter(rd, F32(-np.inf)),
                         rng.uniform(-120, 20, 20000).astype(F32)])
    th4 = np.tile(th, 4)
    np.testing.assert_array_equal(db.astype(np.float64) > th4, db > np.tile(rd, 4))


@pytest.mark.parametrize("taps", ["19", "141"])
def test_stationary_smoothing_launch_matches_plain_mask(taps):
    re, im = _planes(2, 150, 6, seed=11)
    thr = _db(re, im).mean(axis=1).astype(F32)
    got, _ = emulate_e(re, im, thr, 0.8, TAPS[taps], 7, 80.0, fused=False)
    ref = K.stationary_mask_ref(torch.from_numpy(re), torch.from_numpy(im),
                                torch.from_numpy(thr), 1, 0.8, TAPS[taps]).numpy()
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-6


# ---------------------------------------------------------------------------
# F
# ---------------------------------------------------------------------------
def _f_partials(mag, L, offsets):
    """movemean_partials_kernel and movemean_prefix_kernel: per segment the
    float64 sum of |Z| in frame order from 0, and that sum at each offset
    (the sum of the segment's frames before it); then the column's
    exclusive scan of the segment sums, P_q, with P[T] after them."""
    rows, n_frames, nb = mag.shape
    n_segs = -(-n_frames // L)
    pre = np.zeros((rows, n_segs + 1, nb))
    offs = np.zeros((4, rows, n_segs, nb))
    for q in range(n_segs):
        s = np.zeros((rows, nb))
        for t in range(q * L, min(n_frames, q * L + L)):
            for k, o in enumerate(offsets):
                if t - q * L == o:
                    offs[k, :, q] = s
            s = s + mag[:, t].astype(np.float64)
        pre[:, q] = s
    total = np.zeros((rows, nb))
    for q in range(n_segs):
        total, pre[:, q] = total + pre[:, q], total
    pre[:, n_segs] = total
    return pre, offs


class _Prefix:
    """torch_nonstationary_mask.cu::Prefix: P[k] = P_q + s, q = k // L, s
    the segment's sum of its first k mod L frames; started from the
    partials at the offset that k mod L must equal, slid one frame at a
    time, restarted from P_q at a segment boundary."""

    def __init__(self, pre, offs, slot, offsets, pos, n_frames, L):
        self.pre, self.L = pre, L
        self.k = min(max(pos, 0), n_frames)
        q = self.k // L
        if self.k == n_frames:
            self.P, self.s = pre[:, -1], np.zeros(pre.shape[::2])
        else:
            self.P = pre[:, q]
            if self.k:
                assert self.k % L == offsets[slot], "a window starts off its offset"
            self.s = offs[slot, :, q] if self.k else np.zeros(pre.shape[::2])

    def value(self):
        return self.P + self.s

    def add(self, z):
        self.s = self.s + z.astype(np.float64)
        self.k += 1
        if self.k % self.L == 0:
            self.P, self.s = self.pre[:, self.k // self.L], np.zeros_like(self.s)


def _f_final(mag, pre, offs, offsets, n, thresh, temp, prop, taps, L, halo, K=TILE_SEGS):
    """movemean_final_kernel over blocks of K segments: each segment's
    frames (the block's first also the halo before it, its last the halo
    after it) from both prefixes, the floor rounded to float32 once, ratio,
    sigmoid and blend in float32 into the block's tile (one tap: straight
    to out, scaled); then each segment's tap chain over the tile."""
    rows, n_frames, nb = mag.shape
    left = (n - 1) // 2
    right = n - 1 - left
    n_segs = pre.shape[1] - 1
    to_out = len(taps) == 1
    scale = F32(taps[0]) if to_out else F32(1)
    out = np.empty_like(mag)
    for q0 in range(0, n_segs, K):
        qs = range(q0, min(n_segs, q0 + K))
        T0, T1 = q0 * L, min(n_frames, (qs[-1] + 1) * L)
        tile = np.zeros((rows, nb, T1 - T0 + 2 * halo), F32)  # frames T0 - halo ...
        for q in qs:
            t0, t1 = q * L, min(n_frames, q * L + L)
            fs = max(0, t0 - halo) if q == q0 else t0
            fe = min(n_frames, t1 + halo) if q == qs[-1] else t1
            early = fs % L != 0
            a = _Prefix(pre, offs, 2 if early else 0, offsets, fs + right + 1, n_frames, L)
            b = _Prefix(pre, offs, 3 if early else 1, offsets, fs - left, n_frames, L)
            for t in range(fs, fe):
                ma = ((a.value() - b.value()) * (1.0 / n)).astype(F32)
                ratio = (mag[:, t] - ma) / np.where(ma == 0, F32(1), ma)
                z = (ratio - F32(thresh)) / F32(temp)
                with np.errstate(over="ignore"):
                    sg = F32(1) / (F32(1) + np.exp(-z))
                m = (sg * F32(prop) + F32(1.0 - prop)) * scale
                if to_out:
                    out[:, t] = m
                else:
                    tile[..., t - T0 + halo] = m
                if t + 1 < fe:
                    if t + right + 1 < n_frames:
                        a.add(mag[:, t + right + 1])
                    if t - left >= 0:
                        b.add(mag[:, t - left])
        if not to_out:
            for q in qs:
                t0, t1 = q * L, min(n_frames, q * L + L)
                out[:, t0:t1] = np.moveaxis(
                    _smooth(tile[..., t0 - T0:], t0 - halo, t0, t1, n_frames, taps), -1, 1)
    return out


def emulate_f(re, im, n, thresh, temp, prop, taps, L, fused=True):
    """Kernel F as the sources compute it, with segments of L frames; not
    ``fused``: the blend with no halo to a plane, then the smoothing
    pass."""
    mag = _mag(re, im)
    halo = len(taps) // 2 if fused else 0
    offsets = K._movemean_offsets(n, L, halo)
    pre, offs = _f_partials(mag, L, offsets)
    if fused or len(taps) == 1:
        return _f_final(mag, pre, offs, offsets, n, thresh, temp, prop, taps, L, halo)
    raw = _f_final(mag, pre, offs, offsets, n, thresh, temp, prop, np.ones(1), L, 0)
    n_frames = mag.shape[1]
    return np.moveaxis(_smooth(np.moveaxis(raw, 1, -1), 0, 0, n_frames, n_frames, taps), -1, 1)


def _f_ref(re, im, n, thresh, temp, prop, taps):
    return K.torch_nonstationary_mask_ref(torch.from_numpy(re), torch.from_numpy(im), n,
                                          thresh, temp, prop, taps).numpy()


F_WINDOWS = {"n1": 1, "n2": 2, "n20": 20, "n375": 375, "n-past-T": None}  # None: T + 7
F_TAPS = {"1": (0.75,), "19": dsp.tri_norm(9), "141": dsp.tri_norm(70),
          "141-launch": dsp.tri_norm(70)}


@pytest.mark.parametrize("taps", list(F_TAPS), ids=[f"taps{k}" for k in F_TAPS])
@pytest.mark.parametrize("n_frames", FRAMES, ids=[f"T{t}" for t in FRAMES])
@pytest.mark.parametrize("L", (1, 7, 64), ids=["L1", "L7", "L64"])
@pytest.mark.parametrize("window", list(F_WINDOWS))
def test_movemean_segments_match_plain_mask(window, L, n_frames, taps):
    """Kernel F's partials, prefix scan and final pass (and, for
    "141-launch", the blend to a plane and the smoothing launch) within
    1e-6 of the plain mask, at TorchGate's threshold and temperature and
    prop 0.8. The planes hold a silent bin and a silent run of frames."""
    n = F_WINDOWS[window] or n_frames + 7
    re, im = _planes(2, n_frames, 5, seed=L * 100 + n_frames + n)
    args = (n, 2.0, 0.1, 0.8, F_TAPS[taps])
    got = emulate_f(re, im, *args, L, fused=taps != "141-launch")
    ref = _f_ref(re, im, *args)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-6


@pytest.mark.parametrize("L", (1, 7, 64), ids=["L1", "L7", "L64"])
@pytest.mark.parametrize("n", (2, 9, 20, 21))
def test_movemean_silent_windows_give_a_zero_floor(L, n):
    """Where a window holds only silent frames the plain version's floor is
    exactly 0 (divisor 1, ratio 0); both prefixes of F's window are then
    the same bits, so F's is exactly 0 too. Any residue would give ratio
    -1, which a soft sigmoid (threshold -0.5, temperature 1) turns into a
    mask 0.24 lower. Levels span 10^-6 to 10^3, so the float64 sums of
    |Z| round (a narrow range adds exactly, residue or not)."""
    re, im = _planes(2, 150, 5, seed=n + L)
    level = 10.0 ** np.random.default_rng(n * L).uniform(-6, 3, re.shape)
    re, im = (re * level).astype(F32), (im * level).astype(F32)
    re[1, 20:31] = im[1, 20:31] = 0.0  # a second silent run, 11 frames
    mag = torch.from_numpy(_mag(re, im))
    silent = (dsp.moving_average_same(mag, n, axis=-2) == 0).numpy()
    assert silent.any()
    args = (n, -0.5, 1.0, 1.0, (1.0,))
    got = emulate_f(re, im, *args, L)
    ref = _f_ref(re, im, *args)
    np.testing.assert_allclose(got[silent], ref[silent], rtol=0, atol=1e-7)
    assert np.abs(got.astype(np.float64) - ref).max() <= 1e-6


@pytest.mark.parametrize("n", (1, 2, 20, 375, 1875))
@pytest.mark.parametrize("halo", (0, 9, 70, 780))
def test_movemean_offsets_are_where_windows_start(n, halo):
    """Every final-pass thread's window starts at a frame whose offset in
    its segment is the partial it reads: t0 + right + 1 and t0 - left for a
    segment's own start, the same less the halo for a block's first warp
    (unless clipped at frame 0, where the segment-start offsets serve)."""
    L, n_frames = SEG_F, 2579
    left, right = (n - 1) // 2, n - 1 - (n - 1) // 2
    ox, oy, oz, ow = K._movemean_offsets(n, L, halo)
    for q in range(-(-n_frames // L)):
        t0 = q * L
        for fs in {t0, max(0, t0 - halo)}:
            for pos, (plain, early) in ((fs + right + 1, (ox, oz)), (fs - left, (oy, ow))):
                if 0 < pos < n_frames:
                    assert pos % L == (early if fs % L else plain)


# ---------------------------------------------------------------------------
# G
# ---------------------------------------------------------------------------
def _g_scan(A, B, up):
    """A warp's shuffle scan (Kogge-Stone) of the maps x -> A x + B over its
    32 lanes (the last axis), inclusive: lane l composes lanes 0..l (``up``)
    or l..31, each step B = A B' + B, A = A A' with the other lane's (A',
    B') composed first."""
    lane = np.arange(32)
    d = 1
    while d < 32:
        pa, pb = np.roll(A, d if up else -d, -1), np.roll(B, d if up else -d, -1)
        take = lane >= d if up else lane + d < 32
        A, B = np.where(take, A * pa, A), np.where(take, A * pb + B, B)
        d *= 2
    return A, B


def _g_stretch(m, t0, n_frames, lane_len, warps, k, seeds, thresh, slope, partials=False):
    """fm_mask_kernel on a stretch m (cols, tl) of |Z| at frames [t0, t0 +
    tl): the regions of lane_len frames walked from zero carries, the scans
    of 32 x ``warps`` lanes a column with the warps' aggregates composed in
    order, then each region again, y forward from the exact y before it and
    rounded to float32, w backward from the exact w after it over that y,
    rounded to float32, and the masks. ``seeds``: the y carried in and the w
    after the stretch, (cols,) each, or None for the resident route's
    (|Z|[0] and y at the end). ``partials``: return the stretch's y at its
    end and w at its start instead of the mask."""
    a, b, aL, rL, aN, rN = k[:6]
    cols, tl = m.shape
    P = 32 * warps
    r0 = np.arange(P) * lane_len
    n = np.clip(tl - r0, 0, lane_len)
    yl, wl, pw = np.zeros((cols, P)), np.zeros((cols, P)), np.full(P, b)
    for u in range(lane_len):
        live = u < n
        x = m[:, np.minimum(r0 + u, tl - 1)].astype(np.float64)
        yl = np.where(live, a * yl + b * x, yl)
        wl = np.where(live, pw * yl + wl, wl)
        pw = np.where(live, pw * a, pw)
    an = np.broadcast_to(np.where(n == lane_len, aL, np.where(n == 0, 1.0, aN)), (cols, P))
    rn = np.where(n == lane_len, rL, np.where(n == 0, 0.0, rN))
    shape = (cols, warps, 32)
    first, last = np.arange(32) == 0, np.arange(32) == 31

    A, B = _g_scan(an.reshape(shape), yl.reshape(shape), up=True)
    y = m[:, 0].astype(np.float64) if seeds is None else seeds[0]
    y_w = np.empty((cols, warps, 1))
    for q in range(warps):
        y_w[:, q, 0] = y
        y = A[:, q, 31] * y + B[:, q, 31]
    y_in = np.where(first, y_w, np.roll(A, 1, -1) * y_w + np.roll(B, 1, -1)).reshape(cols, P)

    A, C = _g_scan(an.reshape(shape), (rn * y_in + wl).reshape(shape), up=False)
    w = y if seeds is None else seeds[1]
    w_w = np.empty((cols, warps, 1))
    for q in range(warps - 1, -1, -1):
        w_w[:, q, 0] = w
        w = A[:, q, 0] * w + C[:, q, 0]
    if partials:
        return y, w
    wd = np.where(last, w_w, np.roll(A, -1, -1) * w_w + np.roll(C, -1, -1)).reshape(cols, P)

    ys = np.full((cols, tl), np.nan, F32)  # y, then w, in the second plane
    yd = y_in
    for u in range(lane_len):
        idx = np.minimum(r0 + u, tl - 1)
        x = m[:, idx].astype(np.float64)
        yd = np.where(u < n, np.where(t0 + idx == 0, x, a * yd + b * x), yd)
        ys[:, idx[u < n]] = yd.astype(F32)[:, u < n]
    for u in range(lane_len - 1, -1, -1):
        live = u < n
        idx = np.minimum(r0 + u, tl - 1)
        yt = ys[:, idx].astype(np.float64)
        wd = np.where(live, np.where(t0 + idx == n_frames - 1, yt, a * wd + b * yt), wd)
        ys[:, idx[live]] = wd.astype(F32)[:, live]
    ratio = (m - ys) / np.where(ys == 0, F32(1), ys)
    z = (ratio - F32(thresh)) * F32(slope)
    with np.errstate(over="ignore"):
        return F32(1) / (F32(1) + np.exp(-z))


def emulate_g(mag, b, thresh, slope, route=None, lane_len=FM_TILE_LANE):
    """Kernel G as the source computes it on a (columns, frames) |Z|, on
    ``fm_mask_plan``'s route (or ``route``): resident, each column one
    stretch; tiled, the tiles' partials from zero carries, the column pass
    over them with the tile constants, and each tile again from its exact
    carries. The tiled route's regions here are ``lane_len`` frames (the
    source's FM_TILE_LANE by default), so that a short column takes
    several tiles."""
    n_cols, T = mag.shape
    plan = fm_mask_plan(n_cols, T, route)
    if plan.route == "tiled" and lane_len != plan.lane_len:
        tile = FM_THREADS * lane_len
        plan = dataclasses.replace(plan, lane_len=lane_len, tile_len=tile, n_tiles=-(-T // tile))
    k = K._fm_constants(b, plan.lane_len, plan.short_lane, plan.tile_len, plan.last_tile)
    run = (T, plan.lane_len, FM_WARPS // plan.cols, k)
    if plan.route == "resident":
        return _g_stretch(mag, 0, *run, None, thresh, slope)
    L, nt = plan.tile_len, plan.n_tiles
    zero = np.zeros(n_cols)
    parts = [_g_stretch(mag[:, q * L : (q + 1) * L], q * L, *run, (zero, zero), thresh, slope,
                        partials=True) for q in range(nt)]
    aT, rT, aU, rU = k[6:]
    y, y_in, w_out = mag[:, 0].astype(np.float64), [], [None] * nt
    for q in range(nt):
        y_in.append(y)
        y = (aU if q == nt - 1 else aT) * y + parts[q][0]
    w = y
    for q in range(nt - 1, -1, -1):
        w_out[q] = w
        an, rn = (aU, rU) if q == nt - 1 else (aT, rT)
        w = an * w + (rn * y_in[q] + parts[q][1])
    return np.concatenate([
        _g_stretch(mag[:, q * L : (q + 1) * L], q * L, *run, (y_in[q], w_out[q]), thresh, slope)
        for q in range(nt)], axis=1)


def _fm_planes(rows, n_bins, n_frames, seed):
    """A frequency-major complex64 spectrogram with level drifts, a silent
    bin (an all-zero column) and a silent run of frames."""
    re, im = (np.moveaxis(v, 1, 2) for v in _planes(rows, n_frames, n_bins, seed))
    return (re + 1j * im).astype(np.complex64)


def _fm_mag(z):
    return _mag(z.real, z.imag).reshape(-1, z.shape[-1])


# (frames, route, tiled lane_len): the resident route with one warp a
# column (T 1, 15, 16, 17), two (700), four (1,500) and eight (2,579; 7,000
# and 20,000 with regions of 29 and 79 frames); the tiled route forced with
# regions of 1, 3 and 17 frames, and reached by a T past the resident
# route's limit (40,000)
FM_CASES = {f"T{t}-{r}{'' if r == 'resident' else n}": (t, r, n)
            for t in (1, FM_LANE - 1, FM_LANE, FM_LANE + 1, 700, 2579)
            for r, n in (("resident", 0), ("tiled", 1), ("tiled", 3), ("tiled", 17))}
FM_CASES.update({"T1500-resident": (1500, "resident", 0),
                 "T7000-resident": (7000, "resident", 0),
                 "T20000-resident": (20000, "resident", 0),
                 "T40000-tiled": (40000, None, FM_TILE_LANE)})


@pytest.mark.parametrize("b", [B_48K, B_16K], ids=["48k-hop256", "16k-hop128"])
@pytest.mark.parametrize("case", list(FM_CASES))
def test_fm_routes_match_plain_mask(case, b):
    """Kernel G's routes within 1e-5 of the plain mask (B's bound), finite,
    every frame written; the planes hold an all-zero column."""
    n_frames, route, lane_len = FM_CASES[case]
    z = _fm_planes(2, 3, n_frames, seed=n_frames + lane_len)
    got = emulate_g(_fm_mag(z), b, 2.0, 10.0, route, lane_len or FM_TILE_LANE)
    ref = K.fm_nonstationary_mask_ref(torch.from_numpy(z), b, 2.0, 10.0).numpy()
    plan = fm_mask_plan(6, n_frames, route)
    assert plan.route == (route or "tiled")
    assert np.isfinite(got).all()
    assert np.abs(got.reshape(ref.shape).astype(np.float64) - ref).max() <= 1e-5


@pytest.mark.parametrize("route,lane_len", [("resident", 0), ("tiled", 3), ("tiled", 17)])
@pytest.mark.parametrize("n_frames", [33, 700, 2579])
def test_fm_routes_match_jax_row6(n_frames, route, lane_len):
    """Kernel G's routes against TPU row 6 as the JAX package's tests run
    it on the CPU (the Pallas kernel in interpret mode), at
    tests/test_torch_mask.py's bound, 2e-5; the silent column included."""
    import jax.numpy as jnp

    from noisereduce_tpu.ops.pallas_mask import fused_nonstationary_mask as j_mask

    z = _fm_planes(2, 5, n_frames, seed=7 * n_frames)
    got = emulate_g(_fm_mag(z), B_48K, 2.0, 10.0, route, lane_len or FM_TILE_LANE)
    want = np.asarray(j_mask(jnp.asarray(z), B_48K, 2.0, 10.0, interpret=True))
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=2e-5)


def test_fm_carries_are_the_serial_recurrence():
    """In float64 the scans give the serial y before every region and w
    after it, to 1e-12 x scale, with one, two, four and eight warps a
    column."""
    z = _fm_planes(1, 2, 3000, seed=4)
    mag = _fm_mag(z).astype(np.float64)
    a, b = 1.0 - B_48K, B_48K
    y = np.empty_like(mag)
    y[:, 0] = mag[:, 0]
    for t in range(1, mag.shape[1]):
        y[:, t] = a * y[:, t - 1] + b * mag[:, t]
    w = np.empty_like(y)
    w[:, -1] = y[:, -1]
    for t in range(mag.shape[1] - 2, -1, -1):
        w[:, t] = a * w[:, t + 1] + b * y[:, t]
    for warps, lane_len in ((1, 95), (2, 47), (4, 25), (8, 13)):
        k = K._fm_constants(b, lane_len, 3000 - 2999 // lane_len * lane_len, 3000, 3000)
        seeds = (mag[:, 0], y[:, -1])
        y_end, w_start = _g_stretch(mag, 0, 3000, lane_len, warps, k, seeds, 2.0, 10.0,
                                    partials=True)
        np.testing.assert_allclose(y_end, y[:, -1], rtol=1e-12)
        np.testing.assert_allclose(w_start, w[:, 0], rtol=1e-12)


@pytest.mark.parametrize("n_frames", [1, 2, 15, 16, 17, 81, 700, 1500, 2579, 7000, 20000, 29020,
                                      29021, 60000])
def test_fm_plan_covers_every_frame_with_odd_regions(n_frames):
    """Every frame lies in one region of one thread; regions are odd (the
    32 lanes of a warp read 32 banks); a block's shared memory fits; the
    resident route takes more than one column a block only while regions
    stay within FM_LANE frames."""
    plan = fm_mask_plan(39501, n_frames)
    assert plan.lane_len % 2 == 1 and plan.smem_bytes <= SMEM_MAX
    assert plan.smem_bytes == fm_smem(plan.cols, plan.tile_len)
    lanes = 32 * (FM_WARPS // plan.cols)
    assert plan.tile_len <= lanes * plan.lane_len
    assert (plan.n_tiles - 1) * plan.tile_len < n_frames <= plan.n_tiles * plan.tile_len
    assert 1 <= plan.short_lane <= plan.lane_len
    if plan.cols > 1:
        assert plan.lane_len <= FM_LANE


def test_fm_route_follows_the_shared_memory():
    """The resident route holds a column while its two planes (|Z|, and y
    then w) fit a block's 232,448 bytes (to 29,020 frames, one column a
    block); one frame more takes the tiled route, tiles of 256 x 15
    frames. At the row-6 cell (2,579 frames) a block holds one column,
    eight warps, regions of 11 frames, in 20,908 bytes."""
    last = max(t for t in range(20000, 40000) if fm_smem(1, t) <= SMEM_MAX)
    assert last == 29020
    assert fm_mask_plan(10, last).route == "resident"
    assert fm_mask_plan(10, last + 1).route == "tiled"
    assert fm_mask_plan(10, last + 1).tile_len == 256 * FM_TILE_LANE
    cell = fm_mask_plan(77 * 513, 2579)
    assert (cell.route, cell.cols, cell.lane_len) == ("resident", 1, 11)
    assert cell.smem_bytes == 8 * 32 + 4 * (3 + 2 * 2580) == 20908
    assert cell.blocks == 77 * 513
    with pytest.raises(ValueError):
        fm_mask_plan(10, last + 1, "resident")


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------
def test_tile_constants_match_the_sources():
    def const(name, file):
        src = (CSRC / file).read_text()
        return int(regex.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TILE_COLS", "time_tiles.cuh") == TILE_COLS
    assert const("TILE_SEGS", "time_tiles.cuh") == TILE_SEGS
    assert const("PART_COLS", "time_tiles.cuh") == PART_COLS
    assert const("SEG", "nonstationary_mask.cu") == SEG_B
    assert const("SEG", "stationary_mask.cu") == SEG_E
    assert const("SEG", "torch_nonstationary_mask.cu") == SEG_F
    assert SEG_B % const("GROUP", "time_tiles.cuh") == SEG_E % 8 == SEG_F % 8 == 0
    assert const("THREADS", "fm_nonstationary_mask.cu") == FM_THREADS == 32 * FM_WARPS


@pytest.mark.parametrize("words,n_taps,seg", [(2, 19, SEG_B), (2, 1, SEG_B), (1, 19, SEG_E),
                                            (0, 1, SEG_E)],
                         ids=["B", "B-unit-tap", "E", "E-one-tap"])
def test_tile_plan_fills_the_card_at_the_headline(words, n_taps, seg):
    """77 views x 2,579 frames x 513 bins (960 s at 48 kHz, hop 256, 19
    time taps): the final pass's tile fits a block's 227 KB of shared
    memory with its halo, and each segment pass has at least 10,000
    blocks (the column walk had 309)."""
    plan = TimeTilePlan(77, 2579, 513, n_taps, words, seg)
    assert plan.fused and plan.halo == n_taps // 2
    assert plan.smem_bytes <= SMEM_MAX == 232448
    assert plan.n_segs == -(-2579 // seg)
    assert min(plan.final_blocks, plan.part_blocks) >= 10000


@pytest.mark.parametrize("words,seg,h_fused", [(2, SEG_B, 374), (1, SEG_E, 780)], ids=["B", "E"])
@pytest.mark.parametrize("over", [0, 1], ids=["fits", "past"])
def test_tile_plan_takes_the_smoothing_launch_past_the_tile(words, seg, h_fused, over):
    """There is no cap on the taps: a halo whose tile exceeds shared memory
    (B stages two words a frame, E one) takes the raw plane and the
    smoothing launch (halo 0); E with one tap stages nothing."""
    plan = TimeTilePlan(2, 5000, 513, 2 * (h_fused + over) + 1, words, seg)
    assert plan.fused == (not over)
    assert plan.halo == (0 if over else h_fused)
    assert plan.smem_bytes <= SMEM_MAX
    assert TimeTilePlan(2, 5000, 513, 1, 0, seg).smem_bytes == 0


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm for selector nibbles 0-7: result byte i is byte
    (sel >> 4i) & 7 of the 8 bytes of x (0-3) then y (4-7)."""
    src = [(x >> (8 * k)) & 0xFF for k in range(4)] + [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


@pytest.mark.parametrize("off", (0, 1), ids=["even", "odd"])
@pytest.mark.parametrize("n_bins", (513, 552, 1, 2))
def test_bf16_words_hold_each_element_in_the_half_staged_picks(n_bins, off):
    """Kernel B's bf16 staging (time_tiles.cuh::stage, Staged; planes.cuh::
    word_of, element_of) on a (rows, frames, n_bins) plane that starts
    ``off`` elements into a 4-byte-aligned storage: the aligned word of
    each element, with the half that at0 ^ (t & step) picks through the
    source's PRMT selectors, widens to that element, for n_bins odd (the
    half flips every frame) and even; the first element's word reaches 2
    bytes before the plane at an odd offset, the last element's 2 bytes past
    it where the plane ends at an odd one."""
    src = (CSRC / "planes.cuh").read_text()
    hi_sel, lo_sel = (int(v, 16) for v in regex.search(
        r"high \? (0x[0-9a-f]+)u : (0x[0-9a-f]+)u", src).groups())
    rows, T = 3, 37
    n = rows * T * n_bins
    rng = np.random.default_rng(n_bins + off)
    store = np.full(off + n + 1, 0x7FC1, np.int64)  # NaN around the plane
    store[off : off + n] = rng.integers(0, 1 << 16, n)
    row, t, b = (a.ravel() for a in np.meshgrid(np.arange(rows), np.arange(T), np.arange(n_bins),
                                                indexing="ij"))
    base = row * T * n_bins + b  # Cell::base, the column's frame 0
    e = off + base + t * n_bins  # the element's index in the storage; its byte address 2e
    w = 2 * (e // 2)  # its aligned word's first element
    word = store[w] | (store[w + 1] << 16)
    at0, step = (off + base) & 1, n_bins & 1  # Staged: the plane's address >> 1 is off
    high = at0 ^ (t & step)
    assert np.array_equal(high, e & 1)  # bit 1 of the byte address 2e
    got = np.array([_byte_perm(int(x), 0, hi_sel if h else lo_sel) for x, h in zip(word, high)])
    assert np.array_equal(got, store[e] << 16)  # planes::widen of the element
    # words outside the plane: before it at an odd offset, past it where it ends at an odd one
    assert (w.min() < off) == bool(off % 2) and (w.max() + 1 == off + n) == bool((off + n) % 2)


def test_short_planes_have_one_segment():
    for n_frames in (1, 5, SEG_B):
        assert TimeTilePlan(1, n_frames, 513, 19, 2, SEG_B).n_segs == 1
    assert TimeTilePlan(1, SEG_B + 1, 513, 19, 2, SEG_B).n_segs == 2


@pytest.mark.parametrize("half", [0, 9, 70, 780, 781, 2000])
def test_movemean_plan_route_follows_the_shared_memory(half):
    """F's route is the tile plan's: a blend tile of one word a frame, 32
    columns x (4 x 64 + 2h) frames, smooths in the final pass while it fits
    a block's 232,448 bytes (h <= 780); past that the blend goes to a plane
    and the smoothing launch takes it (halo 0); one tap stages nothing.
    The window's far ends are read from device memory on every route, so
    n_movemean never enters the plan."""
    n_taps = 2 * half + 1
    plan = TimeTilePlan(77, 2579, 513, n_taps, 1 if n_taps > 1 else 0, SEG_F)
    tile = 4 * TILE_COLS * (TILE_SEGS * SEG_F + 2 * half)
    if n_taps == 1:
        assert plan.fused and plan.halo == 0 and plan.smem_bytes == 0
    else:
        assert plan.fused == (tile <= SMEM_MAX) == (half <= 780)
        assert plan.halo == (half if plan.fused else 0)
        assert plan.smem_bytes == (tile if plan.fused else 4 * TILE_COLS * TILE_SEGS * SEG_F)
    assert plan.smem_bytes <= SMEM_MAX


def test_movemean_plan_fills_the_card_at_the_torch_headline():
    """77 views x 2,579 frames x 513 bins, 19 time taps: the tile fits with
    its halo (34 KB, six blocks an SM) and each segment pass has at least
    10,000 blocks (the column walk had 309)."""
    plan = TimeTilePlan(77, 2579, 513, 19, 1, SEG_F)
    assert plan.fused and plan.halo == 9 and plan.n_segs == 41
    assert plan.smem_bytes == 4 * 32 * (256 + 18) and 6 * plan.smem_bytes <= 233472
    assert min(plan.final_blocks, plan.part_blocks) >= 10000


@pytest.mark.parametrize("n_movemean,temp", [(0, 0.02), (-3, 0.02), (20, 0.0), (20, float("inf")),
                                             (20, float("nan")), (20, 1e-40)])
def test_movemean_refuses_what_the_kernel_cannot_divide_by(n_movemean, temp):
    """F's wrapper refuses a window under one frame, on the CPU as on the
    card. A temp that is not a normal float32 is taken since the kernel
    divides by it exactly (its fast division serves the normal ones): the
    plain version's sigmoid((ratio - 0.5) / temp), a subnormal temp read
    as a zero, as the JAX package's division reads it (0: a step, NaN
    where the ratio is exactly the threshold; inf: 0.5)."""
    z = torch.ones(1, 4, 3)
    if n_movemean < 1:
        with pytest.raises(ValueError, match="n_movemean"):
            K.torch_nonstationary_mask(z, z, n_movemean, 0.5, temp, 1.0, (1.0,))
        return
    rng = np.random.default_rng(4)
    re, im = (torch.as_tensor(rng.standard_normal((1, 30, 3)).astype(np.float32))
              for _ in range(2))
    got = K.torch_nonstationary_mask(re, im, n_movemean, 0.5, temp, 1.0, (1.0,))
    mag = torch.sqrt(re * re + im * im)
    ma = dsp.moving_average_same(mag, n_movemean, axis=-2)
    x = (mag - ma) / torch.where(ma == 0, 1.0, ma) - 0.5
    want = torch.sigmoid(x / (0.0 if temp == 1e-40 else temp))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("temp", [-0.02, 1.2e-38, 5.0])
def test_movemean_takes_any_normal_temp(temp):
    """A negative or tiny normal temp is taken; the plain version's mask is
    finite (a tiny temp saturates the sigmoid, which the kernel's overflow
    guard keeps)."""
    rng = np.random.default_rng(3)
    re, im = (torch.as_tensor(rng.standard_normal((2, 9, 5)).astype(np.float32))
              for _ in range(2))
    out = K.torch_nonstationary_mask(re, im, 4, 0.5, temp, 0.9, (0.25, 0.5, 0.25))
    assert out.shape == re.shape and bool(torch.isfinite(out).all())
