"""PyTorch port: the FFT route of kernels A and D (``csrc/spectra_fft.cu``,
``csrc/istft_fft.cu`` over ``csrc/fft_smem.cuh``), emulated in float64
numpy as the sources compute them: the frame-tile loader with its view and
signal bounds, the host tables, the Stockham stage order, the real-FFT
split and unsplit, and D's overlap-add of runs with halo frames, the
envelope table and the trim. Held against the plain versions, which
tests/test_torch_kernels.py holds against the JAX package's STFT.

Float64 bound: 1e-9 x the plain version's max |value|.
"""
import numpy as np
import pytest
import torch

from noisereduce_tpu_torch.config import StftConfig
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import (
    FFT_ACC,
    FFT_ELEMS,
    FFT_MAX_NFFT,
    FFT_MIN_NFFT,
    FFT_WARP_POINTS,
    FFT_WARPS,
    fft_route,
    gate_geometry,
)
from noisereduce_tpu_torch.parallel.chunking import n_chunks_for

torch.set_num_threads(2)

F64_TOL = 1e-9
TORCH = dict(convention="torch", quantize_window_f32=True)
GEOMS = {
    "nfft512-r4": dict(n_fft=512, hop_length=128),
    "nfft1024-r4": dict(n_fft=1024, hop_length=256),
    "nfft1024-r2": dict(n_fft=1024, hop_length=512),
    "nfft2048-win1024": dict(n_fft=2048, win_length=1024, hop_length=256),
    "torch-nfft1024-r4": dict(n_fft=1024, hop_length=256, **TORCH),
    "torch-nfft512-r2": dict(n_fft=512, hop_length=256, **TORCH),
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


def _div(x, d):
    """fft_smem.cuh::Div: x / d as the high half of x * ceil(2^32 / d)."""
    x = np.asarray(x, np.uint64)
    if d == 1:
        return x.astype(np.int64)
    m = np.uint64(0xFFFFFFFF // d + 1)
    return ((x * m) >> np.uint64(32)).astype(np.int64)


def _radices(m):
    """The radices of fft_frames' stages: the power-of-two part of M first
    (8 while 8 of it remain, then 4 or 2), then the 3s, the 5s, the 7s."""
    out, ns, p2 = [], 1, m & -m
    while ns < p2:
        out.append(min(8, p2 // ns))
        ns *= out[-1]
    for r in (3, 5, 7):
        while (m // ns) % r == 0:
            out.append(r)
            ns *= r
    return out


def _dft_r(v, inverse):
    """fft_smem.cuh::dft<R> on (..., R) complex, the sources' formulas with
    their constants in float64: radix 2, 4 and 8 as butterflies, 3, 5 and 7
    as a_m -+ i b_m over t+_k = v[k] + v[R-k], t-_k = v[k] - v[R-k]."""
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
        a = v[..., 0] + sum(np.cos(2 * np.pi * k * mm / R) * tp[k - 1] for k in range(1, h + 1))
        b = sum(np.sin(2 * np.pi * k * mm / R) * tm[k - 1] for k in range(1, h + 1))
        out[..., mm], out[..., R - mm] = a + b, a - b
    return out


def _stockham(z, tw, inverse):
    """fft_smem.cuh::fft_frames on (frames, M) complex: per stage, butterfly
    j loads z[j + r M/R], twiddles by tw[2 (j mod ns) r M/(ns R)]
    (conjugated for the inverse), takes the R-point DFT and stores at
    (j - j mod ns) R + j mod ns + r ns; j mod ns through Div."""
    m = z.shape[-1]
    ns = 1
    for R in _radices(m):
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


def _segments(geo, n_frames):
    """fft_smem.cuh::segment and seg_frames: (first frame slot, frames) of
    each thread segment of a block among its first n_frames, the idle warps
    past the last whole segment included (they own none)."""
    warps, m = geo.fft_seg_warps, geo.n_fft // 2
    fps = warps * FFT_WARP_POINTS // m
    out = []
    for sid in range(-(-FFT_WARPS // warps)):
        whole = sid < FFT_WARPS // warps
        f0 = sid * fps
        out.append((f0, min(max(n_frames - f0, 0), fps) if whole else 0))
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


def _emulate_spectra_fft(x, geo, cs=0, pad=0):
    """csrc/spectra_fft.cu: per tile of fft_tile_frames frames of one view,
    the zero-filled signal span; per thread segment, its windowed frames
    packed as M = N/2 complex points, the FFT, and the split into the real
    spectrum, (M + 1) / 2 slots a frame."""
    rows, n = x.shape
    k_chunks = n_chunks_for(n, cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    N, M, T, nb, hop, win = geo.n_fft, geo.n_fft // 2, geo.n_frames, geo.n_bins, geo.hop, geo.win
    ws, tw = K._scaled_window_np(geo.scfg), _twiddles(N)
    half = (M + 1) // 2
    re = np.zeros((rows * k_chunks, T, nb))
    im = np.zeros_like(re)
    for b in range(rows * k_chunks):
        h, c = divmod(b, k_chunks)
        for t0 in range(0, T, geo.fft_tile_frames):
            fe = min(geo.fft_tile_frames, T - t0)
            p = t0 * hop - geo.bpad + np.arange((fe - 1) * hop + win)
            s = c * stride + start + p
            ok = (p >= 0) & (p < geo.view_len) & (s >= 0) & (s < n)
            span = np.where(ok, x[h, np.clip(s, 0, n - 1)], 0.0)
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
                re[b, t0 + f0 : t0 + f0 + nf], im[b, t0 + f0 : t0 + f0 + nf] = X.real, X.imag
    return re, im


def _emulate_istft_fft(re, im, mask, geo, out_off, out_len, run=None):
    """csrc/istft_fft.cu: per run of output hop blocks, the covering frames
    (the run plus r - 1 halo frames) in groups of fft_tile_frames; per
    thread segment, Y = Z * mask without the imaginary DC and Nyquist
    parts, the unsplit ((M + 1) / 2 slots a frame), the unscaled inverse
    FFT; each sample summing its frames in ascending t; then the envelope
    (the host table where all r frames exist, else summed) and the trim."""
    B, T, nb = re.shape
    N, M, hop, r, win = geo.n_fft, geo.n_fft // 2, geo.hop, geo.r, geo.win
    G, run = geo.fft_tile_frames, run or geo.fft_run
    tw, post = _twiddles(N), K._post_window_np(geo.scfg)
    wsq, env_int = K._window_squares_np(geo.scfg), K._interior_envelope_np(geo.scfg)
    j0, n_out = geo.out_blocks(out_off, out_len)
    half = (M + 1) // 2
    out = np.zeros((B, out_len))
    for b in range(B):
        for ja in range(j0, j0 + n_out, run):
            je = min(run, j0 + n_out - ja)
            acc = np.zeros(je * hop)
            t_lo, t_hi = max(0, ja - r + 1), min(T - 1, ja + je - 1)
            for tg in range(t_lo, t_hi + 1, G):
                ge = min(G, t_hi - tg + 1)
                y = np.zeros((ge, N))
                for f0, nf in _segments(geo, ge):
                    if not nf:
                        continue
                    e = np.arange(nf * nb)
                    fl, k = e // nb, e % nb
                    t = tg + f0 + fl
                    # no imaginary DC or Nyquist part
                    Y = (re[b, t, k] + 1j * im[b, t, k] * ((k > 0) & (k < M))) * mask[b, t, k]
                    z, nyq = np.zeros(nf * M, complex), np.zeros(nf, complex)
                    z[(fl * M + k)[k < M]], nyq[fl[k == M]] = Y[k < M], Y[k == M]
                    e = np.arange(nf * half)
                    fl = _div(e, half)
                    k = e - fl * half
                    lk, lm = fl * M + k, fl * M + M - k
                    ym = np.where(k == 0, nyq[fl], z[np.where(k > 0, lm, lk)])
                    lo, hi = _unsplit(z[lk], ym, tw[k])
                    z[lk], z[lm[k > 0]] = lo, hi[k > 0]
                    if M % 2 == 0:  # slot 0 also turns the middle point
                        mid = lk[k == 0] + M // 2
                        z[mid] = _unsplit(z[mid], z[mid], tw[M // 2])[0]
                    zz = _stockham(z.reshape(nf, M), tw, True)
                    y[f0 : f0 + nf, 0::2], y[f0 : f0 + nf, 1::2] = zz.real, zz.imag
                for i in range(ge):
                    l = (tg + i - ja) * hop + np.arange(win)
                    keep = (l >= 0) & (l < je * hop)
                    acc[l[keep]] += post[keep] * y[i, :win][keep]
            l = np.arange(je * hop)
            jj, q = ja + l // hop, l % hop
            s = jj * hop + q - geo.bpad
            env = np.zeros(len(l), wsq.dtype)  # ascending t, in the table's dtype
            for i in reversed(range(r)):
                env += ((jj - i >= 0) & (jj - i < T)) * wsq[i * hop + q]
            env = np.where((jj - r + 1 >= 0) & (jj < T), env_int[q], env)
            yy = np.where(s < geo.istft_len, acc / np.where(env > geo.env_floor, env, 1.0), 0.0)
            o = s - out_off
            keep = (o >= 0) & (o < out_len)
            out[b, o[keep]] = yy[keep]
    return out


def _route_sizes():
    """Every n_fft the FFT route serves."""
    sizes = range(FFT_MIN_NFFT, FFT_MAX_NFFT + 1, 2)
    return [n for n in sizes if fft_route(StftConfig(n_fft=n))]


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096, 8192,
                                   96, 400, 480, 882, 1200, 1536])
def test_stockham_stages_are_the_dft(n_fft):
    """The stage order, the sources' R-point formulas, the autosort indices
    and the host twiddle table give the FFT and its unscaled inverse, for
    power-of-two and mixed-radix halves M (48, 200, 240, 441, 600, 768)."""
    m = n_fft // 2
    rng = np.random.default_rng(n_fft)
    z = rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
    tw = _twiddles(n_fft)
    _close(_stockham(z, tw, False), np.fft.fft(z, axis=-1))
    _close(_stockham(z, tw, True), m * np.fft.ifft(z, axis=-1))
    assert np.prod(_radices(m)) == m


@pytest.mark.parametrize("radix", [2, 3, 4, 5, 7, 8])
def test_radix_formulas_are_the_dft(radix):
    """fft_smem.cuh's R-point DFTs, forward and inverse."""
    v = np.random.default_rng(radix).standard_normal((4, radix, 2)) @ [1, 1j]
    n = np.arange(radix)
    for inverse, sign in ((False, -1), (True, 1)):
        want = v @ np.exp(sign * 2j * np.pi * np.outer(n, n) / radix)
        _close(_dft_r(v, inverse), want, 1e-14)


def test_multiply_high_division_is_exact():
    """Div's x / d is exact for every divisor the kernels use (M, (M + 1) / 2,
    M / R and ns of each stage, for every n_fft the route serves, and a
    segment's warps) and every
    x below 2^14, past every index they divide; every M's plan fits
    fft_smem.cuh's MAX_STAGES (12)."""
    ds = set(range(1, FFT_WARPS + 1))
    for n in _route_sizes():
        m = n // 2
        assert len(_radices(m)) <= 12
        ds.update((m, (m + 1) // 2))
        ns = 1
        for r in _radices(m):
            ds.update((m // r, ns))
            ns *= r
    x = np.arange(2**14)
    for d in sorted(ds):
        assert d <= 2**13 and np.array_equal(_div(x, d), x // d), d


def test_twiddle_table_is_exact_at_quarter_turns():
    tw = K._twiddle_np(1024)
    assert tuple(tw[0]) == (1.0, 0.0) and tuple(tw[256]) == (0.0, -1.0)
    assert tuple(tw[512]) == (-1.0, 0.0) and tuple(tw[768]) == (0.0, 1.0)
    _close(tw[:, 0] + 1j * tw[:, 1], np.exp(-2j * np.pi * np.arange(1024) / 1024))


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
@pytest.mark.parametrize("kw", GEOMS.values(), ids=GEOMS.keys())
def test_spectra_fft_emulation_matches_plain_version(kw, chunked):
    x = np.random.default_rng(31).standard_normal((2, N_SRC))
    cs, pad = (CS, PAD) if chunked else (0, 0)
    geo = gate_geometry(StftConfig(**kw), CS + 2 * PAD if chunked else N_SRC)
    assert fft_route(geo.scfg)
    re, im = K.spectra_ref(torch.as_tensor(x), geo, cs, pad)
    ere, eim = _emulate_spectra_fft(x, geo, cs, pad)
    _close(ere, re.numpy())
    _close(eim, im.numpy())


def test_spectra_fft_emulation_of_a_short_noise_row():
    """One frame, most of its span outside the signal (TPU row 3's clip)."""
    x = np.random.default_rng(32).standard_normal((1, 100))
    geo = gate_geometry(StftConfig(), 100)
    re, im = K.spectra_ref(torch.as_tensor(x), geo)
    ere, eim = _emulate_spectra_fft(x, geo)
    assert ere.shape == (1, 1, 513)
    _close(ere, re.numpy())
    _close(eim, im.numpy())


@pytest.mark.parametrize("window", ["core", "whole", "middle", "past-end"])
@pytest.mark.parametrize("kw", GEOMS.values(), ids=GEOMS.keys())
def test_istft_fft_emulation_matches_plain_version(kw, window):
    view = CS + 2 * PAD
    geo = gate_geometry(StftConfig(**kw), view)
    rng = np.random.default_rng(33)
    re, im = rng.standard_normal((2, 3, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    out_off, out_len = {"core": (PAD, CS), "whole": (0, view), "middle": (3000, 1500),
                        "past-end": (4500, 2000)}[window]
    ref = K.istft_ola_ref(*(torch.as_tensor(a) for a in (re, im, mask)), geo, out_off, out_len)
    _close(_emulate_istft_fft(re, im, mask, geo, out_off, out_len), ref.numpy())


@pytest.mark.parametrize("name", ["nfft1024-r4", "torch-nfft512-r2", "nfft1536-r4"])
def test_istft_fft_output_does_not_depend_on_the_run(name):
    """Each sample sums the same products in ascending frame order whatever
    run or group its frames land in: runs of 1, 3 and fft_run give the
    same bits."""
    geo = gate_geometry(StftConfig(**GEOMS[name]), CS + 2 * PAD)
    rng = np.random.default_rng(34)
    re, im = rng.standard_normal((2, 1, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    outs = [_emulate_istft_fft(re, im, mask, geo, PAD, CS, run) for run in (1, 3, None)]
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0], outs[2])


def test_route_predicate():
    """An even n_fft from 64 to 8192 whose half has no prime factor but 2,
    3, 5 and 7 takes the FFT route; any other n_fft the product route; the
    geometry alone decides."""
    for n in (64, 512, 1024, 2048, 8192, 1536, 1000, 400, 882):
        assert fft_route(StftConfig(n_fft=n)) and fft_route(StftConfig(n_fft=n, **TORCH))
    for n in (1100, 1023, 32, 16384, 8200, 2 * 11 * 32):
        assert not fft_route(StftConfig(n_fft=n))
    geo = gate_geometry(StftConfig(n_fft=1100, hop_length=275), 8000)
    assert not fft_route(geo.scfg) and geo.r == 4
    assert K._route(geo) == "product"
    assert K._route(gate_geometry(StftConfig(n_fft=1536, hop_length=384), 8000)) == "fft"
    assert K._route(gate_geometry(StftConfig(n_fft=512), 8000)) == "fft"


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (512, 128), (1024, 256), (2048, 2048),
                                       (8192, 2048), (8192, 8192), (1536, 384),
                                       (400, 100), (882, 441)])
def test_fft_tiles_fit_a_block(n_fft, hop):
    """A's tile and D's group hold at most ELEMS complex values, D's run at
    most FFT_ACC samples, and every tile and run holds at least one. The
    thread segments hold whole frames within their threads' points, and
    together every frame of a tile exactly once; a power of two M keeps
    the layout of one frame or 256/M frames a warp."""
    geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 20000)
    m = n_fft // 2
    assert geo.fft_tile_frames >= 1 and geo.fft_tile_frames * m <= FFT_ELEMS
    assert geo.fft_run >= 1 and geo.fft_run * hop <= FFT_ACC
    warps = geo.fft_seg_warps
    assert 1 <= warps <= FFT_WARPS and warps * FFT_WARP_POINTS >= m
    for fe in (1, geo.fft_tile_frames - 1, geo.fft_tile_frames):
        owned = [f for f0, nf in _segments(geo, fe) for f in range(f0, f0 + nf)]
        assert owned == list(range(fe))
    if m & (m - 1) == 0:
        assert warps == max(1, m // FFT_WARP_POINTS) and geo.fft_tile_frames * m == FFT_ELEMS


def test_segment_layout_keeps_most_lanes_busy():
    """Over every n_fft the route serves, no other segment width fits more
    frames in a block, and a tile fills at least half of the block's points
    (the least: one frame of M just above 2048, 2058 at n_fft 4116)."""
    fills = []
    for n in _route_sizes():
        geo = gate_geometry(StftConfig(n_fft=n, hop_length=n // 2), 4 * n)
        m = n // 2
        best = max((FFT_WARPS // w) * (w * FFT_WARP_POINTS // m) for w in range(1, FFT_WARPS + 1))
        assert geo.fft_tile_frames == best
        fills.append(geo.fft_tile_frames * m / FFT_ELEMS)
    assert min(fills) >= 0.5


def test_route_counts_stay_zero_on_cpu():
    K.reset_launch_counts()
    x = torch.as_tensor(np.random.default_rng(35).standard_normal((1, 8000)))
    for n_fft, hop in ((1024, 256), (1536, 384)):
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 8000)
        re, im = K.spectra(x, geo)
        K.istft_ola(re, im, torch.ones_like(re), geo, 0, 8000)
    assert K.route_counts() == {"spectra": {"fft": 0, "product": 0},
                                "istft_ola": {"fft": 0, "product": 0}}
