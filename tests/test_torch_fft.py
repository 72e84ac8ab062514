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


def _radices(m):
    """The radices of fft_frames' stages: 8 while 8 points remain, then 4
    or 2."""
    out, ns = [], 1
    while ns < m:
        out.append(min(8, m // ns))
        ns *= out[-1]
    return out


def _stockham(z, tw, inverse):
    """fft_smem.cuh::fft_frames on (frames, M) complex: per stage, butterfly
    j loads z[j + r M/R], twiddles by tw[2 (j mod ns) r M/(ns R)]
    (conjugated for the inverse), takes the R-point DFT and stores at
    (j - j mod ns) R + j mod ns + r ns."""
    m = z.shape[-1]
    ns = 1
    for R in _radices(m):
        mr = m // R
        j = np.arange(mr)
        jm = j % ns
        w = tw[2 * jm[:, None] * np.arange(R)[None, :] * (m // (ns * R))]
        v = np.stack([z[:, j + r * mr] for r in range(R)], axis=-1) * (np.conj(w) if inverse else w)
        n = np.arange(R)
        dft = np.exp((1 if inverse else -1) * 2j * np.pi * np.outer(n, n) / R)
        # elementwise sums: a frame's result does not depend on its neighbours
        v = sum(v[..., a, None] * dft[a] for a in range(R))
        d = (j - jm) * R + jm
        out = np.empty_like(z)
        for r in range(R):
            out[:, d + r * ns] = v[..., r]
        z = out
        ns *= R
    return z


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
    the zero-filled signal span, the windowed frames packed as N/2 complex
    points, the FFT, the split into the real spectrum."""
    rows, n = x.shape
    k_chunks = n_chunks_for(n, cs) if cs else 1
    stride, start = (cs, -pad) if cs else (0, 0)
    N, M, T, nb, hop, win = geo.n_fft, geo.n_fft // 2, geo.n_frames, geo.n_bins, geo.hop, geo.win
    ws, tw = K._scaled_window_np(geo.scfg), _twiddles(N)
    re = np.zeros((rows * k_chunks, T, nb))
    im = np.zeros_like(re)
    k = np.arange(M // 2)  # slot k: bins k and M - k; slot 0 also M/2
    for b in range(rows * k_chunks):
        h, c = divmod(b, k_chunks)
        for t0 in range(0, T, geo.fft_tile_frames):
            fe = min(geo.fft_tile_frames, T - t0)
            p = t0 * hop - geo.bpad + np.arange((fe - 1) * hop + win)
            s = c * stride + start + p
            ok = (p >= 0) & (p < geo.view_len) & (s >= 0) & (s < n)
            span = np.where(ok, x[h, np.clip(s, 0, n - 1)], 0.0)
            u = np.zeros((fe, N))
            u[:, :win] = ws * span[np.arange(fe)[:, None] * hop + np.arange(win)]
            Z = _stockham(u[:, 0::2] + 1j * u[:, 1::2], tw, False)
            X = np.zeros((fe, nb), complex)
            X[:, k], X[:, M - k] = _split(Z[:, k], Z[:, (M - k) % M], tw[k])
            X[:, M // 2] = _split(Z[:, M // 2], Z[:, M // 2], tw[M // 2])[0]
            re[b, t0 : t0 + fe], im[b, t0 : t0 + fe] = X.real, X.imag
    return re, im


def _emulate_istft_fft(re, im, mask, geo, out_off, out_len, run=None):
    """csrc/istft_fft.cu: per run of output hop blocks, the covering frames
    (the run plus r - 1 halo frames) in groups of ELEMS / (N/2): Y = Z *
    mask without the imaginary DC and Nyquist parts, the unsplit, the
    unscaled inverse FFT, each sample summing its frames in ascending t;
    then the envelope (the host table where all r frames exist, else summed)
    and the trim."""
    B, T, _ = re.shape
    N, M, hop, r, win = geo.n_fft, geo.n_fft // 2, geo.hop, geo.r, geo.win
    G, run = FFT_ELEMS // M, run or geo.fft_run
    tw, post = _twiddles(N), K._post_window_np(geo.scfg)
    wsq, env_int = K._window_squares_np(geo.scfg), K._interior_envelope_np(geo.scfg)
    j0, n_out = geo.out_blocks(out_off, out_len)
    k = np.arange(M // 2)  # slot k: the pair k, M - k; slot 0 also M/2
    out = np.zeros((B, out_len))
    for b in range(B):
        for ja in range(j0, j0 + n_out, run):
            je = min(run, j0 + n_out - ja)
            acc = np.zeros(je * hop)
            t_lo, t_hi = max(0, ja - r + 1), min(T - 1, ja + je - 1)
            for tg in range(t_lo, t_hi + 1, G):
                ts = np.arange(tg, min(tg + G, t_hi + 1))
                Y = (re[b, ts] + 1j * im[b, ts]) * mask[b, ts]
                Y[:, [0, M]] = Y[:, [0, M]].real
                Z = np.zeros((len(ts), M), complex)
                lo, hi = _unsplit(Y[:, k], Y[:, M - k], tw[k])
                Z[:, k], Z[:, (M - k) % M] = lo, hi
                Z[:, 0] = lo[:, 0]  # slot 0 pairs 0 with M
                Z[:, M // 2] = _unsplit(Y[:, M // 2], Y[:, M // 2], tw[M // 2])[0]
                z = _stockham(Z, tw, True)
                y = np.empty((len(ts), N))
                y[:, 0::2], y[:, 1::2] = z.real, z.imag
                for i, t in enumerate(ts):
                    l = (t - ja) * hop + np.arange(win)
                    keep = (l >= 0) & (l < je * hop)
                    acc[l[keep]] += post[keep] * y[i, :win][keep]
            l = np.arange(je * hop)
            jj, q = ja + l // hop, l % hop
            s = jj * hop + q - geo.bpad
            env = np.zeros(len(l), wsq.dtype)  # ascending t, in the table's dtype
            for i in reversed(range(r)):
                env += ((jj - i >= 0) & (jj - i < T)) * wsq[i * hop + q]
            env = np.where((jj - r + 1 >= 0) & (jj < T), env_int[q], env)
            y = np.where(s < geo.istft_len, acc / np.where(env > geo.env_floor, env, 1.0), 0.0)
            o = s - out_off
            keep = (o >= 0) & (o < out_len)
            out[b, o[keep]] = y[keep]
    return out


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_stockham_stages_are_the_dft(n_fft):
    """The stage order, autosort indices and host twiddle table give the
    FFT and its unscaled inverse at every n_fft the route serves."""
    m = n_fft // 2
    rng = np.random.default_rng(n_fft)
    z = rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
    tw = _twiddles(n_fft)
    _close(_stockham(z, tw, False), np.fft.fft(z, axis=-1))
    _close(_stockham(z, tw, True), m * np.fft.ifft(z, axis=-1))
    assert np.prod(_radices(m)) == m


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


@pytest.mark.parametrize("kw", [GEOMS["nfft1024-r4"], GEOMS["torch-nfft512-r2"]],
                         ids=["nfft1024-r4", "torch-nfft512-r2"])
def test_istft_fft_output_does_not_depend_on_the_run(kw):
    """Each sample sums the same products in ascending frame order whatever
    run or group its frames land in: runs of 1, 3 and fft_run give the
    same bits."""
    geo = gate_geometry(StftConfig(**kw), CS + 2 * PAD)
    rng = np.random.default_rng(34)
    re, im = rng.standard_normal((2, 1, geo.n_frames, geo.n_bins))
    mask = rng.random(re.shape)
    outs = [_emulate_istft_fft(re, im, mask, geo, PAD, CS, run) for run in (1, 3, None)]
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0], outs[2])


def test_route_predicate():
    """A power-of-two n_fft from 64 to 8192 takes the FFT route; any other
    n_fft the product route; the geometry alone decides."""
    for n in (64, 512, 1024, 2048, 8192):
        assert fft_route(StftConfig(n_fft=n)) and fft_route(StftConfig(n_fft=n, **TORCH))
    for n in (1536, 1000, 32, 16384):
        assert not fft_route(StftConfig(n_fft=n))
    geo = gate_geometry(StftConfig(n_fft=1536, hop_length=384), 8000)
    assert not fft_route(geo.scfg) and geo.r == 4
    assert K._route(geo) == "product"
    assert K._route(gate_geometry(StftConfig(n_fft=512), 8000)) == "fft"


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (512, 128), (1024, 256), (2048, 2048),
                                       (8192, 2048), (8192, 8192)])
def test_fft_tiles_fit_a_block(n_fft, hop):
    """A's tile and D's group hold at most ELEMS complex values, D's run at
    most FFT_ACC samples, and every tile and run holds at least one."""
    geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 20000)
    assert geo.fft_tile_frames >= 1 and geo.fft_tile_frames * n_fft // 2 <= FFT_ELEMS
    assert geo.fft_run >= 1 and geo.fft_run * hop <= FFT_ACC


def test_route_counts_stay_zero_on_cpu():
    K.reset_launch_counts()
    x = torch.as_tensor(np.random.default_rng(35).standard_normal((1, 8000)))
    for n_fft, hop in ((1024, 256), (1536, 384)):
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), 8000)
        re, im = K.spectra(x, geo)
        K.istft_ola(re, im, torch.ones_like(re), geo, 0, 8000)
    assert K.route_counts() == {"spectra": {"fft": 0, "product": 0},
                                "istft_ola": {"fft": 0, "product": 0}}
