"""PyTorch port: each CUDA kernel's plain version against its JAX
counterpart (float64, CPU). The kernels themselves are held against these
plain versions on a card by tests/test_torch_cuda.py.

Inputs come from numpy with a seed and go to both packages as arrays.
Float64 parity bound: 1e-9 x the reference's max |value|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisereduce_tpu.config import StftConfig as JStftConfig
from noisereduce_tpu.ops import dsp as jdsp
from noisereduce_tpu.ops.stft import istft as jistft
from noisereduce_tpu.ops.stft import stft as jstft
from noisereduce_tpu.parallel.chunking import extract_chunks as jextract

from noisereduce_tpu_torch.config import GateConfig, StftConfig
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
from noisereduce_tpu_torch.ops.dsp import tri_norm

torch.set_num_threads(2)

F64_TOL = 1e-9
GEOMS = [dict(n_fft=1024, hop_length=256), dict(n_fft=512, hop_length=128)]
GEOM_IDS = ["nfft1024", "nfft512"]


def _close(got, ref, tol=F64_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    dev = np.abs(got - ref).max()
    assert dev <= tol * scale, f"max|dev| {dev:.3e} vs {tol:.0e} x {scale:.3e}"


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    # a slow level drift along frames, so the IIR floor has work to do
    drift = 1.0 + 0.8 * np.sin(np.linspace(0, 6, shape[-2]))[:, None]
    return re * drift, im * drift


@pytest.mark.parametrize("kw", GEOMS, ids=GEOM_IDS)
def test_spectra_ref_matches_jax_stft(kw):
    x = np.random.default_rng(0).standard_normal((2, 20000))
    scfg = StftConfig(**kw)
    re, im = K.spectra_ref(_t(x), gate_geometry(scfg, x.shape[-1]))
    jre, jim = jstft(jnp.asarray(x), JStftConfig(**kw), time_major=True, split=True)
    _close(re.numpy().reshape(jre.shape), jre)
    _close(im.numpy().reshape(jim.shape), jim)


@pytest.mark.parametrize("n", [20000, 24000, 7000])
def test_spectra_ref_chunk_views_match_jax_chunks(n):
    """Views read with per-chunk offsets equal the JAX chunk extraction
    followed by the STFT (zero fill outside the signal included)."""
    cs, pad = 8000, 1500
    x = np.random.default_rng(1).standard_normal((2, n))
    geo = gate_geometry(StftConfig(), cs + 2 * pad)
    re, im = K.spectra_ref(_t(x), geo, cs, pad)
    views = jextract(jnp.asarray(x), cs, pad)  # (2, k, view)
    jre, jim = jstft(views, JStftConfig(), time_major=True, split=True)
    _close(re.numpy(), np.asarray(jre).reshape(re.shape))
    _close(im.numpy(), np.asarray(jim).reshape(im.shape))


@pytest.mark.parametrize("sr,kw", [
    (48000, {}), (16000, dict(n_fft=512, hop_length=128)),
    (8000, dict(time_constant_s=0.5)),
], ids=["48k", "16k-nfft512", "8k-fast-iir"])
def test_nonstationary_mask_ref_matches_jax(sr, kw):
    cfg = GateConfig(sr=sr, **kw)
    ngt = cfg.smoothing[1]
    re, im = _planes(2, (3, 200, cfg.stft.n_bins))
    got = K.nonstationary_mask_ref(
        _t(re), _t(im), cfg.iir_b, cfg.thresh_n_mult_nonstationary,
        cfg.sigmoid_slope_nonstationary, tri_norm(ngt),
    )
    _close(got.numpy(), _jax_mask(jnp.asarray(re), jnp.asarray(im), cfg))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_mask_impl(re, im, b, thresh, slope):
    mag = jnp.sqrt(re**2 + im**2)
    floor = jdsp.ewma_filtfilt(mag, b, axis=-2)
    return jdsp.sigmoid((mag - floor) / floor, -thresh, slope)


def _jax_mask(re, im, cfg):
    """JAX ewma_filtfilt + sigmoid + time-only smooth_mask."""
    raw = _jax_mask_impl(re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
                         cfg.sigmoid_slope_nonstationary)
    return jdsp.smooth_mask(raw, 0, cfg.smoothing[1], time_major=True)


@pytest.mark.parametrize("ngf,prop", [(5, 1.0), (10, 0.6), (1, 0.0)])
def test_freq_smooth_blend_ref_matches_jax(ngf, prop):
    mask = np.random.default_rng(3).random((2, 50, 513))
    got = K.freq_smooth_blend_ref(_t(mask), tri_norm(ngf), prop)
    ref = jdsp.smooth_mask(jnp.asarray(mask), ngf, 0, time_major=True)
    _close(got.numpy(), ref * prop + (1.0 - prop))


@pytest.mark.parametrize("kw", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("window", ["whole", "core", "past-end"])
def test_istft_ola_ref_matches_jax_istft(kw, window):
    scfg, jcfg = StftConfig(**kw), JStftConfig(**kw)
    view = 11000
    geo = gate_geometry(scfg, view)
    re, im = _planes(4, (2, geo.n_frames, geo.n_bins))
    mask = np.random.default_rng(5).random(re.shape)
    out_off, out_len = {"whole": (0, view), "core": (1500, 8000),
                        "past-end": (9000, 3000)}[window]
    got = K.istft_ola_ref(_t(re), _t(im), _t(mask), geo, out_off, out_len)
    y = np.asarray(jistft((jnp.asarray(re * mask), jnp.asarray(im * mask)),
                          jcfg, time_major=True))
    ref = np.zeros((2, out_len))
    part = y[:, out_off : out_off + out_len]
    ref[:, : part.shape[-1]] = part
    _close(got.numpy(), ref)


# ---------------------------------------------------------------------------
# kernels A and D on their product route as the CUDA sources compute them
# (constant tables, loader index math, epilogue), emulated in numpy float64
# against the plain versions; tests/test_torch_fft.py does the same for
# their FFT route
# ---------------------------------------------------------------------------
def _emulate_spectra(x, geo, cs, pad):
    """csrc/spectra.cu: A[m, k] = x[h, c*cs - pad + t*hop - bpad + k] (zero
    outside the view and the signal), C = A @ analysis table."""
    rows, n = x.shape
    k_chunks = (n - 1) // cs + 1
    T, nb = geo.n_frames, geo.n_bins
    b, t = np.divmod(np.arange(rows * k_chunks * T), T)
    h, c = np.divmod(b, k_chunks)
    k = np.arange(geo.k_a)
    pos = (t * geo.hop - geo.bpad)[:, None] + k[None, :]
    src = (c * cs - pad)[:, None] + pos
    ok = (k < geo.win) & (pos >= 0) & (pos < geo.view_len) & (src >= 0) & (src < n)
    A = np.where(ok, x[h[:, None], np.clip(src, 0, n - 1)], 0.0)
    C = A @ K._analysis_table_np(geo.scfg)
    shape = (rows * k_chunks, T, nb)
    return C[:, :nb].reshape(shape), C[:, nb : 2 * nb].reshape(shape)


def _emulate_istft_ola(re, im, mask, geo, out_off, out_len):
    """csrc/istft_ola.cu: row (b, j) holds [Y_j, Y_{j-1}, ...] (each 2 n_bins
    wide, padded to f2), times the synthesis table; the epilogue divides by
    the window-square envelope and keeps the trimmed output window."""
    B, T, nb = re.shape
    j0, n_out = geo.out_blocks(out_off, out_len)
    j = j0 + np.arange(n_out)
    A = np.zeros((B, n_out, geo.k_d))
    for i in range(geo.r):
        t = j - i
        ok = (t >= 0) & (t < T)
        tt = np.clip(t, 0, T - 1)
        ym = np.concatenate([re * mask, im * mask], axis=-1)[:, tt]
        A[:, :, i * geo.f2 : i * geo.f2 + 2 * nb] = ym * ok[None, :, None]
    blocks = (A @ K._synthesis_table_np(geo.scfg))[..., : geo.hop]
    w = K._analysis_window_np(geo.scfg)
    q = np.arange(geo.hop)
    env = np.zeros((n_out, geo.hop))
    for i in range(geo.r):
        ok = ((j - i >= 0) & (j - i < T))[:, None]
        env += ok * w[i * geo.hop + q][None, :] ** 2
    s = (j[:, None] * geo.hop + q[None, :] - geo.bpad)
    y = np.where(s < geo.istft_len, blocks / np.where(env > 1e-10, env, 1.0), 0.0)
    o = (s - out_off).reshape(-1)
    keep = (o >= 0) & (o < out_len)
    out = np.zeros((B, out_len))
    out[:, o[keep]] = y.reshape(B, -1)[:, keep]
    return out


@pytest.mark.parametrize("kw", GEOMS + [dict(n_fft=1024, hop_length=512)],
                         ids=GEOM_IDS + ["r2"])
def test_kernel_tables_and_indexing_match_plain_versions(kw):
    cs, pad, n = 4000, 700, 9500
    geo = gate_geometry(StftConfig(**kw), cs + 2 * pad)
    x = np.random.default_rng(11).standard_normal((2, n))
    re, im = K.spectra_ref(_t(x), geo, cs, pad)
    ere, eim = _emulate_spectra(x, geo, cs, pad)
    _close(ere, re.numpy())
    _close(eim, im.numpy())
    mask = np.random.default_rng(12).random(ere.shape)
    for out_off, out_len in [(pad, cs), (0, geo.view_len), (3000, 3000)]:
        ref = K.istft_ola_ref(re, im, _t(mask), geo, out_off, out_len)
        got = _emulate_istft_ola(re.numpy(), im.numpy(), mask, geo, out_off, out_len)
        _close(got, ref.numpy())
