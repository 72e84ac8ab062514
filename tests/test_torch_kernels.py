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
# frames below 64 samples end to end (kernels A and D on the FFT route, the
# DFT products before it): the port's reduce_noise, the kernels' plain
# versions on the CPU, against the JAX package's
# ---------------------------------------------------------------------------
SMALL_SR = 8000
# 5 ms frames at 8 kHz, and frames of 4, 3 and 2 samples, whose bins lie
# 2-4 kHz apart: a frequency smoothing of 8 kHz, as wide as the JAX package
# takes there
SMALL_GEOMS = {
    "nfft40": dict(n_fft=40, hop_length=10),
    "nfft4": dict(n_fft=4, hop_length=1, freq_mask_smooth_hz=8000),
    "nfft3": dict(n_fft=3, hop_length=1, freq_mask_smooth_hz=8000),
    "nfft2": dict(n_fft=2, hop_length=1, freq_mask_smooth_hz=8000),
}
SMALL_ENGINES = {"nonstationary": {}, "stationary": dict(stationary=True),
                 "torch": dict(use_torch=True)}


@pytest.mark.parametrize("engine", list(SMALL_ENGINES))
@pytest.mark.parametrize("name", list(SMALL_GEOMS))
def test_reduce_noise_of_small_frames_matches_jax(name, engine):
    """``reduce_noise`` at n_fft 40 / hop 10, 4 / 1, 3 / 1 (odd) and 2 / 1
    on 2 s at 8 kHz in chunks of 4000 with 1000 of padding, on the scipy
    engines (non-stationary and stationary) and the torch engine, in
    float64 on the CPU: the geometry takes the kernels (``kernels_supported``,
    the FFT route), and the output is the JAX package's within 1e-9 x
    max|ref| (the scipy engines) and 1e-8 x max|ref| (the torch engine:
    rank-1 taps against every SVD rank), the bounds of
    tests/test_torch_api_groups.py."""
    import noisereduce_tpu as jnr

    import noisereduce_tpu_torch as nrt
    from noisereduce_tpu_torch.ops.cuda.geometry import fft_route, kernels_supported

    scfg = GateConfig(sr=SMALL_SR, **SMALL_GEOMS[name]).stft
    assert kernels_supported(scfg) and fft_route(scfg) == "fft"
    y = np.random.default_rng(13).standard_normal(2 * SMALL_SR)
    kw = dict(SMALL_GEOMS[name], chunk_size=4000, padding=1000, **SMALL_ENGINES[engine])
    got = nrt.reduce_noise(y, SMALL_SR, device="cpu", compute_dtype=torch.float64, **kw)
    ref = np.asarray(jnr.reduce_noise(y, SMALL_SR, **kw))
    assert got.shape == ref.shape == y.shape and np.isfinite(got).all()
    _close(got, ref, 1e-8 if engine == "torch" else F64_TOL)
