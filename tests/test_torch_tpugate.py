"""PyTorch port of the torch-convention gate (TPUGate) against the JAX
package (CPU).

- torch-convention ``stft`` / ``istft`` and the TorchGate dsp ops
  (``moving_average_same`` with even and odd windows,
  ``temperature_sigmoid``, ``smooth_mask_2d_torchgate``, the top_db 40 /
  ddof 1 noise threshold): float64 at 1e-12, float32 at float32 rounding;
- the kernels' plain versions F and E (self statistics) against the JAX
  staged masks in float64;
- the fused composition (kernels A, F or E, C, D; their plain versions on
  the CPU) in float32 against the JAX torch-convention TPU kernel run in
  Pallas interpret mode, as tests/test_fused_pipeline.py:294-337 runs it:
  5e-5 x scale;
- the staged twin ``_call_staged`` against ``TPUGate._call_jnp`` in float64:
  1e-9 x scale; the fused composition in float64 against it at 1e-8 x
  scale (the kernels smooth with the rank-1 SVD factors of TorchGate's
  float32-rounded kernel, whose other ranks are ~1e-8 of the first);
- ``TPUGate.from_fields``, the argument errors and silence.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisereduce_tpu.config import StftConfig as JStftConfig
from noisereduce_tpu.models.tpu_gate import TPUGate as JTPUGate
from noisereduce_tpu.models.tpu_gate import nonstationary_mask_torch as j_ns_mask
from noisereduce_tpu.models.tpu_gate import stationary_mask_torch as j_st_mask
from noisereduce_tpu.ops import dsp as jdsp
from noisereduce_tpu.ops import istft as j_istft
from noisereduce_tpu.ops import stft as j_stft
from noisereduce_tpu.ops.pallas.torch_dispatch import _torch_threshold_stats
from noisereduce_tpu.ops.pallas_pipeline import _fused_torch_impl

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import StftConfig
from noisereduce_tpu_torch.ops import dsp
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps
from noisereduce_tpu_torch.ops.stft import istft, stft

torch.set_num_threads(2)

# jitted once per gate: eager op-by-op dispatch of the JAX gates costs
# seconds of per-op compilation on the first call
_j_fused_interpret = jax.jit(_fused_torch_impl, static_argnums=(2, 3))
_j_call_jnp = jax.jit(lambda x, xn, g: g._call_jnp(x, xn, "fft"), static_argnums=(2,))
_j_thr_interpret = jax.jit(_torch_threshold_stats, static_argnums=(1, 2))

F32_TOL = 5e-5
F64_TOL = 1e-9
RANK1_TOL = 1e-8


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _dev(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max(), np.abs(ref).max()


# ---------------------------------------------------------------------------
# (a) torch-convention STFT / iSTFT
# ---------------------------------------------------------------------------
STFT_GEOMS = [dict(n_fft=1024), dict(n_fft=1024, win_length=512),
              dict(n_fft=512, hop_length=100), dict(n_fft=2048, win_length=1200, hop_length=300)]


@pytest.mark.parametrize("quantize", [True, False], ids=["f32-window", "f64-window"])
@pytest.mark.parametrize("geom", STFT_GEOMS, ids=lambda g: "-".join(map(str, g.values())))
def test_torch_stft_istft_match_jax(geom, quantize):
    a = StftConfig(convention="torch", quantize_window_f32=quantize, **geom)
    b = JStftConfig(convention="torch", quantize_window_f32=quantize, **geom)
    x = np.random.default_rng(20).standard_normal((2, 5000))
    re, im = stft(_t(x), a)
    jre, jim = j_stft(jnp.asarray(x), b, method="fft", time_major=True, split=True)
    for got, ref in ((re, jre), (im, jim)):
        dev, scale = _dev(got.numpy(), ref)
        assert dev <= 1e-12 * scale
    mask = np.random.default_rng(21).uniform(0.2, 1.0, re.shape)
    Z = (re * _t(mask), im * _t(mask))
    y = istft(Z, a)
    ref = j_istft((jnp.asarray(Z[0].numpy()), jnp.asarray(Z[1].numpy())), b,
                  method="fft", time_major=True)
    dev, scale = _dev(y.numpy(), ref)
    assert dev <= 1e-12 * scale
    # float32: float32 rounding of the same sums
    re32, _ = stft(_t(x.astype(np.float32)), a)
    dev, scale = _dev(re32.numpy(), jre)
    assert dev <= 1e-5 * scale


def test_torch_stft_matches_torch_stft():
    """The port's own copy of the convention against torch.stft/istft
    (center=True, constant padding, the float32 Hann)."""
    cfg = StftConfig(n_fft=1024, hop_length=256, convention="torch", quantize_window_f32=True)
    x = _t(np.random.default_rng(22).standard_normal(6000))
    w = torch.hann_window(1024, dtype=torch.float32).double()
    Z = torch.stft(x, 1024, 256, 1024, w, center=True, pad_mode="constant",
                   return_complex=True)
    re, im = stft(x, cfg)
    assert torch.allclose(re, Z.real.T, atol=1e-10) and torch.allclose(im, Z.imag.T, atol=1e-10)
    y = istft((re, im), cfg)
    ref = torch.istft(Z, 1024, 256, 1024, w, center=True)
    assert y.shape == ref.shape and torch.allclose(y, ref, atol=1e-10)


# ---------------------------------------------------------------------------
# (b) the TorchGate dsp ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 20, 125, 344], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("axis", [-1, -2])
def test_moving_average_same_matches_jax(n, axis):
    x = np.abs(np.random.default_rng(23).standard_normal((2, 400, 33)))
    got = dsp.moving_average_same(_t(x), n, axis=axis)
    ref = jdsp.moving_average_same(jnp.asarray(x), n, axis=axis)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= 1e-12 * scale
    got32 = dsp.moving_average_same(_t(x.astype(np.float32)), n, axis=axis)
    assert got32.dtype == torch.float32
    dev, scale = _dev(got32.numpy(), ref)
    assert dev <= 1e-6 * scale


def test_temperature_sigmoid_matches_jax():
    x = np.random.default_rng(24).standard_normal(1000) * 3
    got = dsp.temperature_sigmoid(_t(x), 1.3, 0.1)
    ref = jdsp.temperature_sigmoid(jnp.asarray(x), 1.3, 0.1)
    assert _dev(got.numpy(), ref)[0] <= 1e-15


@pytest.mark.parametrize("sizes", [(3, 4), (1, 9), (11, 1), (2, 16)], ids=str)
def test_smoothing_kernel_svd_and_smooth_mask_match_jax(sizes):
    np.testing.assert_array_equal(dsp._torchgate_smoothing_kernel_np(*sizes),
                                  jdsp._torchgate_smoothing_kernel_np(*sizes))
    rows, cols = dsp._torchgate_kernel_svd_np(*sizes)
    jrows, jcols = jdsp._torchgate_kernel_svd_np(*sizes)
    assert rows.shape == jrows.shape
    np.testing.assert_allclose(np.einsum("rf,rt->ft", rows, cols),
                               np.einsum("rf,rt->ft", jrows, jcols), atol=1e-15)
    # the kernels' rank-1 taps: the first SVD term, signed so the time taps sum above 0
    ft, tt = _rank1_taps(sizes)
    np.testing.assert_allclose(np.outer(ft, tt), np.outer(rows[0], cols[0]), atol=1e-16)
    assert sum(tt) > 0
    m = np.random.default_rng(25).uniform(size=(2, 60, 40))
    for tm in (True, False):
        got = dsp.smooth_mask_2d_torchgate(_t(m), *sizes, time_major=tm)
        ref = jdsp.smooth_mask_2d_torchgate(jnp.asarray(m), *sizes, time_major=tm)
        assert _dev(got.numpy(), ref)[0] <= 1e-14


def test_torch_noise_threshold_matches_jax_spectra_kernel_interpret():
    """The noise-clip threshold (TPU row 3's torch caller): kernel A's plain
    version + top_db 40, ddof 1 statistics, against the JAX spectra kernel
    in interpret mode and its statistics."""
    g = JTPUGate(sr=16000)
    xn = (np.random.default_rng(26).standard_normal((2, 9000)) * 0.5).astype(np.float32)
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _torch_threshold_stats as thr

    got = thr(_t(xn), nrt.TPUGate.from_fields(dataclasses.asdict(g)))
    ref = _j_thr_interpret(jnp.asarray(xn), g, True)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= 1e-5 * scale  # dB, float32 sums in another order


# ---------------------------------------------------------------------------
# (c) the plain versions of kernels F and E (self statistics) in float64
# ---------------------------------------------------------------------------
def _planes(seed, shape=(3, 140, 65)):
    rng = np.random.default_rng(seed)
    drift = 1.0 + 0.8 * np.sin(np.linspace(0, 6, shape[1]))[:, None]
    return rng.standard_normal(shape) * drift, rng.standard_normal(shape) * drift


@pytest.mark.parametrize("n_movemean", [7, 20, 344])
def test_torch_nonstationary_mask_plain_matches_jax(n_movemean):
    re, im = _planes(27)
    got = K.torch_nonstationary_mask_ref(_t(re), _t(im), n_movemean, 1.3, 0.1, 1.0, (1.0,))
    ref = j_ns_mask(jnp.sqrt(jnp.asarray(re) ** 2 + jnp.asarray(im) ** 2), n_movemean,
                    1.3, 0.1, time_axis=-2)
    assert _dev(got.numpy(), ref)[0] <= 1e-12


def test_stationary_mask_self_statistics_plain_matches_jax():
    re, im = _planes(28)
    got = K.stationary_mask_ref(_t(re), _t(im), None, 1, 1.0, (1.0,), top_db=40.0, n_std=1.5)
    mag = jnp.sqrt(jnp.asarray(re) ** 2 + jnp.asarray(im) ** 2)
    ref = j_st_mask(jdsp.amp_to_db(mag, top_db=40.0, axis=-2), None, 1.5, time_axis=-2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_stationary_mask_self_statistics_needs_n_std():
    re, im = _planes(29)
    with pytest.raises(ValueError, match="n_std"):
        K.stationary_mask(_t(re), _t(im), None, 1, 1.0, (1.0,))


# ---------------------------------------------------------------------------
# (d) the gate: fused against Pallas interpret, staged against _call_jnp
# ---------------------------------------------------------------------------
TORCH_CASES = [
    ("nonstat-default", dict(sr=16000, nonstationary=True), (4, 64000), None),
    ("nonstat-move125",
     dict(sr=16000, nonstationary=True, n_movemean_nonstationary=125), (2, 64000), None),
    ("nonstat-prop", dict(sr=16000, nonstationary=True, prop_decrease=0.5), (2, 48000), None),
    ("stat-self", dict(sr=16000, nonstationary=False), (3, 48000), None),
    ("stat-xn1d", dict(sr=16000, nonstationary=False), (2, 48000), (24000,)),
    ("stat-xn2d", dict(sr=16000, nonstationary=False), (2, 48000), (2, 24000)),
    ("nonstat-44k", dict(sr=44100, nonstationary=True), (1, 60000), None),
]


def _case(name, xshape, xnshape, dtype):
    # per-case generator, as tests/test_fused_pipeline.py seeds these cases
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal(xshape).astype(dtype)
    xn = None if xnshape is None else (rng.standard_normal(xnshape) * 0.5).astype(dtype)
    return x, xn


def _j(a):
    return None if a is None else jnp.asarray(a)


def _p(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("name,kw,xshape,xnshape", TORCH_CASES, ids=[c[0] for c in TORCH_CASES])
def test_fused_f32_matches_jax_torch_kernel_interpret(name, kw, xshape, xnshape):
    g = JTPUGate(**kw)
    x, xn = _case(name, xshape, xnshape, np.float32)
    got = nrt.TPUGate.from_fields(dataclasses.asdict(g))(_t(x), _p(xn))
    ref = _j_fused_interpret(jnp.asarray(x), _j(xn), g, True)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= F32_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


@pytest.mark.parametrize("name,kw,xshape,xnshape", TORCH_CASES, ids=[c[0] for c in TORCH_CASES])
def test_staged_and_fused_f64_match_jax_call_jnp(name, kw, xshape, xnshape):
    g = JTPUGate(**kw)
    p = nrt.TPUGate.from_fields(dataclasses.asdict(g))
    x, xn = _case(name, xshape, xnshape, np.float64)
    ref = _j_call_jnp(jnp.asarray(x), _j(xn), g)
    dev, scale = _dev(p._call_staged(_t(x), _p(xn)).numpy(), ref)
    assert dev <= F64_TOL * scale, f"{name} staged: rel dev {dev / scale:.3e}"
    dev, scale = _dev(p(_t(x), _p(xn)).numpy(), ref)
    assert dev <= RANK1_TOL * scale, f"{name} fused: rel dev {dev / scale:.3e}"


@pytest.mark.parametrize("nonstationary,xn_rows", [
    (False, None), (False, 1), (False, 2), (True, None),
], ids=["stationary-self", "stationary-xn1", "stationary-xn2", "nonstationary"])
def test_batched_chunks_match_jax(nonstationary, xn_rows):
    """(channels, n_chunks, view) chunks flattened into the batch axis, a
    2-row clip mapped channel-major onto the rows, each natural-length
    deficit zero filled."""
    g = JTPUGate(sr=16000, nonstationary=nonstationary)
    p = nrt.TPUGate.from_fields(dataclasses.asdict(g))
    rng = np.random.default_rng(30)
    chunks = rng.standard_normal((2, 3, 7000))
    xn = None if xn_rows is None else rng.standard_normal((xn_rows, 5000)) * 0.5
    got = p.batched_chunks(_t(chunks), _p(xn))
    ref = g.batched_chunks(jnp.asarray(chunks), _j(xn), method="fft", use_pallas=False)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= RANK1_TOL * scale


STAGED_GEOMETRY_CASES = [
    ("nonstationary", dict(nonstationary=True), None),
    ("stationary-self", dict(nonstationary=False), None),
    ("stationary-xn2", dict(nonstationary=False), (2, 9000)),
]


@pytest.mark.parametrize("name,kw,xnshape", STAGED_GEOMETRY_CASES,
                         ids=[c[0] for c in STAGED_GEOMETRY_CASES])
def test_staged_geometry_runs_the_mask_kernels(name, kw, xnshape):
    """A hop that does not divide n_fft: kernels A and D do not serve it,
    and forward puts the plain STFT and iSTFT around the mask kernels (here
    their plain versions), as against the JAX package's _call_jnp; so do
    batched_chunks and the silence of the fused path (finite zeros)."""
    g = JTPUGate(sr=16000, hop_length=300, **kw)
    p = nrt.TPUGate.from_fields(dataclasses.asdict(g))
    x, xn = _case(name, (2, 12000), xnshape, np.float64)
    ref = _j_call_jnp(jnp.asarray(x), _j(xn), g)
    dev, scale = _dev(p._call_staged(_t(x), _p(xn)).numpy(), ref)
    assert dev <= F64_TOL * scale, f"{name} staged: rel dev {dev / scale:.3e}"
    dev, scale = _dev(p(_t(x), _p(xn)).numpy(), ref)
    assert dev <= RANK1_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"
    chunks = x.reshape(2, 2, 6000)
    got = p.batched_chunks(_t(chunks), _p(xn))
    ref = g.batched_chunks(jnp.asarray(chunks), _j(xn), method="fft", use_pallas=False)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= RANK1_TOL * scale, f"{name} chunks: rel dev {dev / scale:.3e}"
    assert torch.all(p(torch.zeros((1, 8000), dtype=torch.float64)) == 0.0)


# ---------------------------------------------------------------------------
# (e) fields, argument errors, silence
# ---------------------------------------------------------------------------
def test_from_fields_round_trips_a_jax_gate():
    g = JTPUGate(sr=22050, nonstationary=True, n_movemean_nonstationary=31,
                 temp_coeff_nonstationary=0.2, prop_decrease=0.7, n_fft=512,
                 hop_length=128, freq_mask_smooth_hz=None)
    p = nrt.TPUGate.from_fields(dataclasses.asdict(g))
    assert p.fields() == dataclasses.asdict(g)
    assert p.smoothing == g.smoothing
    assert (p.stft_config.n_frames(9000), p.stft_config.boundary_pad) == (
        g.stft_config.n_frames(9000), g.stft_config.boundary_pad)
    assert list(p.parameters()) == []
    with pytest.raises(ValueError, match="unknown TPUGate fields"):
        nrt.TPUGate.from_fields({**dataclasses.asdict(g), "bogus": 1})


def test_argument_errors_match_jax():
    with pytest.raises(ValueError, match="prop_decrease"):
        nrt.TPUGate(sr=16000, prop_decrease=1.5)
    with pytest.raises(ValueError) as ours:
        nrt.TPUGate(sr=8000, freq_mask_smooth_hz=5)
    with pytest.raises(ValueError) as theirs:
        JTPUGate(sr=8000, freq_mask_smooth_hz=5)
    assert str(ours.value) == str(theirs.value)
    gate = nrt.TPUGate(sr=16000)
    with pytest.raises(ValueError, match="batch, signal_length"):
        gate(torch.zeros(4000))
    with pytest.raises(ValueError, match="bigger than 2048"):
        gate(torch.zeros((1, 2000)))
    with pytest.raises(ValueError, match="bigger than 2048"):
        gate(torch.zeros((1, 4000)), torch.zeros(1000))
    with pytest.raises(ValueError, match="must be 1 or the signal's 2"):
        gate(torch.zeros((2, 4000)), torch.zeros((3, 4000)))


@pytest.mark.parametrize("nonstationary", [True, False], ids=["nonstationary", "stationary"])
def test_silence(nonstationary):
    """The kernels' plain versions give finite zeros; the staged twin gives
    NaN exactly where the JAX staged path does (the moving average's 0/0)."""
    g = JTPUGate(sr=16000, nonstationary=nonstationary)
    p = nrt.TPUGate.from_fields(dataclasses.asdict(g))
    x = np.zeros((1, 8000))
    got = p(_t(x))
    assert torch.all(got == 0.0)
    staged = p._call_staged(_t(x)).numpy()
    ref = np.asarray(_j_call_jnp(jnp.asarray(x), None, g))
    np.testing.assert_array_equal(np.isnan(staged), np.isnan(ref))
    assert np.isnan(ref).all() == nonstationary
