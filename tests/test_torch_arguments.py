"""PyTorch port: the entry points' argument edges against the JAX package
(CPU, ``device="cpu"``: the kernels' plain versions), each where the port
once returned a wrong result or raised where the JAX package computes.

- A Python list as ``y`` (1-D and 2-D, of numpy scalars and of Python
  floats) is the array ``np.asarray`` makes of it, on all three engines:
  the same shape and dtype as the JAX package's output, within its float64
  bounds (1e-9 x max|ref| for the scipy engines, 1e-8 for the torch one,
  as tests/test_torch_api_groups.py holds them).
- ``max_parallel_chunks`` that cannot count groups of chunks raises where
  the JAX package raises (``TypeError`` for -1 and 1.5; at -2 it raises
  ``ValueError`` and the port ``TypeError``), in ``reduce_noise`` and
  ``reduce_noise_batch``; on a signal of one chunk both compute.
- A negative ``padding`` raises ``ValueError`` in ``reduce_noise`` and
  ``reduce_noise_batch``, as in the JAX package; ``reduce_noise_file``
  computes with it, as the JAX package's does, to the same PCM16 output.
- An empty stationary noise clip gives the JAX package's output (the
  threshold of one frame of silence) in ``reduce_noise``,
  ``reduce_noise_batch``, ``StreamingGate`` and ``reduce_noise_file``:
  float64 for the in-memory calls, atol 2e-6 for the streamed float32
  ones (tests/test_torch_streaming.py's envelope).
- The torch gate's temperature takes every value the JAX package takes:
  0 (a step), 1e-40 (subnormal in float32, which the JAX package's
  division reads as 0), inf (0.5) and a negative one, through ``TPUGate``
  and ``reduce_noise(use_torch=True)``, float32 as both run it: NaN in the
  same samples, the rest within 5e-5 x max|ref| (tests/test_torch_tpugate.py's
  float32 bound); and ``TPUGate`` with a threshold of 0 and a window of
  one frame, where the ratio is exactly the threshold in every cell (0/0
  under the sigmoid for a step), NaN wherever the JAX package gives NaN.

Signals of at most 20,000 samples at 16 kHz.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr
from noisereduce_tpu.models.tpu_gate import TPUGate as JTPUGate
from noisereduce_tpu.streaming import StreamingGate as JStreamingGate
from noisereduce_tpu.streaming import reduce_noise_file as jax_file

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.utils import io as nrio

torch.set_num_threads(2)

SR, N = 16000, 20000
CK = dict(chunk_size=4000, padding=1000)
F64 = dict(device="cpu", compute_dtype=torch.float64)
ENGINES = {
    "nonstationary": dict(),
    "stationary": dict(stationary=True),
    "torch": dict(use_torch=True),
}
TOL = {"nonstationary": 1e-9, "stationary": 1e-9, "torch": 1e-8}
F32_TOL = 5e-5
STREAM_ATOL = 2e-6


def _signal(n=N, seed=40):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _same(got, ref, tol):
    """Shape, dtype, NaN positions, and the rest within tol x max|ref|, or
    within the output dtype's resolution where that is coarser (a float32
    output rounds the float64 results of both packages)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    tol = max(tol, float(np.finfo(got.dtype).eps))
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    if (~nan).any():
        g, r = got[~nan].astype(np.float64), ref[~nan].astype(np.float64)
        assert np.abs(g - r).max() <= tol * np.abs(r).max()


# ---------------------------------------------------------------------------
# a list as y
# ---------------------------------------------------------------------------
LISTS = {
    "1-D numpy scalars": lambda y: list(y),
    "1-D Python floats": lambda y: [float(v) for v in y],
    "2-D numpy scalars": lambda y: [list(y)],
    "2-D Python floats": lambda y: [[float(v) for v in y]],
}


@pytest.mark.parametrize("form", list(LISTS))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_list_input_is_an_array(engine, form):
    y = LISTS[form](_signal(3000))
    kw = ENGINES[engine]
    ref = jnr.reduce_noise(y, SR, compute_dtype=jnp.float64, **kw)
    got = nrt.reduce_noise(y, SR, **F64, **kw)
    assert got.shape == np.asarray(y).shape
    _same(got, ref, TOL[engine])


# ---------------------------------------------------------------------------
# max_parallel_chunks
# ---------------------------------------------------------------------------
def _entries():
    """(name, call(y, **kw)) of both packages' entries that take
    max_parallel_chunks and padding."""
    out = []
    for engine, kw in ENGINES.items():
        out.append((f"reduce_noise {engine}",
                    lambda pkg, y, kw=kw, **a: pkg.reduce_noise(y, SR, **kw, **a)))
    out.append(("reduce_noise_batch",
                lambda pkg, y, **a: pkg.reduce_noise_batch([y, y[::-1].copy()], SR, **a)))
    return out


ENTRIES = dict(_entries())
PORT = dict(device="cpu")


@pytest.mark.parametrize("value,jax_error", [(-1, TypeError), (1.5, TypeError),
                                             (-2, ValueError)])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_bad_max_parallel_chunks_raises(entry, value, jax_error):
    y = _signal()
    with pytest.raises(jax_error):
        ENTRIES[entry](jnr, y, max_parallel_chunks=value, **CK)
    with pytest.raises(TypeError, match="max_parallel_chunks"):
        ENTRIES[entry](nrt, y, max_parallel_chunks=value, **CK, **PORT)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_bad_max_parallel_chunks_on_one_chunk_computes(entry):
    """A signal of one chunk is never grouped: both packages compute."""
    y = _signal(3000)
    ref = ENTRIES[entry](jnr, y, max_parallel_chunks=-1, compute_dtype=jnp.float64)
    got = ENTRIES[entry](nrt, y, max_parallel_chunks=-1, **F64)
    tol = 1e-8 if "torch" in entry else 1e-9
    for g, r in zip(got if isinstance(got, list) else [got],
                    ref if isinstance(ref, list) else [ref]):
        _same(g, r, tol)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("padding", [-1, -5000])
@pytest.mark.parametrize("chunk_size", [600000, 4000])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_negative_padding_raises(entry, chunk_size, padding):
    y = _signal()
    with pytest.raises(ValueError):
        ENTRIES[entry](jnr, y, chunk_size=chunk_size, padding=padding)
    with pytest.raises(ValueError, match="padding"):
        ENTRIES[entry](nrt, y, chunk_size=chunk_size, padding=padding, **PORT)


def test_file_with_negative_padding_equals_jax(tmp_path):
    """``reduce_noise_file`` computes with padding -1 in the JAX package,
    and the port gives the same PCM16 output."""
    src = str(tmp_path / "in.wav")
    nrio.write_wav(src, _signal(), SR, as_float=False)
    kw = dict(chunk_size=4000, padding=-1)
    got, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    assert nrt.reduce_noise_file(src, got, device="cpu", **kw) == N
    jax_file(src, ref, **kw)
    a, b = (nrio.read_wav(p, dtype="int16")[1] for p in (got, ref))
    assert a.shape == b.shape == (N,) and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# an empty stationary noise clip
# ---------------------------------------------------------------------------
EMPTY_CLIPS = {
    "list": [],
    "1-D": np.zeros(0, np.float32),
    "2-D": np.zeros((2, 0), np.float32),
}


@pytest.mark.parametrize("clip", list(EMPTY_CLIPS))
def test_empty_noise_clip_reduce_noise(clip):
    y = _signal()
    yn = EMPTY_CLIPS[clip]
    ref = jnr.reduce_noise(y, SR, stationary=True, y_noise=yn, compute_dtype=jnp.float64)
    got = nrt.reduce_noise(y, SR, stationary=True, y_noise=yn, **F64)
    _same(got, ref, 1e-9)


def test_empty_noise_clip_reduce_noise_batch():
    ys = [_signal(), _signal(seed=41)]
    yn = np.zeros(0, np.float32)
    ref = jnr.reduce_noise_batch(ys, SR, y_noise=yn, stationary=True,
                                 compute_dtype=jnp.float64)
    got = nrt.reduce_noise_batch(ys, SR, y_noise=yn, stationary=True, **F64)
    for g, r in zip(got, ref):
        _same(g, r, 1e-9)


def test_empty_noise_clip_streaming_gate():
    y = _signal()

    def stream(gate):
        return np.concatenate([gate.process(y[s : s + 4000]) for s in range(0, N, 4000)]
                              + [gate.flush()])

    got = stream(nrt.StreamingGate(SR, 4000, 1000, stationary=True, y_noise=[], device="cpu"))
    ref = stream(JStreamingGate(SR, 4000, 1000, stationary=True, y_noise=[]))
    assert got.shape == ref.shape == (N,)
    np.testing.assert_allclose(got, ref, atol=STREAM_ATOL)


def test_empty_noise_clip_reduce_noise_file(tmp_path):
    src = str(tmp_path / "in.wav")
    nrio.write_wav(src, _signal(), SR, as_float=True)
    got, ref = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    kw = dict(stationary=True, y_noise=[], as_float=True, **CK)
    nrt.reduce_noise_file(src, got, device="cpu", **kw)
    jax_file(src, ref, **kw)
    a, b = (nrio.read_wav(p, dtype="float32")[1] for p in (got, ref))
    assert a.shape == b.shape == (N,)
    np.testing.assert_allclose(a, b, atol=STREAM_ATOL)


# ---------------------------------------------------------------------------
# the torch gate's temperature
# ---------------------------------------------------------------------------
TEMPS = [0.0, 1e-40, float("inf"), -0.1]
# a threshold of 0 and a window of one frame: the ratio (|Z| - ma) / ma is
# exactly 0, the threshold, in every cell
AT_THRESHOLD = dict(n_thresh_nonstationary=0.0, n_movemean_nonstationary=1)


@pytest.mark.parametrize("cells", ["noise", "at threshold"])
@pytest.mark.parametrize("temp", TEMPS, ids=str)
def test_tpugate_temperature(temp, cells):
    x = _signal(16000)[None]
    kw = dict(sr=SR, nonstationary=True, temp_coeff_nonstationary=temp)
    if cells == "at threshold":
        kw.update(AT_THRESHOLD)
    ref = np.asarray(JTPUGate(**kw)(jnp.asarray(x)))
    got = nrt.TPUGate(**kw)(torch.as_tensor(x)).numpy()
    if cells == "at threshold" and temp in (0.0, 1e-40):
        assert np.isnan(ref).any()  # 0/0 under the sigmoid, held below
    _same(got, ref, F32_TOL)


# sigmoid_slope_nonstationary s gives the temperature 1/s: inf -> 0,
# 1e40 -> 1e-40, 1e-320 -> inf, -10 -> -0.1
SLOPES = [float("inf"), 1e40, 1e-320, -10.0]


@pytest.mark.parametrize("slope", SLOPES, ids=str)
def test_reduce_noise_torch_temperature(slope):
    """No cell at the threshold here: this engine pads each view with
    silence, where the JAX package's staged ratio is 0/0 at any
    temperature and the port's plain versions give finite zeros (a pinned
    difference, ROADMAP.md Queue 3); ``test_tpugate_temperature`` holds
    those cells."""
    y = _signal()
    kw = dict(use_torch=True, sigmoid_slope_nonstationary=slope)
    ref = jnr.reduce_noise(y, SR, **kw)
    got = nrt.reduce_noise(y, SR, device="cpu", **kw)
    _same(got, ref, F32_TOL)
