"""PyTorch port: the gate and ``reduce_noise`` as a whole against the JAX
package and the golden reference outputs (CPU).

- the fused composition (kernels A-D; their plain versions on the CPU) in
  float32 against the JAX fused TPU kernel run in Pallas interpret mode, as
  tests/test_fused_pipeline.py runs it: 5e-5 x scale;
- the fused composition and the staged twin in float64 against the JAX
  staged path: 1e-9 x scale;
- ``reduce_noise(device="cpu")`` in float64 against the golden reference
  outputs at 1e-8 x scale (tests/test_golden_parity.py:55) and against the
  JAX ``reduce_noise``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr
from noisereduce_tpu.config import GateConfig as JGateConfig
from noisereduce_tpu.models.spectral_gate import _gate_nonstationary_jnp
from noisereduce_tpu.ops.pallas_pipeline import _fused_gate_impl

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models.spectral_gate import (
    _gate_nonstationary_staged,
    gate_nonstationary,
)
from noisereduce_tpu_torch.ops.cuda.dispatch import fused_gate_nonstationary

torch.set_num_threads(2)

# jitted once per config: eager op-by-op dispatch of the JAX gates costs
# seconds of per-op compilation on the first call
_jax_staged = jax.jit(_gate_nonstationary_jnp, static_argnums=(1, 2))
_jax_fused_interpret = jax.jit(_fused_gate_impl, static_argnums=(1, 2))

HERE = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 5e-5
F64_TOL = 1e-9


def _dev(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max(), np.abs(ref).max()


CASES = [
    ("default-44k", (), 30000, 44100, {}),
    ("batched-48k", (2,), 20000, 48000, {}),
    ("nfft512-16k", (), 20000, 16000, dict(n_fft=512, hop_length=128)),
]


@pytest.mark.parametrize("name,batch,n,sr,kw", CASES, ids=[c[0] for c in CASES])
def test_fused_f32_matches_jax_tpu_kernel_interpret(name, batch, n, sr, kw):
    x = np.random.default_rng(7).standard_normal(batch + (n,)).astype(np.float32)
    got = fused_gate_nonstationary(torch.as_tensor(x), GateConfig(sr=sr, **kw))
    ref = _jax_fused_interpret(jnp.asarray(x), JGateConfig(sr=sr, **kw), True)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= F32_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


F64_CASES = [
    ("default-44k", 30000, 44100, {}),
    ("nfft512-16k", 20000, 16000, dict(n_fft=512, hop_length=128)),
    ("prop-thresh-8k", 9000, 8000,
     dict(prop_decrease=0.6, thresh_n_mult_nonstationary=1.2,
          sigmoid_slope_nonstationary=25)),
    ("no-smoothing", 12000, 22050,
     dict(freq_mask_smooth_hz=None, time_mask_smooth_ms=None)),
    ("time-only", 12000, 16000, dict(freq_mask_smooth_hz=None)),
    ("win-lt-nfft", 12000, 16000, dict(n_fft=2048, win_length=1024)),
]


@pytest.mark.parametrize("name,n,sr,kw", F64_CASES, ids=[c[0] for c in F64_CASES])
def test_gate_f64_matches_jax_staged(name, n, sr, kw):
    x = np.random.default_rng(8).standard_normal((2, n))
    ref = _jax_staged(jnp.asarray(x), JGateConfig(sr=sr, **kw), "fft")
    cfg = GateConfig(sr=sr, **kw)
    for got in (
        fused_gate_nonstationary(torch.as_tensor(x), cfg),
        _gate_nonstationary_staged(torch.as_tensor(x), cfg),
    ):
        dev, scale = _dev(got.numpy(), ref)
        assert dev <= F64_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


def test_geometry_without_kernels_takes_the_staged_path_on_cpu():
    """A hop that does not divide the window is not served by kernels A-D;
    on the CPU the staged twin gates it, as the JAX staged path does."""
    kw = dict(n_fft=1024, hop_length=300)
    x = np.random.default_rng(9).standard_normal(12000)
    got = gate_nonstationary(torch.as_tensor(x), GateConfig(sr=16000, **kw))
    ref = _jax_staged(jnp.asarray(x), JGateConfig(sr=16000, **kw), "fft")
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= F64_TOL * scale


def test_silence_gives_finite_zeros_like_the_jax_kernel():
    x = np.zeros((2, 12000), np.float32)
    got = fused_gate_nonstationary(torch.as_tensor(x), GateConfig(sr=16000))
    ref = np.asarray(_jax_fused_interpret(jnp.asarray(x), JGateConfig(sr=16000), True))
    assert np.all(np.isfinite(got.numpy())) and np.all(got.numpy() == 0.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the staged twin keeps the reference's 0/0 floor ratio: NaN wherever
    # the JAX staged path has NaN (the istft span), zero-filled past it
    x64 = x.astype(np.float64)
    staged = _gate_nonstationary_staged(torch.as_tensor(x64), GateConfig(sr=16000))
    jstaged = np.asarray(_jax_staged(jnp.asarray(x64), JGateConfig(sr=16000), "fft"))
    assert np.isnan(jstaged).any()
    np.testing.assert_array_equal(np.isnan(staged.numpy()), np.isnan(jstaged))
    out = nrt.reduce_noise(np.zeros(12000, np.int16), 16000, device="cpu")
    assert out.dtype == np.int16 and np.all(out == 0)


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(HERE, "golden", "golden_v1.npz"))
    with open(os.path.join(HERE, "golden", "golden_v1.json")) as f:
        meta = json.load(f)
    return data, meta


@pytest.mark.parametrize("name", ["nonstationary", "nonstationary_chunked"])
def test_reduce_noise_f64_matches_golden(golden, name):
    data, meta = golden
    cfg = meta["configs"][name]
    out = nrt.reduce_noise(data[cfg["input"]], meta["sr"], device="cpu",
                           compute_dtype=torch.float64, **cfg["kwargs"])
    ref = data[f"out_{name}"]
    assert out.shape == ref.shape and out.dtype == ref.dtype
    dev, scale = _dev(out, ref)
    assert dev <= max(1e-8 * max(scale, 1.0), 1e-4), f"{name}: {dev}"


@pytest.mark.parametrize("name", ["nonstationary", "nonstationary_chunked"])
def test_reduce_noise_f32_matches_golden(golden, name):
    data, meta = golden
    cfg = meta["configs"][name]
    out = nrt.reduce_noise(data[cfg["input"]], meta["sr"], device="cpu",
                           **cfg["kwargs"])
    dev, scale = _dev(out, data[f"out_{name}"])
    assert dev <= F32_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


@pytest.mark.parametrize("shape,dtype,kw", [
    ((2, 20000), np.float64, dict(chunk_size=8000, padding=1500)),
    ((2, 20000), np.float64, {}),
    ((20000,), np.float64, dict(chunk_size=8000, padding=1500)),
    ((20000,), np.int16, dict(chunk_size=8000, padding=1500)),
    ((2, 12000), np.float32, dict(prop_decrease=0.5, n_fft=512, hop_length=128)),
], ids=["stereo-chunked", "stereo-unchunked", "mono-flat", "int16", "float32-in"])
def test_reduce_noise_matches_jax_reduce_noise(shape, dtype, kw):
    rng = np.random.default_rng(10)
    y = rng.standard_normal(shape) * (3000 if dtype == np.int16 else 1)
    y = y.astype(dtype)
    got = nrt.reduce_noise(y, 16000, device="cpu", compute_dtype=torch.float64, **kw)
    ref = np.asarray(jnr.reduce_noise(y, 16000, **kw))
    assert got.shape == ref.shape == y.shape and got.dtype == ref.dtype == y.dtype
    dev, scale = _dev(got, ref)
    if dtype == np.int16:  # float -> int16 truncation may flip by one step
        assert dev <= 1
    else:  # float64 compute, then the output's own rounding
        assert dev <= max(F64_TOL, np.finfo(dtype).eps) * scale
