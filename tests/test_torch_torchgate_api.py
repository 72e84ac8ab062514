"""PyTorch port: ``reduce_noise(use_torch=True)`` and
``reduce_noise_batch(use_torch=True)`` against the golden reference outputs
and the JAX package (CPU, float64, ``device="cpu"``: the kernels' plain
versions).

- the golden ``out_torch_*_chunked`` outputs at tests/test_golden_parity.py:55's
  bound;
- the JAX ``reduce_noise(use_torch=True)``: unchunked and chunked, mono and
  stereo, non-stationary and stationary with self-noise, a 1-D clip, a 2-D
  clip and a clip longer than the signal (the reference cuts it along its
  first axis), at 1e-8 x scale: the kernels smooth with the rank-1 SVD
  factors of TorchGate's float32-rounded kernel, the JAX staged path with
  every rank (the others are ~1e-8 of the first);
- ``reduce_noise_batch(use_torch=True)``: each row bitwise its per-signal
  call;
- the reference's ``ValueError`` for ``n_jobs != 1`` and the arguments that
  still raise.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr

import noisereduce_tpu_torch as nrt

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
F64 = dict(device="cpu", compute_dtype=torch.float64)
RANK1_TOL = 1e-8


def _dev(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max(), np.abs(ref).max()


@pytest.mark.parametrize("name", ["torch_nonstationary_chunked", "torch_stationary_chunked"])
def test_golden_torch_outputs(name):
    data = np.load(os.path.join(HERE, "golden", "golden_v1.npz"))
    with open(os.path.join(HERE, "golden", "golden_v1.json")) as f:
        meta = json.load(f)
    cfg = meta["configs"][name]
    kw = dict(cfg["kwargs"], compute_dtype=torch.float64)
    assert kw["device"] == "cpu" and kw["use_torch"]
    ours = nrt.reduce_noise(data[cfg["input"]], meta["sr"], **kw)
    ref = data[f"out_{name}"]
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    dev = np.abs(ours - ref).max()
    scale = max(np.abs(ref).max(), 1.0)
    tol = 5e-7 * scale if name.startswith("torch_stationary") else 1e-8 * scale
    assert dev <= max(tol, 1e-4), f"{name}: max abs dev {dev} (scale {scale})"


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


JAX_CASES = [
    ("nonstationary", (24000,), {}, None),
    ("nonstationary-chunked", (24000,), dict(chunk_size=8000, padding=1500), None),
    ("nonstationary-stereo-chunked", (2, 20000),
     dict(chunk_size=8000, padding=1500, prop_decrease=0.7), None),
    ("stationary-self-chunked", (20000,),
     dict(stationary=True, chunk_size=8000, padding=1500), None),
    ("stationary-clip1d", (20000,), dict(stationary=True), (9000,)),
    # a 1-D clip longer than the signal is cut to the signal's length
    ("stationary-clip1d-long-chunked", (20000,),
     dict(stationary=True, chunk_size=8000, padding=1500), (26000,)),
    # a 2-D clip is cut along its first axis: its channels, not its samples
    ("stationary-clip2d-stereo", (2, 20000), dict(stationary=True), (2, 26000)),
    # a hop that does not divide n_fft: the plain STFT around the mask kernels
    ("nonstationary-hop300-chunked", (24000,),
     dict(hop_length=300, chunk_size=8000, padding=1500), None),
    ("stationary-clip1d-hop300", (20000,), dict(stationary=True, hop_length=300), (9000,)),
]


@pytest.mark.parametrize("name,shape,kw,clip", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_reduce_noise_use_torch_matches_jax(name, shape, kw, clip):
    y = _signal(shape, 40)
    y_noise = None if clip is None else 0.5 * _signal(clip, 41)
    got = nrt.reduce_noise(y, 16000, use_torch=True, y_noise=y_noise, **F64, **kw)
    ref = jnr.reduce_noise(y=y, sr=16000, use_torch=True, y_noise=y_noise, device="cpu", **kw)
    assert got.dtype == np.asarray(ref).dtype
    dev, scale = _dev(got, ref)
    assert dev <= RANK1_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


def test_reduce_noise_use_torch_float32_and_int16():
    """float32 (the kernels' type) against the float64 parity mode, and an
    int16 input keeping its dtype."""
    y = _signal(20000, 42)
    got = nrt.reduce_noise(y.astype(np.float32), 16000, use_torch=True, device="cpu",
                           chunk_size=8000, padding=1500)
    ref = nrt.reduce_noise(y, 16000, use_torch=True, chunk_size=8000, padding=1500, **F64)
    assert got.dtype == np.float32
    dev, scale = _dev(got, ref)
    assert dev <= 5e-5 * scale
    yi = (y * 3000).astype(np.int16)
    out = nrt.reduce_noise(yi, 16000, use_torch=True, device="cpu")
    assert out.dtype == np.int16 and out.shape == yi.shape


BATCH_CASES = [
    ("stationary-self", dict(stationary=True), False),
    ("stationary-clips", dict(stationary=True), True),
    ("nonstationary", {}, False),
]


@pytest.mark.parametrize("name,kw,clips", BATCH_CASES, ids=[c[0] for c in BATCH_CASES])
def test_reduce_noise_batch_use_torch_is_the_per_signal_calls(name, kw, clips):
    rng = np.random.default_rng(43)
    ys = [rng.standard_normal(12000) for _ in range(3)] + [rng.standard_normal(9000)]
    # per-signal clips; the last is longer than its signal and is cut to it
    noise = ([0.5 * rng.standard_normal(6000) for _ in range(3)]
             + [0.5 * rng.standard_normal(11000)]) if clips else None
    got = nrt.reduce_noise_batch(ys, 16000, y_noise=noise, use_torch=True, **F64, **kw)
    for i, (y, g) in enumerate(zip(ys, got)):
        clip = None if noise is None else noise[i]
        want = nrt.reduce_noise(y, 16000, y_noise=clip, use_torch=True, **F64, **kw)
        np.testing.assert_array_equal(g, want)
    if name == "stationary-clips":
        ref = jnr.reduce_noise_batch(ys, 16000, y_noise=noise, use_torch=True, device="cpu", **kw)
        for g, r in zip(got, ref):
            dev, scale = _dev(g, r)
            assert dev <= RANK1_TOL * scale


def test_torch_gate_for_takes_reduce_noise_defaults():
    """``torch_gate_for``'s parameters are reduce_noise's, with its
    defaults, and it builds the gate reduce_noise(use_torch=True) runs."""
    params = inspect.signature(nrt.api.torch_gate_for).parameters
    defaults = inspect.signature(nrt.reduce_noise).parameters
    for name, p in params.items():
        assert p.default == defaults[name].default, name
    g = nrt.api.torch_gate_for(16000, hop_length=300)
    assert (g.hop_length, g.n_movemean_nonstationary, g.temp_coeff_nonstationary) == (
        300, int(2.0 / 300 * 16000), 0.1)
    with pytest.raises(TypeError):
        nrt.api.torch_gate_for(16000, hop_lenght=300)


def test_n_jobs_must_be_one_with_use_torch():
    y = np.zeros(4000)
    with pytest.raises(ValueError, match="n_jobs must be 1"):
        nrt.reduce_noise(y, 16000, use_torch=True, n_jobs=2, device="cpu")
    with pytest.raises(ValueError, match="n_jobs must be 1"):
        nrt.reduce_noise_batch([y], 16000, use_torch=True, n_jobs=2, device="cpu")
    # the scipy engines accept it, as the reference's do
    nrt.reduce_noise(y, 16000, n_jobs=2, device="cpu")


@pytest.mark.parametrize("kw,err", [
    (dict(use_tqdm=True), NotImplementedError),
    (dict(compute_dtype=torch.bfloat16), NotImplementedError),
    (dict(prop_decrease=1.5), ValueError),
    (dict(freq_mask_smooth_hz=5), ValueError),
], ids=["tqdm", "bf16", "prop", "smoothing"])
def test_use_torch_arguments_that_raise(kw, err):
    with pytest.raises(err):
        nrt.reduce_noise(np.zeros(8000), 16000, use_torch=True, device="cpu", **kw)


def test_use_torch_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrt.reduce_noise(np.zeros(8000), 16000, use_torch=True)
