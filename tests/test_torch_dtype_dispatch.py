"""PyTorch port: the dtype rule of the dispatch. The kernels take float32
and bfloat16 on the card; a card tensor of another dtype (float64) goes to the staged
twins, as the JAX package sends a dtype its kernels do not take to its
staged path on any device (noisereduce_tpu/models/spectral_gate.py:115-119),
and the kernel wrappers keep raising on it (tests/test_torch_cuda.py holds
both on a card).

On the CPU, with no card: the predicate ``dispatch.kernels_take`` for a
tensor on a CUDA device, and every entry point with the predicate
answering as it answers for a float64 card tensor while any kernel wrapper
fails if called; their outputs then match the JAX package's float64
``reduce_noise`` (its staged path) at 1e-9 x max|ref|.
"""
import types

import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models import spectral_gate as SG
from noisereduce_tpu_torch.ops.cuda import dispatch
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda import torch_dispatch
from noisereduce_tpu_torch.ops.dsp import noise_db_threshold
from noisereduce_tpu_torch.ops.stft import stft

torch.set_num_threads(2)

F64_TOL = 1e-9


def _on(device, dtype):
    """A stand-in for a tensor on ``device``: the predicates read only its
    device and dtype, and no card is needed to name a CUDA device."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16])
def test_card_tensors_of_other_dtypes_never_reach_the_kernels(dtype):
    """float64 and float16 card tensors never reach the kernels; bfloat16
    ones do (the bf16 mode runs the kernels' bfloat16 builds)."""
    cfg, gate = GateConfig(sr=16000), nrt.TPUGate(sr=16000, nonstationary=True)
    card, card32 = _on("cuda:0", dtype), _on("cuda", torch.float32)
    takes = dtype == torch.bfloat16
    assert dispatch.kernels_take(card) == takes
    assert dispatch.fused_gate_supported(cfg, card) == takes
    assert torch_dispatch.fused_tpugate_supported(gate, card) == takes
    assert dispatch.kernels_take(card32) and dispatch.fused_gate_supported(cfg, card32)
    assert torch_dispatch.fused_tpugate_supported(gate, card32)
    # on the CPU every dtype runs the kernels' plain versions (the parity mode)
    assert dispatch.kernels_take(_on("cpu", dtype))
    # a geometry the kernels do not serve, whatever the dtype
    assert not dispatch.fused_gate_supported(GateConfig(sr=16000, hop_length=300), card32)


@pytest.fixture
def as_card_float64(monkeypatch):
    """Every dispatch sees what a float64 card tensor gives; a kernel
    wrapper, if called, fails."""
    for mod in (dispatch, torch_dispatch, SG):
        monkeypatch.setattr(mod, "kernels_take", lambda x: False)

    def no_kernel(*ts):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(K, "_on_cpu", no_kernel)


def _signal(shape, seed=70):
    return np.random.default_rng(seed).standard_normal(shape)


CASES = {
    "nonstationary": {},
    "nonstationary-chunked": dict(chunk_size=8000, padding=1500),
    "nonstationary-hop300": dict(hop_length=300, chunk_size=8000, padding=1500),
    "stationary-clip-chunked": dict(stationary=True, chunk_size=8000, padding=1500),
    "stationary-self": dict(stationary=True),
    "use_torch-chunked": dict(use_torch=True, chunk_size=8000, padding=1500),
    "use_torch-stationary-clip": dict(use_torch=True, stationary=True),
    "use_torch-hop300-chunked": dict(use_torch=True, hop_length=300, chunk_size=8000,
                                     padding=1500),
}


@pytest.mark.parametrize("name", CASES)
def test_reduce_noise_runs_the_staged_twins(as_card_float64, name):
    kw = dict(CASES[name])
    if name.startswith("stationary-clip") or name == "use_torch-stationary-clip":
        kw["y_noise"] = 0.5 * _signal(9000, 71)
    y = _signal((2, 20000))
    got = nrt.reduce_noise(y, 16000, device="cpu", compute_dtype=torch.float64, **kw)
    ref = np.asarray(jnr.reduce_noise(y, 16000, **kw))
    assert got.shape == ref.shape == y.shape
    assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max()


def test_gates_run_the_staged_twins(as_card_float64):
    """gate_nonstationary, gate_stationary, the threshold and TPUGate's
    three entries give their staged twins' values, and NaN on silence as
    the twins (and the JAX staged path) do, where the kernels give zeros."""
    x = torch.as_tensor(_signal((2, 16000)))
    cfg, scfg = GateConfig(sr=16000), GateConfig(sr=16000, stationary=True)
    noise = 0.5 * x[0, :9000]
    thr = SG.stationary_noise_threshold(noise, scfg)
    assert torch.equal(thr, noise_db_threshold(*stft(noise, scfg.stft),
                                               scfg.n_std_thresh_stationary))
    assert torch.equal(SG.gate_nonstationary(x, cfg), SG._gate_nonstationary_staged(x, cfg))
    assert torch.equal(SG.gate_stationary(x, thr, scfg),
                       SG._gate_stationary_staged(x, thr, scfg))
    gate = nrt.TPUGate(sr=16000, nonstationary=True)
    assert torch.equal(gate(x), gate._call_staged(x))
    chunks = torch.stack([x, x.flip(-1)], 1)  # (channels, n_chunks, view)
    want = gate._call_staged(chunks.reshape(4, -1))
    got = gate.batched_chunks(chunks).reshape(4, -1)
    assert torch.equal(got[:, : want.shape[-1]], want) and not got[:, want.shape[-1]:].any()
    assert torch.isnan(SG.gate_nonstationary(torch.zeros(1, 16000, dtype=torch.float64),
                                             cfg)).any()
