"""PyTorch port: the bf16 mode (``compute_dtype=torch.bfloat16``) on the CPU,
against the JAX package's bf16 mode and both packages' float32 outputs.

The envelopes are tests/test_bfloat16_mode.py's (rel max, rel rms of the
bf16 output against float32): non-stationary and chunked 50000 / 5000
2.5e-2 / 1.2e-2, stationary 1.5e-1 / 1.0e-1, ``use_torch`` 5e-2 (max).
The port's bf16 output is held to its own float32 output and to the JAX
package's, and to the JAX package's bf16 output (``method="fft"``) within
the sum of the two envelopes. The kernels' plain versions, which the CPU
runs for ``device="cpu"``, take bf16 as the kernels do: in float32, rounded
to bf16 where the kernel stores (A's planes, D's output).

White noise at 48 kHz, 2 s (4 s in the JAX test; the chunked case still
has two chunks): the worst case for the stationary binary gate.
"""
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr
from noisereduce_tpu.models.tpu_gate import TPUGate as JTPUGate

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig, StftConfig
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
from noisereduce_tpu_torch.ops.dsp import tri_norm

torch.set_num_threads(2)

SR = 48000
Y = np.random.default_rng(0).standard_normal(SR * 2).astype(np.float32)
BF16 = torch.bfloat16

# case -> (reduce_noise keywords, rel max, rel rms (None: not pinned))
CASES = {
    "nonstationary": (dict(), 2.5e-2, 1.2e-2),
    "chunked": (dict(chunk_size=50000, padding=5000), 2.5e-2, 1.2e-2),
    "stationary": (dict(stationary=True), 1.5e-1, 1.0e-1),
    "use_torch": (dict(use_torch=True), 5e-2, None),
}
# geometries the kernels A and D do not serve (a hop that does not divide
# the window): the staged STFT / iSTFT in bf16 around kernel B (row 7),
# the staged stationary gate, and staged_tpugate around F
STAGED = {
    "staged-nonstationary": (dict(hop_length=300), 2.5e-2, 1.2e-2),
    "staged-stationary": (dict(hop_length=300, stationary=True), 1.5e-1, 1.0e-1),
    "staged-use_torch": (dict(hop_length=300, use_torch=True), 5e-2, None),
}


def _rel_devs(a, b):
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = a64 - b64
    return (np.max(np.abs(d)) / np.max(np.abs(a64)),
            np.sqrt(np.mean(d**2)) / np.sqrt(np.mean(a64**2)))


def _quiet(fn, *args, **kw):
    """``fn`` with the stationary bf16 warning silenced (its own test
    below holds it)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _port(case, dtype):
    kw = {**CASES, **STAGED}[case][0]
    return _quiet(nrt.reduce_noise, Y, SR, device="cpu", compute_dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _jax(case, bf16):
    kw = CASES[case][0]
    cdtype = jnp.bfloat16 if bf16 else np.float32
    return _quiet(jnr.reduce_noise, Y, SR, compute_dtype=cdtype, method="fft", **kw)


def _within(ref, got, rel_max, rel_rms, factor=1.0):
    dev_max, dev_rms = _rel_devs(ref, got)
    assert dev_max <= factor * rel_max, dev_max
    if rel_rms is not None:
        assert dev_rms <= factor * rel_rms, dev_rms


@pytest.mark.parametrize("case", list(CASES) + list(STAGED))
def test_bf16_envelope_against_the_ports_float32(case):
    _, rel_max, rel_rms = {**CASES, **STAGED}[case]
    b16 = _port(case, BF16)
    assert b16.dtype == np.float32 and b16.shape == Y.shape
    _within(_port(case, torch.float32), b16, rel_max, rel_rms)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_envelope_against_jax_float32(case):
    _, rel_max, rel_rms = CASES[case]
    _within(_jax(case, False), _port(case, BF16), rel_max, rel_rms)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_matches_jax_bf16(case):
    """Each bf16 output is within its envelope of float32, so the two are
    within the sum of the two envelopes of each other."""
    _, rel_max, rel_rms = CASES[case]
    _within(_jax(case, True), _port(case, BF16), rel_max, rel_rms, factor=2.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_returns_the_input_dtype(dtype):
    y = Y[:16000].astype(dtype)
    out = nrt.reduce_noise(y, SR, device="cpu", compute_dtype=BF16)
    assert out.dtype == dtype and out.shape == y.shape and np.isfinite(out).all()
    stereo = np.stack([y, y[::-1]])
    out = nrt.reduce_noise(stereo, SR, device="cpu", compute_dtype=BF16, use_torch=True)
    assert out.dtype == dtype and out.shape == stereo.shape


@pytest.mark.parametrize("kw", [dict(stationary=True), dict(stationary=True, use_torch=True)],
                         ids=["scipy", "use_torch"])
def test_stationary_bf16_warns(kw):
    with pytest.warns(UserWarning, match="bfloat16.*stationary"):
        nrt.reduce_noise(Y[: SR // 2], SR, device="cpu", compute_dtype=BF16, **kw)
    with pytest.warns(UserWarning, match="bfloat16.*stationary"):
        nrt.reduce_noise_batch([Y[: SR // 2]], SR, device="cpu", compute_dtype=BF16, **kw)


@pytest.mark.parametrize("kw", [{}, dict(use_torch=True)], ids=["scipy", "use_torch"])
def test_nonstationary_bf16_does_not_warn(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nrt.reduce_noise(Y[: SR // 2], SR, device="cpu", compute_dtype=BF16, **kw)


def test_tpugate_module_accepts_bf16():
    """The call that raised ``Unsupported dtype BFloat16`` before the bf16
    mode: bf16 in, a finite bf16 out, within the use_torch envelope of the
    float32 call and of the JAX module's bf16 output."""
    x = np.random.default_rng(1).standard_normal((2, 8000))
    gate = nrt.TPUGate(sr=8000, nonstationary=True, n_fft=256)
    out = gate(torch.as_tensor(x, dtype=BF16))
    assert out.dtype == BF16 and bool(torch.isfinite(out.float()).all())
    got = out.float().numpy()
    _within(gate(torch.as_tensor(x, dtype=torch.float32)).numpy(), got, 5e-2, None)
    jgate = JTPUGate(**gate.fields())
    jout = np.asarray(jgate(jnp.asarray(x, dtype=jnp.bfloat16), method="fft"), np.float32)
    _within(jout, got, 5e-2, None, factor=2.0)


@pytest.mark.parametrize("nonstationary", [True, False], ids=["nonstationary", "stationary-clip"])
def test_tpugate_bf16_gradients_are_finite_bf16(nonstationary):
    """Under grad the value is the kernels' (their plain versions here) and
    the cotangent comes from the bf16 staged twin: finite, in the primals'
    dtype."""
    rng = np.random.default_rng(2)
    gate = nrt.TPUGate(sr=8000, nonstationary=nonstationary, n_fft=256)
    x = torch.as_tensor(rng.standard_normal((2, 8000)), dtype=BF16).requires_grad_()
    xn = None
    if not nonstationary:
        xn = torch.as_tensor(rng.standard_normal(4000), dtype=BF16).requires_grad_()
    out = gate(x, xn)
    with torch.no_grad():
        assert torch.equal(out, gate(x, xn))  # the serving value
    (out.float() ** 2).mean().backward()
    for p in (x, xn):
        if p is not None:
            assert p.grad.dtype == BF16 and bool(torch.isfinite(p.grad.float()).all())
    assert float(x.grad.float().abs().max()) > 0


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal(shape), dtype=BF16) for _ in range(2))


@pytest.mark.parametrize("convention", ["scipy", "torch"])
def test_bf16_plain_versions_round_where_their_kernels_store(convention):
    """A: the float32 plain version on the widened signal, planes rounded to
    bf16; B, E, F: the float32 plain versions on the widened planes, a
    float32 mask; D: the float32 plain version, the output rounded to bf16.
    The wrappers on the CPU are those plain versions."""
    extra = {} if convention == "scipy" else dict(convention="torch", quantize_window_f32=True)
    geo = gate_geometry(StftConfig(n_fft=512, hop_length=128, **extra), 6000)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 20000)), dtype=BF16)
    re, im = K.spectra(x, geo, 4000, 1000)
    r32, i32 = K.spectra_ref(x.float(), geo, 4000, 1000)
    assert re.dtype == im.dtype == BF16
    assert torch.equal(re, r32.to(BF16)) and torch.equal(im, i32.to(BF16))

    cfg = GateConfig(sr=16000)
    wide = (re.float(), im.float())
    b = (cfg.iir_b, 2.0, 10.0, tri_norm(2))
    m = K.nonstationary_mask(re, im, *b)
    assert m.dtype == torch.float32 and torch.equal(m, K.nonstationary_mask_ref(*wide, *b))
    thr = torch.linspace(-30.0, 0.0, geo.n_bins)
    for e, kw in (((thr, 1, 0.8, tri_norm(2)), {}),
                  ((None, 1, 0.8, tri_norm(2)), dict(top_db=40.0, n_std=1.5))):
        got = K.stationary_mask(re, im, *e, **kw)
        assert got.dtype == torch.float32
        assert torch.equal(got, K.stationary_mask_ref(*wide, *e, **kw))
    f = (20, 1.3, 0.1, 0.8, tri_norm(2))
    got = K.torch_nonstationary_mask(re, im, *f)
    assert got.dtype == torch.float32
    assert torch.equal(got, K.torch_nonstationary_mask_ref(*wide, *f))

    y = K.istft_ola(re, im, m, geo, 1000, 4000)
    assert y.dtype == BF16
    assert torch.equal(y, K.istft_ola_ref(*wide, m, geo, 1000, 4000).to(BF16))


@pytest.mark.parametrize("kw", [{}, dict(stationary=True), dict(use_torch=True)],
                         ids=["nonstationary", "stationary", "use_torch"])
def test_bf16_grouped_call_is_bitwise_the_ungrouped_one(kw):
    y = np.random.default_rng(4).standard_normal((2, 21200)).astype(np.float32)
    kw = dict(kw, chunk_size=4000, padding=1000, device="cpu", compute_dtype=BF16)
    whole = _quiet(nrt.reduce_noise, y, 16000, **kw)
    for g in (1, 2):
        assert np.array_equal(_quiet(nrt.reduce_noise, y, 16000, max_parallel_chunks=g, **kw),
                              whole)


@pytest.mark.parametrize("kw", [{}, dict(stationary=True), dict(use_torch=True)],
                         ids=["nonstationary", "stationary-self", "use_torch"])
def test_bf16_reduce_noise_batch_is_the_per_signal_calls(kw):
    rng = np.random.default_rng(5)
    ys = [rng.standard_normal(n).astype(np.float32) for n in (12000, 12000, 9000)]
    kw = dict(kw, device="cpu", compute_dtype=BF16)
    got = _quiet(nrt.reduce_noise_batch, ys, 16000, **kw)
    for g, y in zip(got, ys):
        want = _quiet(nrt.reduce_noise, y, 16000, **kw)
        assert g.dtype == y.dtype and np.array_equal(g, want)
