"""PyTorch port: the stationary engine, ``reduce_noise_batch``, the staged
non-stationary geometry (kernel B with one unit tap, TPU kernel row 7) and
the split geometry (row 2), against the JAX package (CPU).

Inputs come from ``np.random.default_rng(seed)`` and go to both packages as
numpy arrays. Bounds:

- dB values (``amp_to_db``, thresholds): float64 1e-13 x max|dB| / 1e-9
  dB; the port's float32 kernel-A route against the JAX fused threshold
  2e-3 dB, the bound tests/test_fused_pipeline.py:265 gives float32
  statistics;
- masks: float64 1e-12, float32 1e-5 (mask units);
- gated signals: float32 5e-5 x scale against the JAX kernels in Pallas
  interpret mode (tests/test_fused_pipeline.py:205), float64 1e-9 x scale
  against the JAX staged path, golden outputs 1e-8 x scale
  (tests/test_golden_parity.py:55).
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
from noisereduce_tpu.models.spectral_gate import (
    _gate_nonstationary_jnp,
    _gate_stationary_jnp,
)
from noisereduce_tpu.models.spectral_gate import (
    stationary_noise_threshold as j_threshold,
)
from noisereduce_tpu.ops import dsp as jdsp
from noisereduce_tpu.ops.pallas.geometry import _geometry, _merged_halo, _merged_supported
from noisereduce_tpu.ops.pallas_mask import fused_nonstationary_mask_tm
from noisereduce_tpu.ops.pallas_pipeline import _fused_gate_impl, fused_stationary_threshold

import noisereduce_tpu_torch as nrt
import noisereduce_tpu_torch.api as api
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models.spectral_gate import (
    _gate_stationary_staged,
    gate_nonstationary,
    stationary_noise_threshold,
)
from noisereduce_tpu_torch.ops import dsp
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_chunked,
    fused_gate_nonstationary,
    fused_gate_stationary,
)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 5e-5
F64_TOL = 1e-9

_j_threshold = jax.jit(j_threshold, static_argnums=(1, 2, 3))
_j_fused_threshold = jax.jit(fused_stationary_threshold, static_argnums=(1, 2))
_j_staged_stat = jax.jit(_gate_stationary_jnp, static_argnums=(2, 3))
_j_staged_nonstat = jax.jit(_gate_nonstationary_jnp, static_argnums=(1, 2, 3))
_j_fused_interpret = jax.jit(_fused_gate_impl, static_argnums=(1, 2))
_j_mask_tm = jax.jit(fused_nonstationary_mask_tm, static_argnums=(2, 3, 4, 5))


def _t(a):
    return torch.as_tensor(np.array(a))


def _dev(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max(), np.abs(ref).max()


def _noise(seed, shape, level=0.5):
    return level * np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# (a) amp_to_db
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, -2])
def test_amp_to_db_matches_jax(axis):
    x = np.random.default_rng(0).standard_normal((3, 40, 33)) * 1e-3
    x[0, :5] = 0.0  # exact zeros: the eps term
    got = dsp.amp_to_db(_t(x), top_db=80.0, axis=axis)
    ref = np.asarray(jdsp.amp_to_db(jnp.asarray(x), top_db=80.0, axis=axis))
    # relative to the dB scale (|ref| reaches ~313 dB at the eps floor):
    # XLA:CPU's log10 differs from torch's by a few hundred ulps there,
    # depending on how XLA threads the call, so an absolute 1e-12 dB is
    # not steady; 1e-13 x max|ref| is ~3e-11 dB
    assert np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# (b) stationary_noise_threshold
# ---------------------------------------------------------------------------
THR_CASES = [
    ("default-44k", (20000,), 44100, {}),
    ("rows-16k-nfft512", (3, 9000), 16000, dict(n_fft=512, hop_length=128)),
    ("hop300-16k", (9000,), 16000, dict(n_fft=1024, hop_length=300)),
]


@pytest.mark.parametrize("name,shape,sr,kw", THR_CASES, ids=[c[0] for c in THR_CASES])
def test_threshold_f64_matches_jax_staged(name, shape, sr, kw):
    noise = _noise(1, shape)
    got = stationary_noise_threshold(_t(noise), GateConfig(sr=sr, stationary=True, **kw))
    ref = _j_threshold(jnp.asarray(noise), JGateConfig(sr=sr, stationary=True, **kw),
                       "fft", False)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-9


@pytest.mark.parametrize("sr,kw", [(44100, {}), (16000, dict(n_fft=512, hop_length=128))],
                         ids=["default-44k", "nfft512-16k"])
def test_threshold_f32_kernel_route_matches_jax_fused(sr, kw):
    noise = _noise(2, 20000, 0.3).astype(np.float32)
    got = stationary_noise_threshold(_t(noise), GateConfig(sr=sr, stationary=True, **kw))
    ref = _j_fused_threshold(jnp.asarray(noise), JGateConfig(sr=sr, stationary=True, **kw),
                             True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max() <= 2e-3


@pytest.mark.parametrize("n_clip", [100, 600])
def test_noise_clip_shorter_than_window(n_clip):
    """Clips shorter than win - hop + 1 samples crash the reference inside
    scipy; here, as in the JAX package, the STFT's zero-padded framing
    applies and the gate runs (tests/test_validation.py:93)."""
    rng = np.random.default_rng(7)
    y = rng.standard_normal(8000)
    out = nrt.reduce_noise(y, 22050, stationary=True, y_noise=rng.standard_normal(n_clip),
                           device="cpu")
    assert out.shape == y.shape and np.all(np.isfinite(out))


# ---------------------------------------------------------------------------
# (c) kernel E's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sr,kw,prop", [
    (48000, {}, 1.0), (16000, dict(n_fft=512, hop_length=128), 0.6),
    (22050, dict(time_mask_smooth_ms=None), 0.8),
], ids=["48k", "16k-nfft512-prop0.6", "no-time-smoothing"])
def test_stationary_mask_ref_matches_jax(sr, kw, prop):
    cfg = GateConfig(sr=sr, stationary=True, **kw)
    nb = cfg.stft.n_bins
    rng = np.random.default_rng(3)
    re, im = rng.standard_normal((2, 3, 150, nb)) * 1e-2
    re[:, :, 40:60] *= 30.0  # a loud stretch, so the mask has both values
    thr = -40.0 + rng.standard_normal((3, nb))
    ngt = cfg.smoothing[1] if cfg.smoothing else 0
    got = K.stationary_mask_ref(_t(re), _t(im), _t(thr), 1, prop, dsp.tri_norm(ngt))
    db = jdsp.amp_to_db(jnp.sqrt(jnp.asarray(re) ** 2 + jnp.asarray(im) ** 2), 80.0,
                        axis=-2)
    m = (db > jnp.asarray(thr)[:, None, :]).astype(jnp.float64) * prop + (1.0 - prop)
    ref = jdsp.smooth_mask(m, 0, ngt, time_major=True) if ngt else m
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-12


def test_stationary_mask_ref_reads_a_threshold_row_per_views_per_row():
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal((2, 6, 20, 9))
    thr = rng.standard_normal((2, 9))
    taps = dsp.tri_norm(2)
    got = K.stationary_mask_ref(_t(re), _t(im), _t(thr), 3, 0.7, taps)
    for v in range(6):
        one = K.stationary_mask_ref(_t(re[v:v + 1]), _t(im[v:v + 1]), _t(thr[v // 3]),
                                    1, 0.7, taps)
        np.testing.assert_array_equal(got[v:v + 1].numpy(), one.numpy())
    with pytest.raises(ValueError, match="threshold of shape"):
        K.stationary_mask_ref(_t(re), _t(im), _t(thr), 2, 0.7, taps)


# ---------------------------------------------------------------------------
# (d) the stationary gate
# ---------------------------------------------------------------------------
GATE_CASES = [
    ("default-44k", (2,), 20000, 44100, {}),
    ("nfft512-prop0.7-16k", (), 12000, 16000, dict(n_fft=512, hop_length=128,
                                                   prop_decrease=0.7)),
]


def _thr_f32(sr, kw, seed=5, rows=()):
    noise = _noise(seed, rows + (16000,)).astype(np.float32)
    return np.asarray(_j_threshold(jnp.asarray(noise),
                                   JGateConfig(sr=sr, stationary=True, **kw), "fft", False))


@pytest.mark.parametrize("name,batch,n,sr,kw", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_fused_stationary_f32_matches_jax_tpu_kernel_interpret(name, batch, n, sr, kw):
    x = np.random.default_rng(6).standard_normal(batch + (n,)).astype(np.float32)
    thr = _thr_f32(sr, kw)
    got = fused_gate_stationary(_t(x), _t(thr), GateConfig(sr=sr, stationary=True, **kw))
    ref = _j_fused_interpret(jnp.asarray(x), JGateConfig(sr=sr, stationary=True, **kw), True,
                             noise_thresh=jnp.asarray(thr))
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= F32_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


STAGED_CASES = [
    ("default-44k", 20000, 44100, {}),
    ("nfft512-prop0.6", 12000, 16000, dict(n_fft=512, hop_length=128, prop_decrease=0.6)),
    ("no-smoothing", 9000, 22050, dict(freq_mask_smooth_hz=None, time_mask_smooth_ms=None)),
    ("hop300", 12000, 16000, dict(n_fft=1024, hop_length=300)),
]


@pytest.mark.parametrize("name,n,sr,kw", STAGED_CASES, ids=[c[0] for c in STAGED_CASES])
def test_gate_f64_matches_jax_staged(name, n, sr, kw):
    x = np.random.default_rng(8).standard_normal((2, n))
    jcfg, cfg = JGateConfig(sr=sr, stationary=True, **kw), GateConfig(sr=sr, stationary=True,
                                                                         **kw)
    thr = np.asarray(_j_threshold(jnp.asarray(_noise(9, 8000)), jcfg, "fft", False))
    ref = _j_staged_stat(jnp.asarray(x), jnp.asarray(thr), jcfg, "fft")
    got = [_gate_stationary_staged(_t(x), _t(thr), cfg)]
    if name != "hop300":  # kernels A, E, C, D serve only a hop dividing the window
        got.append(fused_gate_stationary(_t(x), _t(thr), cfg))
    for g in got:
        dev, scale = _dev(g.numpy(), ref)
        assert dev <= F64_TOL * scale, f"{name}: rel dev {dev / scale:.3e}"


@pytest.mark.parametrize("chunked", [False, True], ids=["unchunked", "chunked"])
def test_per_row_thresholds_equal_single_row_calls(chunked):
    """A (B, bins) threshold gates each row exactly as the single-row call
    with that row's threshold does (tests/test_fused_pipeline.py:208-250)."""
    cfg = GateConfig(sr=44100, stationary=True)
    x = np.random.default_rng(10).standard_normal((3, 20000)).astype(np.float32)
    thr = stationary_noise_threshold(_t(x[:, :8000] * np.float32([[0.5], [1.0], [2.0]])), cfg)
    assert thr.shape == (3, cfg.stft.n_bins)
    if chunked:
        def run(xx, tt):
            return fused_gate_chunked(_t(xx), cfg, 8000, 1500, noise_thresh=tt)
    else:
        def run(xx, tt):
            return fused_gate_stationary(_t(xx), tt, cfg)
    got = run(x, thr).numpy()
    for b in range(3):
        want = run(x[b:b + 1], thr[b]).numpy()[0]
        np.testing.assert_array_equal(got[b], want)


# ---------------------------------------------------------------------------
# (e) reduce_noise, stationary
# ---------------------------------------------------------------------------
STAT_GOLDEN = ["stationary_self", "stationary_noise_clip", "stationary_multichannel",
               "stationary_recorded_noise_nfft2048"]


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(HERE, "golden", "golden_v1.npz"))
    with open(os.path.join(HERE, "golden", "golden_v1.json")) as f:
        meta = json.load(f)
    return data, meta


def _golden_call(golden, name, **kw):
    data, meta = golden
    cfg = meta["configs"][name]
    extra = dict(cfg["kwargs"])
    if cfg["use_noise"]:
        extra["y_noise"] = data["noise"][: meta["sr"] // 4]
    if cfg.get("use_recorded_noise"):
        extra["y_noise"] = data["cafe_clip"]
    out = nrt.reduce_noise(data[cfg["input"]], meta["sr"], device="cpu", **extra, **kw)
    return out, data[f"out_{name}"]


@pytest.mark.parametrize("name", STAT_GOLDEN)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reduce_noise_stationary_matches_golden(golden, name, dtype):
    out, ref = _golden_call(golden, name, compute_dtype=getattr(torch, dtype))
    assert out.shape == ref.shape and out.dtype == ref.dtype
    dev, scale = _dev(out, ref)
    tol = 1e-8 * max(scale, 1.0) if dtype == "float64" else F32_TOL * scale
    assert dev <= tol, f"{name} {dtype}: max|dev| {dev:.3e} (scale {scale:.3e})"


def test_stationary_silence_gives_zeros():
    """The stationary engine has no 0/0: silence stays silent
    (tests/test_validation.py:87-90)."""
    out = nrt.reduce_noise(np.zeros(8000), 22050, stationary=True, device="cpu")
    assert np.all(out == 0.0)


# ---------------------------------------------------------------------------
# (f) reduce_noise_batch
# ---------------------------------------------------------------------------
def _signals(seed=11):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(20000).astype(np.float32),
        rng.standard_normal(20000).astype(np.float32),  # same length: one group
        rng.standard_normal(12000).astype(np.float32),  # another length
        (rng.standard_normal(20000) * 8000).astype(np.int16),  # another dtype
    ]


def _clips(kind):
    rng = np.random.default_rng(12)
    if kind == "shared":
        return (0.3 * rng.standard_normal(8000)).astype(np.float32)
    if kind == "per-signal-1d":
        return [(0.2 * rng.standard_normal(6000 + 500 * (i % 2))).astype(np.float32)
                for i in range(4)]
    if kind == "per-signal-2d":
        return [(0.2 * rng.standard_normal((2, 6000))).astype(np.float32) for _ in range(4)]
    return None


BATCH_CASES = [
    # name, stationary, noise kind, deferred calls, outputs bitwise the
    # per-signal call's
    ("self-noise", True, None, 3, True),
    ("shared-clip", True, "shared", 3, False),
    ("per-signal-1d", True, "per-signal-1d", 4, True),
    ("per-signal-2d", True, "per-signal-2d", 4, True),
    ("nonstationary", False, None, 3, False),
]


@pytest.mark.parametrize("name,stationary,kind,n_calls,bitwise", BATCH_CASES,
                         ids=[c[0] for c in BATCH_CASES])
def test_reduce_noise_batch_matches_jax_and_per_signal_calls(
    monkeypatch, name, stationary, kind, n_calls, bitwise
):
    ys, noise = _signals(), _clips(kind)
    kw = dict(stationary=stationary, chunk_size=8000, padding=1500)
    ref = jnr.reduce_noise_batch(ys, 16000, y_noise=noise, **kw)

    calls = []
    real = api._reduce_noise_deferred
    monkeypatch.setattr(api, "_reduce_noise_deferred",
                        lambda **k: calls.append(k) or real(**k))
    got = nrt.reduce_noise_batch(ys, 16000, y_noise=noise, device="cpu",
                                 compute_dtype=torch.float64, **kw)
    assert len(calls) == n_calls  # one per (length, dtype[, clip]) group
    monkeypatch.undo()

    for i, (y, g, r) in enumerate(zip(ys, got, ref)):
        assert g.shape == r.shape == y.shape and g.dtype == r.dtype == y.dtype
        dev, scale = _dev(g, r)
        assert dev <= (1 if y.dtype == np.int16 else F64_TOL * scale)
        clip = noise[i] if isinstance(noise, list) else noise
        want = nrt.reduce_noise(y, 16000, y_noise=clip, device="cpu",
                                compute_dtype=torch.float64, **kw)
        if bitwise:
            # per-row thresholds, and the per-signal fallback: each row's
            # math is the single-row call's
            np.testing.assert_array_equal(g, want)
        else:
            # the same threshold or none: the per-row math is the same,
            # but the JAX package promises these cases only to a tolerance
            # (tests/test_batch_api.py:20-42), and so does the port
            dev, scale = _dev(g, want)
            assert dev <= (1 if y.dtype == np.int16 else 1e-6 * scale)


def test_reduce_noise_batch_use_torch_raises():
    # the torch engine is ported; its host-driven tqdm loop is not
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nrt.reduce_noise_batch([np.zeros(4000)], 16000, use_torch=True, use_tqdm=True,
                               device="cpu")


def test_reduce_noise_batch_validation():
    with pytest.raises(ValueError, match="mono"):
        nrt.reduce_noise_batch([np.zeros((2, 100), np.float32)], 16000, device="cpu")
    with pytest.raises(ValueError, match="noise clips"):
        nrt.reduce_noise_batch([np.zeros(4000)] * 2, 16000, y_noise=[np.zeros(100)],
                               stationary=True, device="cpu")
    assert nrt.reduce_noise_batch([], 16000, device="cpu") == []


# ---------------------------------------------------------------------------
# (g) row 7: the staged non-stationary geometry, kernel B with one unit tap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sr,kw", [(16000, dict(n_fft=1024, hop_length=300)),
                                   (48000, {})], ids=["hop300-16k", "48k"])
def test_unit_tap_mask_matches_jax_tm_kernel_interpret(sr, kw):
    cfg = GateConfig(sr=sr, **kw)
    rng = np.random.default_rng(13)
    shape = (2, 140, cfg.stft.n_bins)
    drift = 1.0 + 0.8 * np.sin(np.linspace(0, 6, shape[1]))[:, None]
    re, im = (rng.standard_normal(shape) * drift).astype(np.float32), (
        rng.standard_normal(shape) * drift).astype(np.float32)
    got = K.nonstationary_mask_ref(_t(re), _t(im), cfg.iir_b,
                                   cfg.thresh_n_mult_nonstationary,
                                   cfg.sigmoid_slope_nonstationary, (1.0,))
    ref = _j_mask_tm(jnp.asarray(re), jnp.asarray(im), cfg.iir_b,
                     cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary, True)
    assert np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max() <= 1e-5


def test_gate_nonstationary_hop300_f64_matches_jax_staged():
    kw = dict(n_fft=1024, hop_length=300)
    x = np.random.default_rng(14).standard_normal((2, 12000))
    got = gate_nonstationary(_t(x), GateConfig(sr=16000, **kw))
    ref = _j_staged_nonstat(jnp.asarray(x), JGateConfig(sr=16000, **kw), "fft", False)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= F64_TOL * scale


# ---------------------------------------------------------------------------
# (h) row 2: a geometry the JAX package routes to its split path
# ---------------------------------------------------------------------------
SPLIT_SR, SPLIT_KW = 16000, dict(freq_mask_smooth_hz=2000)


@pytest.mark.parametrize("stationary", [False, True], ids=["nonstationary", "stationary"])
def test_split_geometry_matches_jax_split_path(stationary):
    n = 12000
    jcfg = JGateConfig(sr=SPLIT_SR, stationary=stationary, **SPLIT_KW)
    geo = _geometry(jcfg.stft, n)
    ngf = jcfg.smoothing[0]
    # the frequency-smoothing halo (ngf + 2 = 66 bins) leaves the merged
    # kernel fewer than 16 owned bins per 128-lane tile
    assert not _merged_supported(geo[5], geo[1], _merged_halo(ngf), jcfg.stft.n_bins)
    x = np.random.default_rng(15).standard_normal((2, n)).astype(np.float32)
    cfg = GateConfig(sr=SPLIT_SR, stationary=stationary, **SPLIT_KW)
    if stationary:
        thr = _thr_f32(SPLIT_SR, SPLIT_KW)
        got = fused_gate_stationary(_t(x), _t(thr), cfg)
        ref = _j_fused_interpret(jnp.asarray(x), jcfg, True, noise_thresh=jnp.asarray(thr))
    else:
        got = fused_gate_nonstationary(_t(x), cfg)
        ref = _j_fused_interpret(jnp.asarray(x), jcfg, True)
    dev, scale = _dev(got.numpy(), ref)
    assert dev <= F32_TOL * scale, f"rel dev {dev / scale:.3e}"
