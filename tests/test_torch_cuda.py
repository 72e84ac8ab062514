"""PyTorch port on a CUDA card: each kernel against its plain version, and
``reduce_noise`` / ``reduce_noise_batch`` on the card against the CPU parity
mode and the per-signal calls.

Every test here but the last is marked ``gpu`` and skips without a card
(the last hides the card to check that the streaming entry points refuse
to run without one). This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; there, skip the repository's conftest (it configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

A ``ChunkMesh`` of ``chunk_mesh()`` and of ``(cuda:0,) * 4`` gives each
engine's ``mesh=None`` output bitwise, with each kernel of the path
launched once a shard (per-device counts); the default cotangent mode
(``bf16``) casts the gate-level cotangents of card tensors, within 5e-2 x
scale (1.5e-1 for a stationary gate) of the uncast ones, which
``highest`` restores bitwise.

Float32 bounds, as chip_smoke.py states them: spectra and istft_ola 2e-5 x
max|ref| (long FP32 sums in another order than cuFFT), the mask 1e-4
absolute (sigmoid slope 10 over an IIR floor), the frequency smoothing
1e-6 absolute, end to end 5e-5 x max|ref|; the stationary mask 1e-5
absolute, with at most 1e-5 of its cells deciding the binary threshold the
other way (a dB value within float32 resolution of the threshold). The
torch-convention kernels (A's torch table, F, E's self statistics, D's
torch tail) are held to the same bounds, F like B at 1e-5 absolute; G
(frequency-major, TPU row 6) like B at 1e-4. Gradients on the card (the
kernels' value, the staged twin's cotangent) are held to the float64
twin's at 5e-5 x scale. Kernels A and D are held on each of their routes
(the FFT route of n_fft 512, 1024, 2048, 1536, 400 and 882 in the
real-FFT kernels and of 1100, 1040, 441, 1323 and 5005 in the
complex-frame kernels, and of 1102, 493, 1235, 1426, 1218, 1088 and 2040
with the large radices 17 to 31; the chirp-z route of 1101, 2036, 2035
and 4106; the frames below 64 samples, 1 to 63 (2, 4, 16 and 40 in the
real-FFT kernels, tiles of 204 to 4,096 frames and runs that grow with
them, D's output allocated over NaN; odd 1, 3 and 63, 34 and 62 with
radix 17 and 31; the chirp-z route of 37 and 61), in float32 and bf16;
the big blocks' persistent walk at
8580, 10010, 5005 and 4106; 16384, 16380, 12000 and 4851 on the cluster
route), and every path is checked to launch them on its
geometry's route only. A float64 card tensor runs the staged twins, within
1e-9 x max|ref| of the same call on the CPU, and launches no kernel. A
float64 caller's array comes back float64, bitwise the float32 caller's
output widened, as the call's own pinned output (every engine, grouped,
the batch, a mesh, the staged twins' geometry). Kernel H
(``output_cast``) is bitwise numpy's ``astype`` on the machine that runs
it and its plain version, for int8, uint8, int16, uint16, int32 and
float16, over an edge grid in rows of odd widths, at row offsets and
strides, and from bfloat16 cores; an integer or float16 caller's array
comes back in its dtype, bitwise numpy's cast of the one-copy path's
float32 output, as the call's own pinned output, narrowed by H once a
piece (every engine, grouped, bf16 compute, the batch, a mesh, the staged
twins' geometry), and is read only after its copies end.
``reduce_noise_file`` (its pinned two-deep pipeline too) and
``StreamingGate`` are held to ``reduce_noise`` on the card end to end.
The bf16 mode's kernels (the bfloat16 builds of A, B, D, E and F) are held
to their plain versions on the same bf16 inputs (A's planes and D's output
within one bf16 ulp plus the float32 bound, the masks at the float32
bounds), on every route of A and D, and B, E and F also on planes cut
at an odd element offset (either half of each element's aligned 4-byte
word, NaN outside the plane); the entry points
launch only the bfloat16 builds and stay within the envelopes of
tests/test_bfloat16_mode.py against the float32 kernels.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig, StftConfig
from noisereduce_tpu_torch.models.spectral_gate import (
    _gate_nonstationary_staged,
    gate_nonstationary,
    stationary_noise_threshold,
)
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import fft_route, gate_geometry
from noisereduce_tpu_torch.ops.dsp import tri_norm

torch.set_num_threads(2)

GEOMS = [dict(n_fft=1024, hop_length=256), dict(n_fft=512, hop_length=128),
         dict(n_fft=2048, win_length=1024, hop_length=256)]
GEOM_IDS = ["nfft1024", "nfft512", "nfft2048-win1024"]
# the kernels of the non-stationary gate
NONSTATIONARY = ("spectra", "nonstationary_mask", "freq_smooth_blend", "istft_ola")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _max(t):
    return float(t.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kw", GEOMS, ids=GEOM_IDS)
def test_kernels_match_plain_versions(cuda, kw):
    cfg = GateConfig(sr=16000, **kw)
    ngf, ngt = cfg.smoothing
    cs, pad, n = 8000, 1500, 30000
    geo = gate_geometry(cfg.stft, cs + 2 * pad)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((2, n)),
                        dtype=torch.float32, device=cuda)
    K.reset_launch_counts()

    re, im = K.spectra(x, geo, cs, pad)
    rre, rim = K.spectra_ref(x, geo, cs, pad)
    assert _max(re - rre) <= 2e-5 * _max(rre)
    assert _max(im - rim) <= 2e-5 * _max(rre)

    args = (re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
            cfg.sigmoid_slope_nonstationary, tri_norm(ngt))
    m = K.nonstationary_mask(*args)
    assert _max(m - K.nonstationary_mask_ref(*args)) <= 1e-4

    mb = K.freq_smooth_blend(m, tri_norm(ngf), 0.8)
    assert _max(mb - K.freq_smooth_blend_ref(m, tri_norm(ngf), 0.8)) <= 1e-6

    y = K.istft_ola(re, im, mb, geo, pad, cs)
    ry = K.istft_ola_ref(re, im, mb, geo, pad, cs)
    assert _max(y - ry) <= 2e-5 * _max(ry)
    assert {k: v for k, v in K.launch_counts().items() if k in NONSTATIONARY} == dict.fromkeys(
        NONSTATIONARY, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(chunk_size=8000, padding=1500)],
                         ids=["unchunked", "chunked"])
def test_reduce_noise_on_card_matches_cpu_parity_mode(cuda, kw):
    y = np.random.default_rng(7).standard_normal((2, 30000))
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 16000, **kw)
    assert min(K.launch_counts()[k] for k in NONSTATIONARY) >= 1
    ref = nrt.reduce_noise(y, 16000, device="cpu", compute_dtype=torch.float64, **kw)
    assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
def test_kernels_reject_float64(cuda):
    """The kernel wrappers raise on float64; every entry point sends a
    float64 card tensor to its staged twin instead, which launches no
    kernel and matches the same call on the CPU (the kernels' plain
    versions in float64) at 1e-9 x max|ref|."""
    from noisereduce_tpu_torch.models.spectral_gate import gate_stationary

    x = torch.zeros((1, 8000), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.spectra(x, gate_geometry(StftConfig(), 8000))
    rng = np.random.default_rng(13)
    y = rng.standard_normal((2, 30000))
    cfg, scfg = GateConfig(sr=16000), GateConfig(sr=16000, stationary=True)
    gate = nrt.TPUGate(sr=16000, nonstationary=True)

    def calls(dev):
        t = torch.as_tensor(y, dtype=torch.float64, device=dev)
        thr = stationary_noise_threshold(0.5 * t[0, :9000], scfg)
        return [
            nrt.reduce_noise(y, 16000, device=dev, compute_dtype=torch.float64),
            nrt.reduce_noise(y, 16000, stationary=True, device=dev,
                             compute_dtype=torch.float64, chunk_size=8000, padding=1500),
            nrt.reduce_noise(y, 16000, use_torch=True, device=dev,
                             compute_dtype=torch.float64, chunk_size=8000, padding=1500),
            gate_nonstationary(t, cfg), gate_stationary(t, thr, scfg), gate(t),
        ]

    K.reset_launch_counts()
    got = calls(cuda)
    assert sum(K.launch_counts().values()) == 0
    for g, r in zip(got, calls("cpu")):
        g = g.cpu().numpy() if torch.is_tensor(g) else g
        r = r.numpy() if torch.is_tensor(r) else r
        assert g.dtype == np.float64 and g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-9 * np.abs(r).max()


@pytest.mark.gpu
def test_silence_gives_zeros(cuda):
    out = nrt.reduce_noise(np.zeros(30000, np.float32), 16000)
    assert np.all(out == 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("views_per_row", [1, 2])
def test_stationary_mask_matches_plain_version(cuda, views_per_row):
    cfg = GateConfig(sr=16000, stationary=True, prop_decrease=0.8)
    ngt = cfg.smoothing[1]
    geo = gate_geometry(cfg.stft, 11000)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((4, 11000)),
                        dtype=torch.float32, device=cuda)
    re, im = K.spectra(x, geo)
    rows = 4 // views_per_row
    thr = stationary_noise_threshold(0.5 * x[:rows, :6000], cfg)
    if views_per_row == 1:
        thr = thr[0]  # one shared threshold
    K.reset_launch_counts()
    args = (re, im, thr.contiguous(), views_per_row, cfg.prop_decrease, tri_norm(ngt))
    diff = (K.stationary_mask(*args) - K.stationary_mask_ref(*args)).abs()
    assert K.launch_counts()["stationary_mask"] == 1
    off = diff > 1e-5
    assert int(off.sum()) <= 1e-5 * diff.numel()
    assert _max(diff[~off]) <= 1e-5


@pytest.mark.gpu
def test_spectra_of_a_short_noise_row(cuda):
    """A noise clip shorter than one window (kernel A, TPU row 3)."""
    geo = gate_geometry(StftConfig(), 100)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((1, 100)),
                        dtype=torch.float32, device=cuda)
    re, im = K.spectra(x, geo)
    rre, rim = K.spectra_ref(x, geo)
    assert re.shape == (1, 1, 513)
    assert _max(re - rre) <= 2e-5 * _max(rre)
    assert _max(im - rim) <= 2e-5 * _max(rre)


@pytest.mark.gpu
def test_unit_tap_mask_and_staged_geometry(cuda):
    """Kernel B with one unit tap (TPU row 7), alone and on the staged path
    of a hop that does not divide the window."""
    cfg = GateConfig(sr=16000, n_fft=1024, hop_length=300)
    x = torch.as_tensor(np.random.default_rng(10).standard_normal((2, 30000)),
                        dtype=torch.float32, device=cuda)
    re, im = (t.contiguous() for t in K.spectra_ref(x, gate_geometry(StftConfig(), 30000)))
    args = (re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
            cfg.sigmoid_slope_nonstationary, (1.0,))
    assert _max(K.nonstationary_mask(*args) - K.nonstationary_mask_ref(*args)) <= 1e-4
    K.reset_launch_counts()
    got = gate_nonstationary(x, cfg)
    assert K.launch_counts()["nonstationary_mask"] == 1
    ref = _gate_nonstationary_staged(x, cfg)
    assert _max(got - ref) <= 5e-5 * _max(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(chunk_size=8000, padding=1500)],
                         ids=["unchunked", "chunked"])
def test_stationary_reduce_noise_on_card(cuda, kw):
    rng = np.random.default_rng(11)
    y = rng.standard_normal((2, 30000))
    noise = 0.5 * rng.standard_normal(9000)
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 16000, stationary=True, y_noise=noise, **kw)
    counts = K.launch_counts()
    assert counts["spectra"] == 2 and counts["nonstationary_mask"] == 0
    assert min(counts[k] for k in ("stationary_mask", "freq_smooth_blend", "istft_ola")) == 1
    ref = nrt.reduce_noise(y, 16000, stationary=True, y_noise=noise, device="cpu",
                           compute_dtype=torch.float64, **kw)
    n_flips, worst = _decision_flips(y, noise, GateConfig(sr=16000, stationary=True), kw)
    # a cell whose dB value lies within float32 resolution of the threshold
    # may decide the other way, and moves the output by ~1e-3 of its peak
    assert worst <= 2e-3
    if n_flips == 0:
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


def _decision_flips(y, noise, cfg, kw):
    """Cells whose binary decision on the card (kernels A and E) differs
    from a float64 staged run on the CPU, and the largest |dB - thr| among
    them."""
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, noise_db_threshold
    from noisereduce_tpu_torch.ops.stft import stft
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    cs, pad = kw.get("chunk_size", 600000), kw.get("padding", 30000)

    def views(dt, dev):
        t = torch.as_tensor(y, dtype=dt, device=dev)
        if t.shape[-1] <= cs:
            return torch.nn.functional.pad(t, (pad, pad))
        v = extract_chunks(t, cs, pad)
        return v.reshape(-1, v.shape[-1]).contiguous()

    v = views(torch.float32, "cuda")
    re, im = K.spectra(v, gate_geometry(cfg.stft, v.shape[-1]))
    thr = stationary_noise_threshold(torch.as_tensor(noise, dtype=torch.float32, device="cuda"),
                                     cfg)
    dec = K.stationary_mask(re, im, thr, 1, 1.0, (1.0,)).cpu() > 0
    re, im = stft(views(torch.float64, "cpu"), cfg.stft)
    n = torch.as_tensor(noise, dtype=torch.float64)
    margin = amp_to_db(torch.sqrt(re * re + im * im), 80.0, axis=-2) - noise_db_threshold(
        *stft(n, cfg.stft), cfg.n_std_thresh_stationary)
    flips = dec != (margin > 0)
    return int(flips.sum()), float(margin.abs()[flips].max()) if flips.any() else 0.0


@pytest.mark.gpu
def test_reduce_noise_batch_on_card_is_the_per_signal_calls(cuda):
    rng = np.random.default_rng(12)
    ys = [rng.standard_normal(20000).astype(np.float32) for _ in range(3)]
    ys.append(rng.standard_normal(12000).astype(np.float32))
    got = nrt.reduce_noise_batch(ys, 16000, stationary=True)
    for y, g in zip(ys, got):
        np.testing.assert_array_equal(g, nrt.reduce_noise(y, 16000, stationary=True))


# ---------------------------------------------------------------------------
# the torch convention (TPUGate / reduce_noise(use_torch=True))
# ---------------------------------------------------------------------------
TORCH_NONSTATIONARY = ("spectra", "torch_nonstationary_mask", "freq_smooth_blend", "istft_ola")


@pytest.mark.gpu
@pytest.mark.parametrize("kw,n_movemean", [
    (dict(n_fft=1024, hop_length=256), 20), (dict(n_fft=512, hop_length=128), 125),
    (dict(n_fft=1024, win_length=512, hop_length=256), 344),
], ids=["nfft1024-move20", "nfft512-move125", "win512-move344"])
def test_torch_kernels_match_plain_versions(cuda, kw, n_movemean):
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps

    gate = nrt.TPUGate(sr=16000, nonstationary=True, n_movemean_nonstationary=n_movemean,
                       prop_decrease=0.8, **kw)
    ft, tt = _rank1_taps(gate.smoothing)
    cs, pad, n = 8000, 1500, 30000
    geo = gate_geometry(gate.stft_config, cs + 2 * pad)
    x = torch.as_tensor(np.random.default_rng(16).standard_normal((2, n)),
                        dtype=torch.float32, device=cuda)
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, cs, pad)
    rre, rim = K.spectra_ref(x, geo, cs, pad)
    assert _max(re - rre) <= 2e-5 * _max(rre)
    assert _max(im - rim) <= 2e-5 * _max(rre)

    args = (re, im, n_movemean, gate.n_thresh_nonstationary,
            gate.temp_coeff_nonstationary, gate.prop_decrease, tt)
    m = K.torch_nonstationary_mask(*args)
    assert _max(m - K.torch_nonstationary_mask_ref(*args)) <= 1e-5

    mb = K.freq_smooth_blend(m, ft, 1.0)
    assert _max(mb - K.freq_smooth_blend_ref(m, ft, 1.0)) <= 1e-6
    y = K.istft_ola(re, im, mb, geo, pad, cs)
    ry = K.istft_ola_ref(re, im, mb, geo, pad, cs)
    assert _max(y - ry) <= 2e-5 * _max(ry)
    assert {k: v for k, v in K.launch_counts().items() if k in TORCH_NONSTATIONARY} == dict.fromkeys(
        TORCH_NONSTATIONARY, 1)

    # E with each view's own statistics (TorchGate with no noise clip)
    e = (re, im, None, 1, 0.8, tt)
    diff = (K.stationary_mask(*e, top_db=40.0, n_std=1.5)
            - K.stationary_mask_ref(*e, top_db=40.0, n_std=1.5)).abs()
    off = diff > 1e-5
    assert int(off.sum()) <= 1e-5 * diff.numel()
    assert _max(diff[~off]) <= 1e-5


@pytest.mark.gpu
def test_torch_wrappers_raise_instead_of_falling_back(cuda):
    re = torch.zeros((1, 40, 513), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.torch_nonstationary_mask(re.double(), re.double(), 20, 1.3, 0.1, 1.0, (1.0,))
    with pytest.raises(ValueError, match="one CUDA device"):
        K.torch_nonstationary_mask(re, re.cpu(), 20, 1.3, 0.1, 1.0, (1.0,))
    with pytest.raises(ValueError, match="one CUDA device"):
        K.stationary_mask(re, re, torch.zeros(513), 1, 1.0, (1.0,), top_db=40.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(chunk_size=8000, padding=1500)],
                         ids=["unchunked", "chunked"])
def test_torch_reduce_noise_on_card_matches_cpu_parity_mode(cuda, kw):
    y = np.random.default_rng(17).standard_normal((2, 30000))
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 16000, use_torch=True, **kw)
    counts = K.launch_counts()
    assert {k: counts[k] for k in TORCH_NONSTATIONARY} == dict.fromkeys(TORCH_NONSTATIONARY, 1)
    assert counts["nonstationary_mask"] == counts["stationary_mask"] == 0
    ref = nrt.reduce_noise(y, 16000, use_torch=True, device="cpu",
                           compute_dtype=torch.float64, **kw)
    assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
def test_torch_stationary_launches_on_card(cuda):
    rng = np.random.default_rng(18)
    y = rng.standard_normal((2, 30000))
    noise = 0.5 * rng.standard_normal(9000)
    for y_noise, want in ((noise, dict(spectra=2, stationary_mask=1)),
                          (None, dict(spectra=1, stationary_mask=1))):
        K.reset_launch_counts()
        out = nrt.reduce_noise(y, 16000, stationary=True, use_torch=True, y_noise=y_noise,
                               chunk_size=8000, padding=1500)
        want.update(freq_smooth_blend=1, istft_ola=1)
        assert K.launch_counts() == {k: want.get(k, 0) for k in K.launch_counts()}
        assert out.shape == y.shape and np.isfinite(out).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kw,want", [
    ({}, dict(torch_nonstationary_mask=1)),
    (dict(stationary=True, y_noise="clip"), dict(stationary_mask=1)),
], ids=["nonstationary", "stationary-clip"])
def test_torch_staged_geometry_on_card_runs_the_mask_kernels(cuda, kw, want):
    """hop 300 with n_fft 1024: A and D do not serve it; the plain STFT runs
    around F or E and C, which match the CPU parity mode."""
    rng = np.random.default_rng(20)
    y = rng.standard_normal((2, 30000))
    if "y_noise" in kw:
        kw = dict(kw, y_noise=0.5 * rng.standard_normal(9000))
    kw.update(use_torch=True, hop_length=300, chunk_size=8000, padding=1500)
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 16000, **kw)
    want = dict(want, freq_smooth_blend=1)
    assert K.launch_counts() == {k: want.get(k, 0) for k in K.launch_counts()}
    ref = nrt.reduce_noise(y, 16000, device="cpu", compute_dtype=torch.float64, **kw)
    assert got.shape == y.shape and np.isfinite(got).all()
    if not kw.get("stationary"):  # a stationary decision at the border may flip
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
def test_torch_reduce_noise_batch_on_card_is_the_per_signal_calls(cuda):
    rng = np.random.default_rng(19)
    ys = [rng.standard_normal(20000).astype(np.float32) for _ in range(3)]
    clips = [0.5 * rng.standard_normal(9000).astype(np.float32) for _ in range(3)]
    for kw in (dict(stationary=True), dict(stationary=True, y_noise=clips), {}):
        got = nrt.reduce_noise_batch(ys, 16000, use_torch=True, **kw)
        for i, (y, g) in enumerate(zip(ys, got)):
            one = dict(kw, y_noise=clips[i]) if "y_noise" in kw else kw
            np.testing.assert_array_equal(g, nrt.reduce_noise(y, 16000, use_torch=True, **one))


# ---------------------------------------------------------------------------
# kernel G and the gradient (the fused forward, the staged twin backward)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("magnitude", [False, True], ids=["complex64", "magnitude"])
def test_fm_mask_matches_plain_version(cuda, magnitude):
    """Kernel G (TPU row 6) on a frequency-major plane, against its plain
    version at kernel B's bound."""
    cfg = GateConfig(sr=16000)
    rng = np.random.default_rng(21)
    z = torch.as_tensor(rng.standard_normal((2, 513, 700)) + 1j * rng.standard_normal((2, 513, 700)),
                        dtype=torch.complex64, device=cuda)
    if magnitude:
        z = z.abs()
    args = (z, cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    K.reset_launch_counts()
    got = K.fm_nonstationary_mask(*args)
    assert K.launch_counts()["fm_nonstationary_mask"] == 1
    assert got.dtype == torch.float32 and got.shape == z.shape
    assert _max(got - K.fm_nonstationary_mask_ref(*args)) <= 1e-4


# (rows, bins, frames), the route forced (None: the plan's), the route
# taken: the row-6 cell's 2,579 frames (one column a block), the tiled
# route forced at that T (one tile) and at 9,000 frames (three tiles of
# 3,840), column counts no multiple of a block's columns (22 at 8 a block,
# 21 at 4, 9 at 2), regions of 29 and 79 frames (7,000 and 20,000 frames),
# T 1, and the tiled route reached at 40,000 frames
FM_CASES = {
    "resident-T2579": ((3, 7, 2579), None, "resident"),
    "tiled-forced-T2579": ((2, 129, 2579), "tiled", "tiled"),
    "tiled-forced-T9000": ((1, 7, 9000), "tiled", "tiled"),
    "resident-T33-22-columns": ((2, 11, 33), None, "resident"),
    "resident-T700-21-columns": ((3, 7, 700), None, "resident"),
    "resident-T1500-9-columns": ((1, 9, 1500), None, "resident"),
    "resident-T7000": ((1, 9, 7000), None, "resident"),
    "resident-T20000": ((1, 5, 20000), None, "resident"),
    "resident-T1": ((2, 5, 1), None, "resident"),
    "tiled-T40000": ((1, 5, 40000), None, "tiled"),
}


def _fm_plane(shape, seed, cuda, magnitude):
    """A frequency-major complex64 plane with a level drift along time, a
    silent bin (an all-zero column) and a silent run of frames; or its
    magnitudes."""
    rng = np.random.default_rng(seed)
    level = np.exp(np.linspace(-2, 2, shape[-1]))
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * level
    z[:, 1] = 0.0
    z[0, :, shape[-1] // 3 : shape[-1] // 2] = 0.0
    z = torch.as_tensor(z, dtype=torch.complex64, device=cuda)
    return z.abs() if magnitude else z


@pytest.mark.gpu
@pytest.mark.parametrize("magnitude", [False, True], ids=["complex64", "magnitude"])
@pytest.mark.parametrize("case", list(FM_CASES))
def test_fm_mask_routes_match_plain_version(cuda, case, magnitude):
    """Kernel G on each route within 1e-4 of its plain version (b at 48 kHz
    / hop 256 and 16 kHz / hop 128), finite on the silent column; one
    wrapper launch, counted by route, 1 or 3 CUDA launches; the same bits
    on a second call (no atomics)."""
    shape, route, took = FM_CASES[case]
    z = _fm_plane(shape, sum(shape), cuda, magnitude)
    for b in (GateConfig(sr=48000).iir_b, GateConfig(sr=16000, hop_length=128).iir_b):
        args = (z, b, 2.0, 10.0)

        def call():
            return K._fm_mask_on(route, *args)

        K.reset_launch_counts()
        got = call()
        assert K.launch_counts()["fm_nonstationary_mask"] == 1
        assert getattr(K.fm_nonstationary_mask, f"{took}_launches") == 1
        assert K.fm_nonstationary_mask.cuda_launches == (3 if took == "tiled" else 1)
        assert got.dtype == torch.float32 and got.shape == z.shape
        assert torch.isfinite(got).all()
        assert _max(got - K.fm_nonstationary_mask_ref(*args)) <= 1e-4
        assert torch.equal(got, call())


@pytest.mark.gpu
@pytest.mark.parametrize("magnitude", [False, True], ids=["complex64", "magnitude"])
@pytest.mark.parametrize("route", ["resident", "tiled"])
def test_fm_mask_takes_a_plane_off_16_byte_alignment(cuda, route, magnitude):
    """A contiguous view one frame into its storage (8 or 4 bytes off a
    16-byte boundary): G's 16-byte loads start from the view's own address,
    and its mask is the plain version's."""
    z = _fm_plane((2, 9, 1001), 63, cuda, magnitude)
    zo = torch.cat([z.reshape(-1)[:1], z.reshape(-1)]).reshape(-1)[1:].view(z.shape)
    assert zo.is_contiguous() and zo.data_ptr() % 16 and torch.equal(zo, z)
    mk = (GateConfig(sr=48000).iir_b, 2.0, 10.0)
    got = K._fm_mask_on(route, zo, *mk)
    assert _max(got - K.fm_nonstationary_mask_ref(z, *mk)) <= 1e-4
    assert torch.equal(got, K._fm_mask_on(route, z, *mk))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["resident", "tiled"])
def test_fm_mask_allocates_no_scratch_plane(cuda, route):
    """Beyond ``out``, kernel G's peak allocation stays below one plane:
    nothing on the resident route, the (2, tiles, columns) float64
    carries on the tiled one."""
    z = _fm_plane((8, 513, 2579), 62, cuda, False)
    plane = z.numel() * 4
    mk = (GateConfig(sr=48000).iir_b, 2.0, 10.0)
    K._fm_mask_on(route, z, *mk)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = K._fm_mask_on(route, z, *mk)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base - plane < plane
    del out


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["tpugate", "nonstationary", "stationary"])
def test_gradient_on_card_is_the_float64_twins(cuda, family, monkeypatch):
    """Under grad the value is the serving value bitwise, with the serving
    launches; the backward pass launches nothing; the gradient, uncast
    (``NRTPU_COTANGENT_PRECISION=highest``), matches the float64 staged
    twin's on the card (5e-5 x scale). A stationary gate is compared where
    no binary decision differs between float32 and float64."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _gate_stationary_staged,
        gate_stationary,
    )
    from noisereduce_tpu_torch.ops.dsp import amp_to_db
    from noisereduce_tpu_torch.ops.stft import stft

    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "highest")
    rng = np.random.default_rng(22)
    x = torch.as_tensor(rng.standard_normal((2, 32000)), dtype=torch.float32, device=cuda)
    if family == "tpugate":
        fn = nrt.TPUGate(sr=16000, nonstationary=True)
        twin, mask = fn._call_staged, "torch_nonstationary_mask"
    elif family == "nonstationary":
        cfg = GateConfig(sr=16000)
        fn = lambda a: gate_nonstationary(a, cfg)  # noqa: E731
        twin = lambda a: _gate_nonstationary_staged(a, cfg)  # noqa: E731
        mask = "nonstationary_mask"
    else:
        cfg = GateConfig(sr=16000, stationary=True)
        thr = stationary_noise_threshold(torch.as_tensor(0.8 * rng.standard_normal(16000),
                                                         dtype=torch.float32, device=cuda), cfg)
        fn = lambda a: gate_stationary(a, thr, cfg)  # noqa: E731
        twin = lambda a: _gate_stationary_staged(a, thr.double(), cfg)  # noqa: E731
        mask = "stationary_mask"
    with torch.no_grad():
        serving = fn(x)
    want = dict.fromkeys(("spectra", mask, "freq_smooth_blend", "istft_ola"), 1)
    K.reset_launch_counts()
    xg = x.clone().requires_grad_()
    out = fn(xg)
    counts = K.launch_counts()
    assert counts == {k: want.get(k, 0) for k in counts}
    assert torch.equal(out, serving)
    cot = torch.as_tensor(rng.standard_normal(out.shape), dtype=torch.float32, device=cuda)
    (g,) = torch.autograd.grad(out, xg, cot)
    assert K.launch_counts() == counts
    assert bool(torch.isfinite(g).all())
    x64 = x.double().requires_grad_()
    (ref,) = torch.autograd.grad(twin(x64), x64, cot.double())
    if family == "stationary":
        def decisions(a, t):
            re, im = stft(a, cfg.stft)
            return amp_to_db(torch.sqrt(re * re + im * im), 80.0, axis=-2) > t

        if not torch.equal(decisions(x, thr), decisions(x.double(), thr.double())):
            pytest.skip("a binary decision differs between float32 and float64")
    assert _max(g.double() - ref) <= 5e-5 * _max(ref)


@pytest.mark.gpu
def test_masks_under_grad_on_card(cuda):
    """Rows 6 and 7 under grad: the kernels' value, bitwise, and the twin's
    gradient."""
    from noisereduce_tpu_torch.ops.cuda_mask import (
        _mask_impl,
        fused_nonstationary_mask,
        fused_nonstationary_mask_tm,
    )

    cfg = GateConfig(sr=16000)
    mk = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    rng = np.random.default_rng(23)
    z = torch.as_tensor(rng.standard_normal((2, 65, 300)) + 1j * rng.standard_normal((2, 65, 300)),
                        dtype=torch.complex64, device=cuda)
    zg = z.clone().requires_grad_()
    K.reset_launch_counts()
    out = fused_nonstationary_mask(zg, *mk)
    assert torch.equal(out, K.fm_nonstationary_mask(z, *mk))
    (g,) = torch.autograd.grad(out.sum(), zg)
    z64 = z.to(torch.complex128).requires_grad_()
    (ref,) = torch.autograd.grad(_mask_impl(z64, *mk).sum(), z64)
    assert _max(torch.view_as_real(g).double() - torch.view_as_real(ref)) <= 5e-5 * _max(
        torch.view_as_real(ref))
    re = z.real.contiguous().transpose(1, 2).contiguous().requires_grad_()
    im = z.imag.contiguous().transpose(1, 2).contiguous()
    out = fused_nonstationary_mask_tm(re, im, *mk)
    (g,) = torch.autograd.grad(out.sum(), re)
    assert bool(torch.isfinite(g).all())
    assert K.launch_counts()["fm_nonstationary_mask"] == 2
    assert K.launch_counts()["nonstationary_mask"] == 1


# ---------------------------------------------------------------------------
# kernels A and D: the FFT and chirp-z routes
# ---------------------------------------------------------------------------
ROUTE_GEOMS = [dict(n_fft=512, hop_length=128), dict(n_fft=1024, hop_length=256),
               dict(n_fft=2048, win_length=1024, hop_length=256),
               dict(n_fft=1536, hop_length=384), dict(n_fft=400, hop_length=100),
               dict(n_fft=882, hop_length=441), dict(n_fft=1100, hop_length=275),
               dict(n_fft=1040, hop_length=260), dict(n_fft=441, hop_length=147),
               dict(n_fft=1323, hop_length=441), dict(n_fft=5005, hop_length=1001),
               dict(n_fft=1102, hop_length=551), dict(n_fft=1101, hop_length=367),
               dict(n_fft=2040, hop_length=510), dict(n_fft=2035, hop_length=407),
               dict(n_fft=4106, hop_length=2053), dict(n_fft=40, hop_length=10),
               dict(n_fft=4801, hop_length=4801), dict(n_fft=4803, hop_length=1601),
               dict(n_fft=8194, hop_length=4097), dict(n_fft=493, hop_length=29),
               dict(n_fft=1235, hop_length=247), dict(n_fft=1426, hop_length=713),
               dict(n_fft=1218, hop_length=406), dict(n_fft=1088, hop_length=272),
               dict(n_fft=2036, hop_length=509), dict(n_fft=512, hop_length=512)]
ROUTE_IDS = ["nfft512", "nfft1024", "nfft2048-win1024", "nfft1536", "nfft400", "nfft882",
             "nfft1100", "nfft1040", "nfft441", "nfft1323", "nfft5005", "nfft1102",
             "nfft1101", "nfft2040", "nfft2035", "nfft4106", "nfft40", "nfft4801", "nfft4803",
             "nfft8194", "nfft493", "nfft1235", "nfft1426", "nfft1218", "nfft1088",
             "nfft2036", "nfft512-r1"]


def _routes(route, n=1):
    counts = {r: (n if r == route else 0) for r in K.ROUTES}
    return {"spectra": counts, "istft_ola": dict(counts)}


@pytest.mark.gpu
@pytest.mark.parametrize("convention", ["scipy", "torch"])
@pytest.mark.parametrize("kw", ROUTE_GEOMS, ids=ROUTE_IDS)
def test_spectra_and_istft_routes_match_plain_versions(cuda, kw, convention):
    """The geometry picks the route (an n_fft whose transform of n_fft/2 or,
    odd, n_fft points has no prime factor above 13 the FFT, and within a
    block none above 31: the large radices' builds 1 (1102 = 2 x 19 x 29,
    odd 493 = 17 x 29, 1426 = 2 x 23 x 31, 1088 = 2^6 17), 15 (2040 = 2^3 3 5
    17), 105 (1218 = 2 3 7 29) and 15015 (odd 1235 = 5 13 19); 1101 = 3 x
    367, 2036 = 2^2 509, 2035 = 5 11 37 and 4106 = 2 x 2053 the chirp-z,
    4801 (prime), 4803 = 3 x 1601 and 8194 = 2 x 17 x 241 the cluster
    chirp, 40 = 2^3 5 the FFT in the real-FFT kernels); each launch is
    counted on its route; every
    route holds its plain versions at 2e-5 x max|ref| (1e-5 under torch
    conventions). The chirp lengths: 2304 (2^a 3^b), 2048 and 4096 (powers
    of two within a block), 8192 (a big block), 9720 (2^3 3^5 5 over 2
    blocks)."""
    extra = {} if convention == "scipy" else dict(convention="torch", quantize_window_f32=True)
    geo = gate_geometry(StftConfig(**kw, **extra), 8000 + 2 * 1500)
    route = fft_route(geo.scfg)
    tol = 2e-5 if convention == "scipy" else 1e-5
    rng = np.random.default_rng(24)
    x = torch.as_tensor(rng.standard_normal((2, 30000)), dtype=torch.float32, device=cuda)
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, 8000, 1500)
    rre, rim = K.spectra_ref(x, geo, 8000, 1500)
    assert _max(re - rre) <= tol * _max(rre) and _max(im - rim) <= tol * _max(rre)
    mask = torch.as_tensor(rng.random(re.shape), dtype=torch.float32, device=cuda)
    for out_off, out_len in ((1500, 8000), (0, 11000), (9000, 3000)):
        y = K.istft_ola(re, im, mask, geo, out_off, out_len)
        ry = K.istft_ola_ref(re, im, mask, geo, out_off, out_len)
        assert _max(y - ry) <= tol * _max(ry)
    assert K.route_counts() == {"spectra": _routes(route)["spectra"],
                                "istft_ola": _routes(route, 3)["istft_ola"]}


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(n_fft=441, hop_length=147), dict(n_fft=1101, hop_length=367)],
                         ids=["nfft441", "nfft1101"])
def test_odd_istft_output_does_not_depend_on_the_run(cuda, kw):
    """An odd n_fft pairs frames 2s and 2s + 1 whatever the run: D's
    output over the whole signal is bitwise that of one call per window
    of a few hop blocks."""
    geo = gate_geometry(StftConfig(**kw), 11000)
    rng = np.random.default_rng(26)
    re, im = (torch.as_tensor(rng.standard_normal((1, geo.n_frames, geo.n_bins)),
                              dtype=torch.float32, device=cuda) for _ in range(2))
    mask = torch.ones_like(re)
    whole = K.istft_ola(re, im, mask, geo, 0, 11000)
    step = 5 * geo.hop
    parts = [K.istft_ola(re, im, mask, geo, o, min(step, 11000 - o)) for o in range(0, 11000, step)]
    assert torch.equal(whole, torch.cat(parts, dim=1))


@pytest.mark.gpu
@pytest.mark.parametrize("kw,route", [
    ({}, "fft"), (dict(stationary=True), "fft"), (dict(use_torch=True), "fft"),
    (dict(n_fft=1536, hop_length=384), "fft"),
    (dict(n_fft=1536, hop_length=384, use_torch=True), "fft"),
    (dict(n_fft=400, hop_length=100), "fft"),
    (dict(n_fft=1100, hop_length=275), "fft"),
    (dict(n_fft=1100, hop_length=275, use_torch=True), "fft"),
    (dict(n_fft=441, hop_length=147), "fft"),
    (dict(n_fft=441, hop_length=147, stationary=True), "fft"),
    (dict(n_fft=1102, hop_length=551), "fft"),
    (dict(n_fft=1102, hop_length=551, use_torch=True), "fft"),
    (dict(n_fft=1102, hop_length=551, stationary=True), "fft"),
    # odd 1235 = 5 x 13 x 19: radix 19 beside 5 and 13 (the 15015 build), paired
    (dict(n_fft=1235, hop_length=247), "fft"),
    (dict(n_fft=1235, hop_length=247, stationary=True), "fft"),
    (dict(n_fft=1235, hop_length=247, use_torch=True), "fft"),
    (dict(n_fft=1101, hop_length=367), "chirp"),
    # n_fft 40 at 16 kHz: bins 400 Hz apart, so a wider frequency smoothing
    (dict(n_fft=40, hop_length=10, freq_mask_smooth_hz=1000), "fft"),
    # n_fft 4803 at 16 kHz: a hop of 100 ms, so a wider time smoothing
    (dict(n_fft=4803, hop_length=1601, time_mask_smooth_ms=200), "cluster_chirp"),
    (dict(n_fft=4803, hop_length=1601, time_mask_smooth_ms=200, stationary=True),
     "cluster_chirp"),
    (dict(n_fft=4803, hop_length=1601, time_mask_smooth_ms=200, use_torch=True),
     "cluster_chirp"),
], ids=["nonstationary", "stationary", "use_torch", "nfft1536", "nfft1536-use_torch",
        "nfft400", "nfft1100", "nfft1100-use_torch", "nfft441", "nfft441-stationary",
        "nfft1102", "nfft1102-use_torch", "nfft1102-stationary", "nfft1235",
        "nfft1235-stationary", "nfft1235-use_torch", "nfft1101", "nfft40", "nfft4803",
        "nfft4803-stationary",
        "nfft4803-use_torch"])
def test_paths_take_the_route_of_their_geometry(cuda, kw, route):
    """A path launches A and D on its geometry's route only (1024, 1536,
    400, 1100 and 441 the FFT route, 1102 and 1235 too with the large
    radices on all three engines, 1101 the chirp-z route, 4803 the cluster
    chirp route, 40 the FFT route); the output matches the CPU parity
    mode within 5e-5 x max|ref| (a stationary one: finite, of its shape)."""
    y = np.random.default_rng(25).standard_normal((2, 30000))
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 16000, chunk_size=8000, padding=1500, **kw)
    counts = K.launch_counts()
    assert counts["spectra"] >= 1 and counts["istft_ola"] == 1
    assert K.route_counts() == {k: _routes(route, counts[k])[k] for k in ("spectra", "istft_ola")}
    ref = nrt.reduce_noise(y, 16000, chunk_size=8000, padding=1500, device="cpu",
                           compute_dtype=torch.float64, **kw)
    assert got.shape == y.shape and np.isfinite(got).all()
    if not kw.get("stationary"):  # a stationary decision at the border may flip
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# kernels B and E: time tiles (segments, carries, halo, smoothing launch)
# ---------------------------------------------------------------------------
# (views, frames, bins): one frame, fewer frames than a segment, one and two
# segments, a ragged last segment, several hundred
TILE_SHAPES = [(3, 1, 33), (2, 5, 65), (2, 64, 40), (2, 65, 40), (3, 150, 513),
               (2, 1000, 129)]
TILE_IDS = ["T1", "T5", "T64", "T65", "T150", "T1000"]
# n_grad_time: none, the headline's, wider than a segment, and halos past
# the shared-memory tile (B past 374 frames, E past 780: the smoothing launch)
TILE_HALVES = (0, 9, 70, 400, 800)


def _tile_planes(shape, seed, cuda):
    rng = np.random.default_rng(seed)
    views, T, nb = shape
    level = np.exp(np.linspace(-2, 2, T))[None, :, None]
    re = rng.standard_normal(shape) * level
    im = rng.standard_normal(shape) * level
    re[:, :, 1] = im[:, :, 1] = 0.0  # a silent bin: finite zeros
    re[0, T // 3 : T // 2] = im[0, T // 3 : T // 2] = 0.0
    return (torch.as_tensor(v, dtype=torch.float32, device=cuda) for v in (re, im))


def _e_within_rule(got, ref):
    diff = (got - ref).abs()
    off = diff > 1e-5
    assert int(off.sum()) <= max(1, 1e-5 * diff.numel())
    assert not (~off).any() or _max(diff[~off]) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("half", TILE_HALVES, ids=[f"h{h}" for h in TILE_HALVES])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=TILE_IDS)
def test_nonstationary_mask_tiles_match_plain_version(cuda, shape, half):
    re, im = _tile_planes(shape, 40 + half, cuda)
    for b in (GateConfig(sr=48000).iir_b, GateConfig(sr=16000, hop_length=128).iir_b):
        args = (re, im, b, 2.0, 10.0, tri_norm(half))
        K.reset_launch_counts()
        got = K.nonstationary_mask(*args)
        assert K.launch_counts()["nonstationary_mask"] == 1
        assert K.nonstationary_mask.cuda_launches == (4 if half > 374 else 3)
        assert torch.isfinite(got).all()
        assert _max(got - K.nonstationary_mask_ref(*args)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("half", TILE_HALVES, ids=[f"h{h}" for h in TILE_HALVES])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=TILE_IDS)
def test_stationary_mask_tiles_match_plain_version(cuda, shape, half):
    re, im = _tile_planes(shape, 50 + half, cuda)
    db = torch.log(torch.sqrt(re * re + im * im) + 1e-16) * K._DB_PER_NEPER
    thr = (db.mean(dim=1) + 1.0).contiguous()
    taps = tri_norm(half)
    wide = half > 780
    for t, vpr, kw, n in ((thr, 1, {}, 3), (None, 1, dict(top_db=40.0, n_std=1.5), 5)):
        args = (re, im, t, vpr, 0.8, taps)
        K.reset_launch_counts()
        got = K.stationary_mask(*args, **kw)
        assert K.launch_counts()["stationary_mask"] == 1
        assert K.stationary_mask.cuda_launches == n + wide
        _e_within_rule(got, K.stationary_mask_ref(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("half", [0, 9, 800], ids=["h0", "h9", "h800"])
def test_mask_tiles_are_deterministic(cuda, half):
    """No float atomics: two calls on the same inputs give the same bits."""
    re, im = _tile_planes((4, 700, 257), 60, cuda)
    taps = tri_norm(half)
    b = (re, im, GateConfig(sr=48000).iir_b, 2.0, 10.0, taps)
    assert torch.equal(K.nonstationary_mask(*b), K.nonstationary_mask(*b))
    thr = torch.full((257,), -20.0, device=cuda)
    for e, kw in (((re, im, thr, 1, 0.8, taps), {}),
                  ((re, im, None, 1, 0.8, taps), dict(top_db=40.0, n_std=1.5))):
        assert torch.equal(K.stationary_mask(*e, **kw), K.stationary_mask(*e, **kw))


@pytest.mark.gpu
def test_mask_tiles_allocate_no_scratch_plane(cuda):
    """Beyond ``out``, the wrappers' peak allocation stays below one plane:
    only the (rows, segments, bins) partials."""
    re, im = _tile_planes((8, 2579, 513), 61, cuda)
    plane = re.numel() * re.element_size()
    taps = tri_norm(9)
    thr = torch.full((513,), -20.0, device=cuda)
    calls = (lambda: K.nonstationary_mask(re, im, GateConfig(sr=48000).iir_b, 2.0, 10.0, taps),
             lambda: K.nonstationary_mask(re, im, GateConfig(sr=48000).iir_b, 2.0, 10.0, (1.0,)),
             lambda: K.stationary_mask(re, im, thr, 1, 0.8, taps),
             lambda: K.stationary_mask(re, im, None, 1, 0.8, taps, top_db=40.0, n_std=1.5))
    for call in calls:
        call()  # the tap tables' first upload
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base - plane < plane
        del out


# ---------------------------------------------------------------------------
# kernel F: time tiles, windows on float64 prefixes
# ---------------------------------------------------------------------------
def _torch_headline_time_taps():
    """The 19 SVD time taps of the torch headline's gate (48 kHz, hop 256)."""
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps

    return _rank1_taps(nrt.api.torch_gate_for(48000).smoothing)[1]


# (views, frames, bins), n_movemean, time taps (None: the torch headline's
# 19), the CUDA launches of one call: the torch headline's window (375 at
# 48 kHz / hop 256) on 4 of its views, an even window, time_constant_s 10
# (1,875), a window past T, halos past the tile (1601 taps: the blend to a
# plane and the smoothing launch), one tap (straight to out, scaled), T 1
# and 5, and a window of one frame
F_CASES = {
    "headline-n375": ((4, 2579, 513), 375, None, 3),
    "even-n374": ((4, 2579, 513), 374, None, 3),
    "n1875": ((4, 2579, 513), 1875, None, 3),
    "n375-past-T300": ((3, 300, 257), 375, None, 3),
    "taps1601": ((3, 1000, 129), 375, tri_norm(800), 4),
    "one-tap": ((4, 2579, 513), 375, (0.75,), 3),
    "T1": ((3, 1, 33), 375, None, 3),
    "T5-n2": ((2, 5, 65), 2, None, 3),
    "T65-n1": ((2, 65, 40), 1, None, 3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(F_CASES))
def test_torch_nonstationary_mask_tiles_match_plain_version(cuda, case):
    """F within 1e-5 of its plain version, with TorchGate's threshold and
    temperature (2, 0.1), on planes with a silent bin and a silent run of
    frames; one wrapper launch, its CUDA launches by route, and the same
    bits on a second call (no atomics)."""
    shape, n, taps, launches = F_CASES[case]
    re, im = _tile_planes(shape, 80 + n, cuda)
    args = (re, im, n, 2.0, 0.1, 1.0 if case == "headline-n375" else 0.8,
            _torch_headline_time_taps() if taps is None else taps)
    K.reset_launch_counts()
    got = K.torch_nonstationary_mask(*args)
    assert K.launch_counts()["torch_nonstationary_mask"] == 1
    assert K.torch_nonstationary_mask.cuda_launches == launches
    assert torch.isfinite(got).all()
    assert _max(got - K.torch_nonstationary_mask_ref(*args)) <= 1e-5
    assert torch.equal(got, K.torch_nonstationary_mask(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 375, 374])
def test_torch_nonstationary_mask_silent_windows_on_card(cuda, n):
    """Where a window holds only silent frames the plain floor is exactly 0
    (ratio 0) and so is F's: levels spanning 10^-6 to 10^3 make the float64
    sums round, and a soft sigmoid (threshold -0.5, temperature 1) would
    show a residue's ratio of -1 as a mask 0.24 lower."""
    rng = np.random.default_rng(90 + n)
    shape = (3, 2579, 129)
    level = 10.0 ** rng.uniform(-6, 3, shape)
    re = rng.standard_normal(shape) * level
    im = rng.standard_normal(shape) * level
    re[:, :, 5] = im[:, :, 5] = 0.0  # a silent column in a loud view
    re[0, 800:1300] = im[0, 800:1300] = 0.0
    re, im = (torch.as_tensor(v, dtype=torch.float32, device=cuda) for v in (re, im))
    args = (re, im, n, -0.5, 1.0, 1.0, _torch_headline_time_taps())
    got = K.torch_nonstationary_mask(*args)
    assert _max(got - K.torch_nonstationary_mask_ref(*args)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [1.2e-38, 1e-30, -0.1, 40.0])
def test_torch_nonstationary_mask_any_normal_temp_on_card(cuda, temp):
    """F's divisions hold for every normal temp: a tiny one overflows the
    sigmoid's argument (infinite in the plain version, the saturated mask
    in F), a negative one flips the gate, and prop 1 lets the sigmoid's
    smallest values reach the mask."""
    re, im = _tile_planes((2, 700, 129), 7, cuda)
    args = (re, im, 375, 2.0, temp, 1.0, _torch_headline_time_taps())
    got = K.torch_nonstationary_mask(*args)
    assert torch.isfinite(got).all()
    assert _max(got - K.torch_nonstationary_mask_ref(*args)) <= 1e-5


# ---------------------------------------------------------------------------
# kernel C: spans of whole lines, register windows
# ---------------------------------------------------------------------------
def _fs_taps(name):
    """Kernel C's taps: the scipy headline's (48 kHz, n_fft 1024: 11), the
    torch headline's sigma0 u0, the split geometry's 129 (2000 Hz at 16
    kHz), and 641 (20000 Hz at 16 kHz, n_fft 512: wider than its 257 bins)."""
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps

    if name == "torch":
        return np.asarray(_rank1_taps(nrt.api.torch_gate_for(48000).smoothing)[0])
    return tri_norm({"scipy": GateConfig(sr=48000).smoothing[0], "129": 64, "641": 320}[name])


# (taps, prop, rows, n_bins): rows that are not a multiple of the plan's
# lines a span (8 at 513 bins, 17 at 257, 256 at 21)
FS_CASES = {
    "scipy-prop0.8": ("scipy", 0.8, 3 * 331, 513),
    "scipy-prop1": ("scipy", 1.0, 3 * 331, 513),
    "torch-sigma0u0": ("torch", 1.0, 3 * 331, 513),
    "taps129": ("129", 0.8, 2 * 211, 513),
    "taps641-bins257": ("641", 0.8, 4 * 125, 257),
    "bins21-nfft40": ("scipy", 0.8, 2 * 1003, 21),
    "rows-not-a-multiple": ("scipy", 0.8, 8 * 37 + 5, 513),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FS_CASES))
def test_freq_smooth_blend_matches_plain_version(cuda, case):
    """C within 1e-6 of its plain version, bitwise from run to run and on
    any split of its rows (a grouped call's rows land in other spans)."""
    from noisereduce_tpu_torch.ops.cuda.geometry import freq_smooth_plan

    name, prop, rows, nb = FS_CASES[case]
    taps = _fs_taps(name)
    m = torch.as_tensor(np.random.default_rng(120).uniform(0, 1, (rows, nb)),
                        dtype=torch.float32, device=cuda)
    if case == "rows-not-a-multiple":
        assert rows % freq_smooth_plan(rows, nb, len(taps)).lines
    K.reset_launch_counts()
    got = K.freq_smooth_blend(m, taps, prop)
    assert K.launch_counts()["freq_smooth_blend"] == 1
    assert got.shape == m.shape and torch.isfinite(got).all()
    assert _max(got - K.freq_smooth_blend_ref(m, taps, prop)) <= 1e-6
    assert torch.equal(got, K.freq_smooth_blend(m, taps, prop))
    k = rows // 3 + 1
    split = torch.cat([K.freq_smooth_blend(m[:k], taps, prop),
                       K.freq_smooth_blend(m[k:], taps, prop)])
    assert torch.equal(split, got)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_freq_smooth_blend_takes_a_plane_off_16_byte_alignment(cuda, offset):
    """Planes 4, 8 or 12 bytes off a 16-byte boundary: C's 16-byte loads and
    stores start from each tensor's own address, and its output is the
    aligned call's to the bit."""
    taps = _fs_taps("scipy")
    m = torch.as_tensor(np.random.default_rng(121).uniform(0, 1, (77, 513)),
                        dtype=torch.float32, device=cuda)
    mo = torch.cat([m.reshape(-1)[:offset], m.reshape(-1)])[offset:].view(m.shape)
    assert mo.is_contiguous() and mo.data_ptr() % 16 and torch.equal(mo, m)
    got = K.freq_smooth_blend(mo, taps, 0.8)
    assert _max(got - K.freq_smooth_blend_ref(m, taps, 0.8)) <= 1e-6
    assert torch.equal(got, K.freq_smooth_blend(m, taps, 0.8))


# ---------------------------------------------------------------------------
# the bf16 mode: the bfloat16 builds of A, B, D, E and F
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16


def _bf16_ulp(t):
    """One bfloat16 ulp at |t| (0 at zero): 2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    a = t.float().abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8), torch.zeros_like(a))


def _hold_bf16(got, ref, f32_tol):
    """A bf16 kernel's planes or output against its plain version's: the
    same dtype, and each element within one bf16 ulp of the larger of the
    two plus the float32 bound. The kernel and the plain version compute
    float32 values within that bound and each rounds once, so two values on
    either side of a rounding boundary land one ulp apart: up to 2^-7 of
    the value, never less than 2^-8."""
    assert got.dtype == ref.dtype == BF16
    g, r = got.float(), ref.float()
    ulp = _bf16_ulp(torch.maximum(g.abs(), r.abs()))
    assert bool(((g - r).abs() <= ulp + f32_tol * _max(r)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("convention", ["scipy", "torch"])
@pytest.mark.parametrize("kw", ROUTE_GEOMS, ids=ROUTE_IDS)
def test_bf16_spectra_and_istft_routes_match_plain_versions(cuda, kw, convention):
    """A and D's bfloat16 builds on every route against their plain
    versions on the same bf16 signal and planes: A's planes and D's output
    within one bf16 ulp plus the float32 bound; each launch counted as
    bfloat16 on its route."""
    extra = {} if convention == "scipy" else dict(convention="torch", quantize_window_f32=True)
    geo = gate_geometry(StftConfig(**kw, **extra), 8000 + 2 * 1500)
    route = fft_route(geo.scfg)
    tol = 2e-5 if convention == "scipy" else 1e-5
    rng = np.random.default_rng(27)
    x = torch.as_tensor(rng.standard_normal((2, 30000)), dtype=BF16, device=cuda)
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, 8000, 1500)
    rre, rim = K.spectra_ref(x, geo, 8000, 1500)
    _hold_bf16(re, rre, tol)
    _hold_bf16(im, rim, tol)
    mask = torch.as_tensor(rng.random(re.shape), dtype=torch.float32, device=cuda)
    for out_off, out_len in ((1500, 8000), (0, 11000), (9000, 3000)):
        _hold_bf16(K.istft_ola(re, im, mask, geo, out_off, out_len),
                          K.istft_ola_ref(re, im, mask, geo, out_off, out_len), tol)
    assert K.route_counts() == {"spectra": _routes(route)["spectra"],
                                "istft_ola": _routes(route, 3)["istft_ola"]}
    assert K.dtype_counts()["spectra"] == {"float32": 0, "bfloat16": 1}
    assert K.dtype_counts()["istft_ola"] == {"float32": 0, "bfloat16": 3}


# ---------------------------------------------------------------------------
# long frames: A and D past n_fft 8192 (the FFT route's big block, the
# cluster route), C on lines past one block, F at temperatures that are not
# normal floats
# ---------------------------------------------------------------------------
LONG_GEOMS = {  # n_fft, hop, the route
    "nfft16384": (dict(n_fft=16384, hop_length=4096), "cluster"),
    "nfft16380": (dict(n_fft=16380, hop_length=4095), "cluster"),
    "nfft12000": (dict(n_fft=12000, hop_length=3000), "cluster"),
    "nfft8580": (dict(n_fft=8580, hop_length=2145), "fft"),
    "nfft10010": (dict(n_fft=10010, hop_length=2002), "fft"),
    # the big block's other builds: odd 5005 (two frames a slot) and the
    # chirp length 8192 of 4106 (n = 2053)
    "nfft5005": (dict(n_fft=5005, hop_length=1001), "fft"),
    "nfft4106": (dict(n_fft=4106, hop_length=2053), "chirp"),
    "nfft40000": (dict(n_fft=40000, hop_length=10000), "cluster"),
    "nfft32768": (dict(n_fft=32768, hop_length=16384), "cluster"),
    "nfft19683": (dict(n_fft=19683, hop_length=6561), "cluster"),
    "nfft62500": (dict(n_fft=62500, hop_length=12500), "cluster"),
    # the cluster chirp route: prime 4801 (L = 9720, 2 blocks), odd 4803 =
    # 3 x 1601, even 16386 (n = 3 x 2731, L = 16875, 3 blocks), 16940 (n =
    # 2 5 7 11^2: 13-smooth with no cluster shape; L = 17280), 65534 (n = 7
    # 31 151, L = 65536, 8 blocks)
    "nfft4801": (dict(n_fft=4801, hop_length=4801), "cluster_chirp"),
    "nfft4803": (dict(n_fft=4803, hop_length=1601), "cluster_chirp"),
    "nfft16386": (dict(n_fft=16386, hop_length=2731), "cluster_chirp"),
    "nfft16940": (dict(n_fft=16940, hop_length=4235), "cluster_chirp"),
    "nfft65534": (dict(n_fft=65534, hop_length=32767), "cluster_chirp"),
    # the global chirp route: odd 40005 = 3^2 5 7 127 (L = 81,000 = 270 x
    # 300), even 65538 (n = 32,769, L = 65,610 = 243 x 270) and 192000 (n =
    # 96,000, L = 192,000 = 400 x 480)
    "nfft40005": (dict(n_fft=40005, hop_length=8001), "global_chirp"),
    "nfft65538": (dict(n_fft=65538, hop_length=21846), "global_chirp"),
    "nfft192000": (dict(n_fft=192000, hop_length=48000), "global_chirp"),
}


def _long_case(name, convention, cuda, dtype=torch.float32):
    """(geometry, signal, chunk, padding) of a long-frame case: 2 rows of 5
    n_fft samples, chunks of 2 n_fft with n_fft / 4 of padding."""
    kw, route = LONG_GEOMS[name]
    extra = {} if convention == "scipy" else dict(convention="torch", quantize_window_f32=True)
    n = kw["n_fft"]
    cs, pad = 2 * n, n // 4
    geo = gate_geometry(StftConfig(**kw, **extra), cs + 2 * pad)
    assert geo.route == route
    x = torch.as_tensor(np.random.default_rng(28).standard_normal((2, 5 * n)), dtype=dtype,
                        device=cuda)
    return geo, x, cs, pad


@pytest.mark.gpu
@pytest.mark.parametrize("convention", ["scipy", "torch"])
@pytest.mark.parametrize("name", list(LONG_GEOMS))
def test_long_frame_routes_match_plain_versions(cuda, name, convention):
    """Past n_fft 8192: 8580 and 10010 on the FFT route's big block (n =
    4290 and 5005, no cluster shape; with odd 5005 and the chirp's 4106,
    the big block's other builds), 16380 and 12000 (n = 8190 and 6000:
    3 and 2 blocks), 16384 (n = 8192, a big block's size: 2 blocks of 64 x
    128), 40000, 32768, 19683 (odd, two frames a transform) and 62500 on
    the cluster route (2, 4, 2, 3 and 5 blocks); 4801, 4803, 16386,
    16940 and 65534 on the cluster chirp route (2, 2, 3, 3 and 8 blocks);
    40005, 65538 and 192000 on the global chirp route;
    A and D within the FFT cells' bounds of their plain versions (2e-5 x
    max|ref|, 1e-5 under torch conventions), every launch on that route,
    bitwise from call to call."""
    geo, x, cs, pad = _long_case(name, convention, cuda)
    tol = 2e-5 if convention == "scipy" else 1e-5
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, cs, pad)
    rre, rim = K.spectra_ref(x, geo, cs, pad)
    assert _max(re - rre) <= tol * _max(rre) and _max(im - rim) <= tol * _max(rre)
    mask = torch.as_tensor(np.random.default_rng(29).random(re.shape), dtype=torch.float32,
                           device=cuda)
    windows = ((pad, cs), (0, cs + 2 * pad), (cs // 2, 3 * geo.hop + 7))
    outs = []
    for out_off, out_len in windows:
        outs.append(K.istft_ola(re, im, mask, geo, out_off, out_len))
        ry = K.istft_ola_ref(re, im, mask, geo, out_off, out_len)
        assert _max(outs[-1] - ry) <= tol * _max(ry)
    assert K.route_counts() == {"spectra": _routes(geo.route)["spectra"],
                                "istft_ola": _routes(geo.route, 3)["istft_ola"]}
    assert torch.equal(K.spectra(x, geo, cs, pad)[0], re)
    assert torch.equal(K.istft_ola(re, im, mask, geo, *windows[0]), outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nfft16384", "nfft40000", "nfft19683", "nfft4801",
                                  "nfft16386", "nfft65534", "nfft40005", "nfft65538",
                                  "nfft192000"])
def test_bf16_long_frame_routes_match_plain_versions(cuda, name):
    """The bfloat16 builds of the long-frame routes, held as the other
    routes' bf16 builds are: within one bf16 ulp plus the float32 bound."""
    geo, x, cs, pad = _long_case(name, "scipy", cuda, BF16)
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, cs, pad)
    rre, rim = K.spectra_ref(x, geo, cs, pad)
    _hold_bf16(re, rre, 2e-5)
    _hold_bf16(im, rim, 2e-5)
    mask = torch.as_tensor(np.random.default_rng(30).random(re.shape), dtype=torch.float32,
                           device=cuda)
    _hold_bf16(K.istft_ola(re, im, mask, geo, pad, cs),
               K.istft_ola_ref(re, im, mask, geo, pad, cs), 2e-5)
    assert K.dtype_counts()["spectra"] == {"float32": 0, "bfloat16": 1}
    assert K.route_counts() == {"spectra": _routes(geo.route)["spectra"],
                                "istft_ola": _routes(geo.route)["istft_ola"]}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["nfft40000", "nfft19683", "nfft4803", "nfft16386",
                                  "nfft16384"])
def test_cluster_walk_wraps_past_the_clusters_that_fit(cuda, name, dtype):
    """More slots than the cluster routes' persistent grid holds (the
    clusters that fit on the card at once, ``K.cluster_capacity``), so
    every cluster walks several slots: A's slots and D's frames, 40000 (4
    blocks) and odd 19683 (3 blocks, two frames a slot), and on the
    cluster chirp route odd 4803 (2 blocks) and 16386 (3), each within its
    bound of the plain version (bf16: one bf16 ulp more) and bitwise from
    call to call."""
    kw, _ = LONG_GEOMS[name]
    n = kw["n_fft"]
    view = 5 * n
    geo = gate_geometry(StftConfig(**kw), view)
    fps = 2 if geo.fft_paired else 1
    slots = -(-geo.n_frames // fps)
    fit = max(K.cluster_capacity(geo, k, dtype) for k in ("spectra", "istft_ola"))
    rows = 2 * fit // slots + 2
    assert rows * slots > 2 * fit
    x = torch.as_tensor(np.random.default_rng(32).standard_normal((rows, view)), dtype=dtype,
                        device=cuda)
    K.reset_launch_counts()
    re, im = K.spectra(x, geo)
    rre, rim = K.spectra_ref(x, geo)
    mask = torch.as_tensor(np.random.default_rng(33).random(re.shape), dtype=torch.float32,
                           device=cuda)
    out = K.istft_ola(re, im, mask, geo, 0, view)
    ref = K.istft_ola_ref(re, im, mask, geo, 0, view)
    if dtype == BF16:
        _hold_bf16(re, rre, 2e-5)
        _hold_bf16(im, rim, 2e-5)
        _hold_bf16(out, ref, 2e-5)
    else:
        assert _max(re - rre) <= 2e-5 * _max(rre) and _max(im - rim) <= 2e-5 * _max(rre)
        assert _max(out - ref) <= 2e-5 * _max(ref)
    assert K.route_counts() == _routes(geo.route)
    assert torch.equal(K.spectra(x, geo)[1], im)
    assert torch.equal(K.istft_ola(re, im, mask, geo, 0, view), out)


WALK_GEOMS = {  # kernel A's complex-frame builds: the big block's (n = 4290
    # and 5005, every odd radix; odd 5005, paired; the chirp length 8192 of
    # 4106; D's two passes where the walk's ring left no room for the laid
    # twiddles: the chirp's odd 4001 at a hop of a frame and 6920 / 1730, the
    # FFT route's n = 6006 at 12012 / 3003) and a block's (the large radices,
    # 1102: n = 19 x 29, odd 493 = 17 x 29; radix 11, 1100; odd 1323; the
    # chirp length 2304 of 1101; odd 37, the chirp length 81, 50 slots a
    # block; 8190, n = 4095: the largest block-sized slot, one block an SM)
    "nfft8580": dict(n_fft=8580, hop_length=2145),
    "nfft10010": dict(n_fft=10010, hop_length=2002),
    "nfft5005": dict(n_fft=5005, hop_length=1001),
    "nfft4106": dict(n_fft=4106, hop_length=2053),
    "nfft4001": dict(n_fft=4001, hop_length=4001),
    "nfft6920": dict(n_fft=6920, hop_length=1730),
    "nfft12012": dict(n_fft=12012, hop_length=3003),
    "nfft1102": dict(n_fft=1102, hop_length=551),
    "nfft493": dict(n_fft=493, hop_length=29),
    "nfft1100": dict(n_fft=1100, hop_length=275),
    "nfft1323": dict(n_fft=1323, hop_length=441),
    "nfft1101": dict(n_fft=1101, hop_length=367),
    "nfft37": dict(n_fft=37, hop_length=1),
    "nfft8190": dict(n_fft=8190, hop_length=2730),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", list(WALK_GEOMS))
def test_cplx_walk_wraps_past_the_blocks_that_fit(cuda, name, dtype):
    """More tiles than kernel A's persistent blocks (``K.cplx_capacity``:
    the blocks the card holds at once), so every block walks several tiles, copying each next span by cp.async
    from rows at every 2-byte offset of 16 bytes: within the bound of the
    plain version (bf16: one bf16 ulp more), bitwise from call to call,
    and bitwise the same tiles spectra taken a view at a time (a grid of
    one wave or less)."""
    kw = WALK_GEOMS[name]
    view = 3 * kw["n_fft"] + 5
    geo = gate_geometry(StftConfig(**kw), view)
    assert geo.route in ("fft", "chirp") and not geo.fft_real
    fit = K.cplx_capacity(geo, dtype)
    tiles = -(-geo.n_frames // geo.fft_tile_frames)
    rows = 2 * fit // tiles + 2
    assert rows * tiles > 2 * fit
    rng = np.random.default_rng(34)
    for off in (0, 1, 3, 6):  # element offsets: the rows' 16-byte phase
        flat = torch.as_tensor(rng.standard_normal(rows * view + off), dtype=dtype, device=cuda)
        x = flat[off:].view(rows, view)
        K.reset_launch_counts()
        re, im = K.spectra(x, geo)
        rre, rim = K.spectra_ref(x, geo)
        if dtype == BF16:
            _hold_bf16(re, rre, 2e-5)
            _hold_bf16(im, rim, 2e-5)
        else:
            assert _max(re - rre) <= 2e-5 * _max(rre) and _max(im - rim) <= 2e-5 * _max(rre)
        assert K.route_counts()["spectra"] == _routes(geo.route)["spectra"]
        assert torch.equal(K.spectra(x, geo)[1], im)
        one = K.spectra(x[1:2].contiguous(), geo)
        assert torch.equal(one[0][0], re[1]) and torch.equal(one[1][0], im[1])


REAL_WALK_GEOMS = {
    "nfft1024": dict(n_fft=1024, hop_length=256),
    "nfft1536": dict(n_fft=1536, hop_length=384),
    "nfft400": dict(n_fft=400, hop_length=100),
    "nfft512-r2": dict(n_fft=512, hop_length=256),
    "nfft512-r1": dict(n_fft=512, hop_length=512),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", list(REAL_WALK_GEOMS))
def test_real_walk_wraps_past_the_blocks_that_fit(cuda, name, dtype):
    """More tiles and runs than the real-FFT kernels' persistent blocks
    (``K.real_capacity``), so every block of A walks several tiles and
    every block of D several runs, copying each next span or slab by
    cp.async, from signals and planes at every 2-byte offset of 16 bytes
    (bf16 planes at odd element offsets): A and D within the bound of
    their plain versions (bf16: one bf16 ulp more), bitwise from call to
    call, and bitwise one row at a time."""
    kw = REAL_WALK_GEOMS[name]
    view = 40 * kw["n_fft"] + 5
    geo = gate_geometry(StftConfig(**kw), view)
    assert geo.route == "fft" and geo.fft_real
    fit_a = K.real_capacity(geo, "spectra", dtype)
    fit_d = K.real_capacity(geo, "istft_ola", dtype)
    tiles = -(-geo.n_frames // geo.fft_tile_frames)
    runs = -(-geo.out_blocks(0, view)[1] // geo.fft_run)
    rows = max(2 * fit_a // tiles, 2 * fit_d // runs) + 2
    assert rows * tiles > 2 * fit_a and rows * runs > 2 * fit_d
    rng = np.random.default_rng(35)
    for off in (0, 1, 3, 6):  # element offsets: the rows' and planes' 16-byte phase
        flat = torch.as_tensor(rng.standard_normal(rows * view + off), dtype=dtype, device=cuda)
        x = flat[off:].view(rows, view)
        K.reset_launch_counts()
        re, im = K.spectra(x, geo)
        rre, rim = K.spectra_ref(x, geo)
        if dtype == BF16:
            _hold_bf16(re, rre, 2e-5)
            _hold_bf16(im, rim, 2e-5)
        else:
            assert _max(re - rre) <= 2e-5 * _max(rre) and _max(im - rim) <= 2e-5 * _max(rre)
        assert torch.equal(K.spectra(x, geo)[1], im)
        one = K.spectra(x[1:2].contiguous(), geo)
        assert torch.equal(one[0][0], re[1]) and torch.equal(one[1][0], im[1])
        planes = torch.empty((3, re.numel() + off), dtype=dtype, device=cuda)
        pre, pim = (planes[i, off:].view(re.shape) for i in (0, 1))
        pre.copy_(re)
        pim.copy_(im)
        mflat = torch.rand(re.numel() + off, device=cuda)
        mask = mflat[off:].view(re.shape)
        y = K.istft_ola(pre, pim, mask, geo, 0, view)
        ry = K.istft_ola_ref(pre, pim, mask, geo, 0, view)
        if dtype == BF16:
            _hold_bf16(y, ry, 2e-5)
        else:
            assert _max(y - ry) <= 2e-5 * _max(ry)
        assert torch.equal(K.istft_ola(pre, pim, mask, geo, 0, view), y)
        y1 = K.istft_ola(re[1:2].contiguous(), im[1:2].contiguous(), mask[1:2].contiguous(),
                         geo, 0, view)
        assert torch.equal(y1[0], y[1])
        assert K.route_counts() == {"spectra": _routes("fft", 3)["spectra"],
                                    "istft_ola": _routes("fft", 3)["istft_ola"]}


def _istft_into_nan(re, im, mask, geo, out_off, out_len):
    """K.istft_ola with its output allocated over NaN: the caching
    allocator emptied, then a NaN block of the output's shape freed, which
    the wrapper's torch.empty takes next; a sample the kernel leaves
    unwritten stays NaN."""
    torch.cuda.empty_cache()
    torch.full((re.shape[0], out_len), float("nan"), dtype=re.dtype, device=re.device)
    return K.istft_ola(re, im, mask, geo, out_off, out_len)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", list(REAL_WALK_GEOMS) + ["nfft2048-win1024", "nfft882"])
def test_real_istft_writes_every_sample_past_the_end(cuda, name, dtype):
    """D's real-FFT kernel on windows past the signal's end, whose runs'
    last hop blocks lie past the last frame's reach (past the ring of the
    run's last group), and past the end by whole runs: every sample of the
    window is written (the output allocated over NaN), zero past the
    istft length, and the window holds the plain version."""
    kw = {**REAL_WALK_GEOMS, "nfft2048-win1024": dict(n_fft=2048, win_length=1024,
                                                       hop_length=256),
          "nfft882": dict(n_fft=882, hop_length=441)}[name]
    view = 11000
    geo = gate_geometry(StftConfig(**kw), view)
    assert geo.route == "fft" and geo.fft_real
    rng = np.random.default_rng(36)
    x = torch.as_tensor(rng.standard_normal((3, view)), dtype=dtype, device=cuda)
    re, im = K.spectra(x, geo)
    mask = torch.as_tensor(rng.random(re.shape), dtype=torch.float32, device=cuda)
    for out_off, out_len in ((9000, 6000), (5400, 8000), (view - 7, 3 * view)):
        y = _istft_into_nan(re, im, mask, geo, out_off, out_len)
        ry = K.istft_ola_ref(re, im, mask, geo, out_off, out_len)
        assert not torch.isnan(y).any()
        assert not y[:, max(0, geo.istft_len - out_off):].any()
        if dtype == BF16:
            _hold_bf16(y, ry, 2e-5)
        else:
            assert _max(y - ry) <= 2e-5 * _max(ry)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", list(WALK_GEOMS))
def test_cplx_istft_walk_wraps_past_the_blocks_that_fit(cuda, name, dtype):
    """More runs (on a big block, groups of frames: its first pass) than
    D's complex-frame persistent blocks (``K.cplx_capacity(geo, dtype,
    kernel="istft_ola")``), so every block walks several items, from
    planes at every 2-byte offset of 16 bytes: within the bound
    of the plain version (bf16: one bf16 ulp more), bitwise from call to
    call and one row at a time; then on windows past the signal's end,
    every sample written (the output allocated over NaN), zero past the
    istft length."""
    kw = WALK_GEOMS[name]
    view = 12 * kw["n_fft"] + 5
    geo = gate_geometry(StftConfig(**kw), view)
    assert geo.route in ("fft", "chirp") and not geo.fft_real
    fit = K.cplx_capacity(geo, dtype, kernel="istft_ola")
    runs = -(-geo.out_blocks(0, view)[1] // geo.fft_run)
    rows = 2 * fit // runs + 2
    assert rows * runs > 2 * fit
    rng = np.random.default_rng(38)
    x = torch.as_tensor(rng.standard_normal((rows, view)), dtype=dtype, device=cuda)
    re, im = K.spectra(x, geo)
    for off in (0, 1, 3, 6):  # element offsets: the planes' 16-byte phase
        planes = torch.empty((2, re.numel() + off), dtype=dtype, device=cuda)
        pre, pim = (planes[i, off:].view(re.shape) for i in (0, 1))
        pre.copy_(re)
        pim.copy_(im)
        mask = torch.rand(re.numel() + off, device=cuda)[off:].view(re.shape)
        K.reset_launch_counts()
        y = K.istft_ola(pre, pim, mask, geo, 0, view)
        ry = K.istft_ola_ref(pre, pim, mask, geo, 0, view)
        if dtype == BF16:
            _hold_bf16(y, ry, 2e-5)
        else:
            assert _max(y - ry) <= 2e-5 * _max(ry)
        assert torch.equal(K.istft_ola(pre, pim, mask, geo, 0, view), y)
        y1 = K.istft_ola(pre[1:2].contiguous(), pim[1:2].contiguous(), mask[1:2].contiguous(),
                         geo, 0, view)
        assert torch.equal(y1[0], y[1])
        assert K.route_counts()["istft_ola"] == _routes(geo.route, 3)["istft_ola"]
    mask = torch.rand(re.shape, device=cuda)
    for out_off, out_len in ((view - 3 * geo.hop, 4 * geo.hop), (view - 7, 3 * view)):
        y = _istft_into_nan(re, im, mask, geo, out_off, out_len)
        ry = K.istft_ola_ref(re, im, mask, geo, out_off, out_len)
        assert not torch.isnan(y).any()
        assert not y[:, max(0, geo.istft_len - out_off):].any()
        if dtype == BF16:
            _hold_bf16(y, ry, 2e-5)
        else:
            assert _max(y - ry) <= 2e-5 * _max(ry)


# frames below 64 samples: (STFT keywords, the route). 2, 4, 16 and 40 on
# the real-FFT kernels (M = 1: no stage, 4,096 frames a tile; 2; 8; 20 =
# 2^2 5, 204 frames); odd 1 (one point, two frames a slot), 3 (2,730 frames
# a tile) and 63 = 3^2 7, 34 and 62 (radix 17 and 31, stage_large) on the
# complex-frame kernels; the chirp at odd primes 37 (L = 81) and 61 (L =
# 128, D's runs over two groups); hops of 1 to 31
SMALL_GEOMS = {
    "nfft1-r1": (dict(n_fft=1, hop_length=1), "fft"),
    "nfft2-r2": (dict(n_fft=2, hop_length=1), "fft"),
    "nfft2-r1": (dict(n_fft=2, hop_length=2), "fft"),
    "nfft3-r3": (dict(n_fft=3, hop_length=1), "fft"),
    "nfft4-r4": (dict(n_fft=4, hop_length=1), "fft"),
    "nfft16-r4": (dict(n_fft=16, hop_length=4), "fft"),
    "nfft34-r2": (dict(n_fft=34, hop_length=17), "fft"),
    "nfft37-r37": (dict(n_fft=37, hop_length=1), "chirp"),
    "nfft40-r4": (dict(n_fft=40, hop_length=10), "fft"),
    "nfft61-r61": (dict(n_fft=61, hop_length=1), "chirp"),
    "nfft62-r2": (dict(n_fft=62, hop_length=31), "fft"),
    "nfft63-r3": (dict(n_fft=63, hop_length=21), "fft"),
}
# scipy's periodic Hann window of one sample is 0 (its spectra divide by
# the window's sum): n_fft 1 under torch conventions only
SMALL_CASES = [(name, conv) for name in SMALL_GEOMS for conv in ("scipy", "torch")
               if (name, conv) != ("nfft1-r1", "scipy")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name,convention", SMALL_CASES,
                         ids=[f"{n}-{c}" for n, c in SMALL_CASES])
def test_small_frames_match_plain_versions(cuda, name, convention, dtype):
    """A and D at n_fft 1 to 63 (``SMALL_GEOMS``: tiles and groups of 64 to
    8,192 frames, D's runs grown with them, ``geometry.fft_run``) on 2 rows
    in chunks of 8000 with 1500 of padding, in float32 and bf16, against
    their plain versions: 2e-5 x max|ref| (1e-5 under torch conventions),
    a bf16 element within one bf16 ulp more. D on windows inside the
    views, over them whole and past their end (by whole runs), its output
    allocated over NaN: every sample written, zero past the istft length.
    Each launch counted on the geometry's route, in the planes' dtype."""
    kw, route = SMALL_GEOMS[name]
    extra = {} if convention == "scipy" else dict(convention="torch", quantize_window_f32=True)
    geo = gate_geometry(StftConfig(**kw, **extra), 8000 + 2 * 1500)
    assert geo.route == fft_route(geo.scfg) == route
    tol = 2e-5 if convention == "scipy" else 1e-5
    rng = np.random.default_rng(37)
    x = torch.as_tensor(rng.standard_normal((2, 30000)), dtype=dtype, device=cuda)
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, 8000, 1500)
    rre, rim = K.spectra_ref(x, geo, 8000, 1500)
    if dtype == BF16:
        _hold_bf16(re, rre, tol)
        _hold_bf16(im, rim, tol)
    else:
        assert _max(re - rre) <= tol * _max(rre) and _max(im - rim) <= tol * _max(rre)
    mask = torch.as_tensor(rng.random(re.shape), dtype=torch.float32, device=cuda)
    windows = ((1500, 8000), (0, 11000), (9000, 3000), (10990, 30000))
    for out_off, out_len in windows:
        y = _istft_into_nan(re, im, mask, geo, out_off, out_len)
        ry = K.istft_ola_ref(re, im, mask, geo, out_off, out_len)
        assert not torch.isnan(y).any()
        assert not y[:, max(0, geo.istft_len - out_off):].any()
        if dtype == BF16:
            _hold_bf16(y, ry, tol)
        else:
            assert _max(y - ry) <= tol * _max(ry)
    assert K.route_counts() == {"spectra": _routes(route)["spectra"],
                                "istft_ola": _routes(route, len(windows))["istft_ola"]}
    kind = "bfloat16" if dtype == BF16 else "float32"
    assert K.dtype_counts()["spectra"][kind] == 1
    assert K.dtype_counts()["istft_ola"][kind] == len(windows)


@pytest.mark.gpu
def test_cluster_build_takes_each_n_fft_shared_memory(cuda):
    """62500 and 40000 share a build of the cluster route (radices 2 and
    5) with different shared memory a block (6,376 and 5,100 points a
    buffer): launched in turns, larger, smaller, larger, each launch still
    runs and holds its plain version."""
    for name in ("nfft62500", "nfft40000", "nfft62500", "nfft40000"):
        geo, x, cs, pad = _long_case(name, "scipy", cuda)
        re, im = K.spectra(x, geo, cs, pad)
        rre, rim = K.spectra_ref(x, geo, cs, pad)
        assert _max(re - rre) <= 2e-5 * _max(rre) and _max(im - rim) <= 2e-5 * _max(rre)
        mask = torch.ones_like(re)
        out = K.istft_ola(re, im, mask, geo, pad, cs)
        ref = K.istft_ola_ref(re, im, mask, geo, pad, cs)
        assert _max(out - ref) <= 2e-5 * _max(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(stationary=True), dict(use_torch=True)],
                         ids=["nonstationary", "stationary", "use_torch"])
def test_long_frame_reduce_noise_on_card(cuda, kw):
    """reduce_noise(y, 48000, n_fft=40000, time_mask_smooth_ms=500) on
    400,000 samples runs on the card on all three engines, A and D on the
    cluster route and C on lines of 20,001 bins in pieces, within 5e-5 x
    max|ref| of the CPU path (a stationary decision at the border may flip:
    held at finite values of the shape)."""
    y = np.random.default_rng(31).standard_normal(400_000).astype(np.float32)
    args = dict(n_fft=40000, time_mask_smooth_ms=500, **kw)
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 48000, **args)
    counts = K.launch_counts()
    assert counts["freq_smooth_blend"] == 1 and counts["istft_ola"] == 1
    assert K.route_counts() == {k: _routes("cluster", counts[k])[k]
                                for k in ("spectra", "istft_ola")}
    ref = nrt.reduce_noise(y, 48000, device="cpu", **args)
    assert got.shape == y.shape and np.isfinite(got).all()
    if not kw.get("stationary"):
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(stationary=True), dict(use_torch=True)],
                         ids=["nonstationary", "stationary", "use_torch"])
def test_cluster_chirp_reduce_noise_on_card(cuda, kw):
    """reduce_noise(y, 48000, n_fft=4803, hop_length=1601) (a 100 ms
    window of 3 x 1601 samples) on 400,000 samples runs on the card on all
    three engines, A and D on the cluster chirp route, within 5e-5 x
    max|ref| of the CPU path (stationary: held at finite values of the
    shape, as above)."""
    y = np.random.default_rng(34).standard_normal(400_000).astype(np.float32)
    args = dict(n_fft=4803, hop_length=1601, **kw)
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 48000, **args)
    counts = K.launch_counts()
    assert counts["istft_ola"] == 1
    assert K.route_counts() == {k: _routes("cluster_chirp", counts[k])[k]
                                for k in ("spectra", "istft_ola")}
    ref = nrt.reduce_noise(y, 48000, device="cpu", **args)
    assert got.shape == y.shape and np.isfinite(got).all()
    if not kw.get("stationary"):
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["nfft40005", "nfft65538", "nfft192000"])
def test_global_chirp_groups_and_peak_memory(cuda, name, dtype):
    """The global chirp route's output does not depend on the group of
    slots a launch of its passes takes: A's planes and D's output (its
    frame scratch, then one overlap-add pass) bitwise the same with one
    slot a group, three, and the geometry's group (all of them here).
    Each call's peak device memory over its inputs stays under a ceiling
    of its outputs, D's frame scratch, twice the group's scratch and the
    host tables, plus 64 MiB: far under an eighth of a DFT product's
    n_fft x n_fft float32 table (win rows of 2 n_bins values: 6.4 GB at
    40005, 147 GB at 192000)."""
    geo, x, cs, pad = _long_case(name, "scipy", cuda, dtype)
    L = geo.fft_layout()[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    re, im = K.spectra(x, geo, cs, pad)
    mask = torch.as_tensor(np.random.default_rng(36).random(re.shape), dtype=torch.float32,
                           device=cuda)
    out = K.istft_ola(re, im, mask, geo, pad, cs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert K.route_counts() == _routes("global_chirp")
    slots = re.shape[0] * -(-geo.n_frames // (2 if geo.fft_paired else 1))
    t_lo, n_fr = geo.cluster_frames(*geo.out_blocks(pad, cs))
    ceiling = (2 * re.numel() * re.element_size() + mask.numel() * 4
               + out.numel() * out.element_size() + re.shape[0] * n_fr * geo.win * 4
               + 2 * slots * L * 8 + 64 * L * 8 + (64 << 20))
    assert peak <= ceiling, (peak, ceiling)
    assert peak < geo.win * 2 * geo.n_bins * 4 // 8
    for group in (1, 3, slots):
        a = K._spectra_on("global_chirp", x, geo, cs, pad, group=group)
        assert torch.equal(a[0], re) and torch.equal(a[1], im), group
        assert torch.equal(K._istft_ola_on("global_chirp", re, im, mask, geo, pad, cs,
                                           group=group), out), group


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (40005, 8001, 500, 400_000, {}), (40005, 8001, 500, 400_000, dict(stationary=True)),
    (40005, 8001, 500, 400_000, dict(use_torch=True)), (192000, 48000, 2000, 60 * 48000, {})],
    ids=["nfft40005-nonstationary", "nfft40005-stationary", "nfft40005-use_torch",
         "nfft192000-nonstationary"])
def test_global_chirp_reduce_noise_on_card(cuda, case):
    """reduce_noise(y, 48000, n_fft=40005, hop_length=8001,
    time_mask_smooth_ms=500) on 400,000 samples on all three engines, and
    n_fft 192000 / hop 48000 (4 s frames, 2 s of time smoothing) on 60 s,
    run on the card with A and D on the global chirp route only, within
    5e-5 x max|ref| of the CPU path (stationary: held at finite values of
    the shape, as above)."""
    n_fft, hop, smooth_ms, samples, kw = case
    y = np.random.default_rng(37).standard_normal(samples).astype(np.float32)
    args = dict(n_fft=n_fft, hop_length=hop, time_mask_smooth_ms=smooth_ms, **kw)
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 48000, **args)
    counts = K.launch_counts()
    assert counts["istft_ola"] >= 1
    assert K.route_counts() == {k: _routes("global_chirp", counts[k])[k]
                                for k in ("spectra", "istft_ola")}
    ref = nrt.reduce_noise(y, 48000, device="cpu", **args)
    assert got.shape == y.shape and np.isfinite(got).all()
    if not kw.get("stationary"):
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
@pytest.mark.parametrize("nb,taps,rows", [(20001, 208, 41), (24001, 400, 9)],
                         ids=["bins20001", "bins24001"])
def test_freq_smooth_blend_long_lines_match_plain_version(cuda, nb, taps, rows):
    """C on a line past one block (n_fft 40000: 20,001 bins, 417 taps), in
    pieces: within 1e-6 of its plain version, bitwise from call to call and
    on any split of its rows."""
    from noisereduce_tpu_torch.ops.cuda.geometry import freq_smooth_plan

    t = tri_norm(taps)
    assert freq_smooth_plan(rows, nb, len(t)).piece
    m = torch.as_tensor(np.random.default_rng(122).uniform(0, 1, (rows, nb)),
                        dtype=torch.float32, device=cuda)
    got = K.freq_smooth_blend(m, t, 0.8)
    assert _max(got - K.freq_smooth_blend_ref(m, t, 0.8)) <= 1e-6
    assert torch.equal(got, K.freq_smooth_blend(m, t, 0.8))
    split = torch.cat([K.freq_smooth_blend(m[:3], t, 0.8), K.freq_smooth_blend(m[3:], t, 0.8)])
    assert torch.equal(split, got)


@pytest.mark.gpu
@pytest.mark.parametrize("piece", [9, 45, 513])
@pytest.mark.parametrize("case", ["scipy-prop0.8", "taps129", "taps641-bins257"])
def test_freq_smooth_blend_pieces_are_the_whole_line_plan(cuda, case, piece):
    """A line that fits a block, cut into pieces anyway: the same bits as
    its plan of whole lines."""
    from noisereduce_tpu_torch.ops.cuda.geometry import freq_smooth_plan

    name, prop, rows, nb = FS_CASES[case]
    taps = _fs_taps(name)
    m = torch.as_tensor(np.random.default_rng(123).uniform(0, 1, (rows, nb)),
                        dtype=torch.float32, device=cuda)
    pieces = K._freq_smooth_on(freq_smooth_plan(rows, nb, len(taps), piece), m, taps, prop)
    assert torch.equal(pieces, K.freq_smooth_blend(m, taps, prop))


@pytest.mark.gpu
@pytest.mark.parametrize("cells", ["noise", "at threshold"])
@pytest.mark.parametrize("temp", [0.0, -0.0, 1e-40, float("inf"), float("nan")], ids=str)
def test_torch_nonstationary_mask_any_temp_on_card(cuda, temp, cells):
    """F at a temp that is not a normal float (a subnormal one read as a
    zero, as the JAX package divides by it) takes the exact division: NaN
    in the same cells as its plain version, the rest within 1e-5; with a
    threshold of 0 on planes whose |Z| is constant in time, every cell
    with a whole window (or silent) has a ratio of exactly the threshold,
    so a step gives 0/0 there."""
    if cells == "at threshold":  # |Z| constant in time (1 to 4, bin 0 silent): ratio 0
        level = (torch.arange(129, device=cuda) % 4 + 1).float()
        level[0] = 0.0
        re = level.expand(2, 700, 129).contiguous()
        im, thresh = torch.zeros_like(re), 0.0
    else:
        (re, im), thresh = _tile_planes((2, 700, 129), 8, cuda), 2.0
    args = (re, im, 375, thresh, temp, 1.0, _torch_headline_time_taps())
    got = K.torch_nonstationary_mask(*args)
    ref = K.torch_nonstationary_mask_ref(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    if cells == "at threshold" and temp in (0.0, -0.0, 1e-40):
        assert torch.isnan(ref).any()
    keep = ~torch.isnan(ref)
    if keep.any():
        assert _max(got[keep] - ref[keep]) <= 1e-5


def _cut_at(t, off):
    """``t``'s values in a contiguous plane that starts ``off`` elements into
    a storage of exactly off + numel elements, NaN before it: an odd
    ``off`` puts the plane's first element in the upper half of its aligned
    4-byte word, whose lower half is outside the plane, and, for an even
    numel, its last element in the lower half of a word that reaches 2
    bytes past the storage."""
    buf = torch.full((off + t.numel(),), float("nan"), dtype=t.dtype, device=t.device)
    plane = buf[off:].view(t.shape)
    plane.copy_(t)
    return plane


@pytest.mark.gpu
@pytest.mark.parametrize("re_off", (0, 1), ids=["re-even", "re-odd"])
@pytest.mark.parametrize("half", (0, 9, 400, 800), ids=["h0", "h9", "h400", "h800"])
@pytest.mark.parametrize("shape", [(2, 5, 65), (2, 65, 40), (3, 150, 513), (2, 1000, 129),
                                   (2, 97, 552)],
                         ids=["T5", "T65", "T150", "T1000", "T97-nb552"])
def test_bf16_mask_kernels_match_plain_versions(cuda, shape, half, re_off):
    """B, E (a clip's threshold and each view's own statistics) and F read
    bf16 planes: their float32 masks hold the plain versions on the same
    bf16 planes at the float32 bounds (B 1e-4, F 1e-5, E's rule), through
    the halo in the tile and past it (the separate smoothing launch: B at
    h400 and h800, E and F at h800); each launch counted as bfloat16. B's
    final pass takes each element out of its aligned 4-byte word, so the
    planes sit at either half of theirs: n_bins odd (the half flips every
    frame) and even, final-pass blocks of 32 columns that straddle a row
    seam (no n_bins is a multiple of 32), re and im at opposite parities,
    each cut from a storage at element offset 0 or 1 (first and last
    elements whose words reach outside the plane, NaN there)."""
    assert shape[-1] % 32
    re, im = (_cut_at(t.to(BF16), off) for t, off in
              zip(_tile_planes(shape, 150 + half, cuda), (re_off, 1 - re_off)))
    assert (re.data_ptr() % 4, im.data_ptr() % 4) == (2 * re_off, 2 - 2 * re_off)
    taps = tri_norm(half)
    cfg = GateConfig(sr=16000)
    K.reset_launch_counts()
    b = (re, im, cfg.iir_b, 2.0, 10.0, taps)
    got = K.nonstationary_mask(*b)
    assert got.dtype == torch.float32
    assert _max(got - K.nonstationary_mask_ref(*b)) <= 1e-4
    assert K.nonstationary_mask.cuda_launches == (4 if half >= 400 else 3)
    thr = torch.as_tensor(np.random.default_rng(151).normal(-20, 10, shape[-1]),
                          dtype=torch.float32, device=cuda)
    for e in ((re, im, thr, 1, 0.8, taps), (re, im, None, 1, 0.8, taps)):
        kw = dict(top_db=40.0, n_std=1.5) if e[2] is None else {}
        _e_within_rule(K.stationary_mask(*e, **kw), K.stationary_mask_ref(*e, **kw))
    f = (re, im, 20, 1.3, 0.1, 0.8, taps)
    assert _max(K.torch_nonstationary_mask(*f) - K.torch_nonstationary_mask_ref(*f)) <= 1e-5
    counts = K.dtype_counts()
    assert counts["nonstationary_mask"] == {"float32": 0, "bfloat16": 1}
    assert counts["stationary_mask"] == {"float32": 0, "bfloat16": 2}
    assert counts["torch_nonstationary_mask"] == {"float32": 0, "bfloat16": 1}


# engine -> (keywords, the kernels it launches in bf16, their f32 twins that must not run)
BF16_ENGINES = {
    "nonstationary": (dict(), ("spectra", "nonstationary_mask", "istft_ola")),
    "stationary": (dict(stationary=True), ("spectra", "stationary_mask", "istft_ola")),
    "torch": (dict(use_torch=True), ("spectra", "torch_nonstationary_mask", "istft_ola")),
    "torch-stationary": (dict(use_torch=True, stationary=True),
                         ("spectra", "stationary_mask", "istft_ola")),
}
# rel max, rel rms of the bf16 output against float32 (tests/test_bfloat16_mode.py)
BF16_ENVELOPES = {"nonstationary": (2.5e-2, 1.2e-2), "stationary": (1.5e-1, 1.0e-1),
                  "torch": (5e-2, None), "torch-stationary": (1.5e-1, 1.0e-1)}


def _rel_devs(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    a64 = a.astype(np.float64)
    return np.abs(d).max() / np.abs(a64).max(), np.sqrt((d**2).mean() / (a64**2).mean())


@pytest.mark.gpu
@pytest.mark.parametrize("chunked", [False, True], ids=["unchunked", "chunked"])
@pytest.mark.parametrize("engine", list(BF16_ENGINES))
def test_bf16_reduce_noise_on_card(cuda, engine, chunked):
    """``compute_dtype=torch.bfloat16`` on the card: the bf16 builds of A,
    the mask kernel and D run, no float32 build of them does, C runs in
    float32, and the output (the input's dtype) is within the pinned
    envelope of the float32 kernels' output."""
    kw, kernels = BF16_ENGINES[engine]
    y = np.random.default_rng(160).standard_normal((2, 48000)).astype(np.float32)
    if chunked:
        kw = dict(kw, chunk_size=20000, padding=4000)
    f32 = nrt.reduce_noise(y, 48000, **kw)
    K.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the stationary bf16 warning
        b16 = nrt.reduce_noise(y, 48000, compute_dtype=BF16, **kw)
    counts = K.dtype_counts()
    for k in kernels:
        assert counts[k]["bfloat16"] >= 1 and counts[k]["float32"] == 0, (k, counts)
    assert counts["freq_smooth_blend"] == {"float32": 1, "bfloat16": 0}
    assert b16.dtype == np.float32 and b16.shape == y.shape
    rel_max, rel_rms = _rel_devs(f32, b16)
    max_env, rms_env = BF16_ENVELOPES[engine]
    assert rel_max <= max_env and (rms_env is None or rel_rms <= rms_env), (rel_max, rel_rms)


@pytest.mark.gpu
def test_bf16_card_tensor_takes_the_kernels(cuda):
    """A bf16 card tensor goes to the kernels (``kernels_take``), never to a
    staged twin or the float32 builds; ``TPUGate`` returns bf16 and a
    grouped call is bitwise the ungrouped one."""
    from noisereduce_tpu_torch.ops.cuda.dispatch import kernels_take

    x = torch.as_tensor(np.random.default_rng(161).standard_normal((2, 24000)), dtype=BF16,
                        device=cuda)
    assert kernels_take(x) and not kernels_take(x.double())
    gate = nrt.TPUGate(sr=16000, nonstationary=True)
    K.reset_launch_counts()
    out = gate(x)
    assert out.dtype == BF16 and bool(torch.isfinite(out.float()).all())
    counts = K.dtype_counts()
    for k in TORCH_NONSTATIONARY:
        want = {"float32": 0, "bfloat16": 1} if k != "freq_smooth_blend" else {
            "float32": 1, "bfloat16": 0}
        assert counts[k] == want, (k, counts)
    ref = gate(x.float())
    assert _max(out.float() - ref) <= 5e-2 * _max(ref)
    y = np.random.default_rng(162).standard_normal((2, 21200)).astype(np.float32)
    kw = dict(chunk_size=4000, padding=1000, compute_dtype=BF16)
    whole = nrt.reduce_noise(y, 16000, **kw)
    assert np.array_equal(nrt.reduce_noise(y, 16000, max_parallel_chunks=2, **kw), whole)


# ---------------------------------------------------------------------------
# max_parallel_chunks: host-driven chunk groups on the card
# ---------------------------------------------------------------------------
# the kernels one group launches, by engine (a stationary clip's threshold
# adds one launch of A before the groups)
GROUP_ENGINES = {
    "nonstationary": (dict(), NONSTATIONARY),
    "stationary": (dict(stationary=True), ("spectra", "stationary_mask", "freq_smooth_blend",
                                           "istft_ola")),
    "torch": (dict(use_torch=True), TORCH_NONSTATIONARY),
    "torch-stationary-clip": (dict(use_torch=True, stationary=True),
                              ("spectra", "stationary_mask", "freq_smooth_blend", "istft_ola")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("engine", list(GROUP_ENGINES))
def test_grouped_reduce_noise_is_bitwise_the_ungrouped_call(cuda, engine):
    """``max_parallel_chunks`` 1 and 2 against 0 on 5.3 chunks of a stereo
    signal: the same bits, and each kernel launched once a group (A once
    more for a stationary clip's threshold, taken before the groups)."""
    kw, kernels = GROUP_ENGINES[engine]
    y = np.random.default_rng(130).standard_normal((2, 21200)).astype(np.float32)
    kw = dict(kw, chunk_size=4000, padding=1000)
    if engine == "stationary":
        kw["y_noise"] = np.random.default_rng(131).standard_normal(6000)
    if engine == "torch-stationary-clip":
        kw["y_noise"] = np.random.default_rng(132).standard_normal(6000).astype(np.float32)
    clip = 1 if "y_noise" in kw else 0
    outs = {}
    for g, groups in ((0, 1), (1, 6), (2, 3)):
        K.reset_launch_counts()
        outs[g] = nrt.reduce_noise(y, 16000, max_parallel_chunks=g, **kw)
        counts = {k: v for k, v in K.launch_counts().items() if v}
        want = dict.fromkeys(kernels, groups)
        want["spectra"] += clip
        assert counts == want, (g, counts)
    assert np.array_equal(outs[1], outs[0]) and np.array_equal(outs[2], outs[0])


# ---------------------------------------------------------------------------
# streaming: reduce_noise_file and StreamingGate on the card
# ---------------------------------------------------------------------------
STREAM_SR, STREAM_N, STREAM_CK = 16000, 21200, dict(chunk_size=4000, padding=1000)  # 6 chunks
STATIONARY = ("spectra", "stationary_mask", "freq_smooth_blend", "istft_ola")
# engine -> (keywords, the kernels each chunk launches, launches of A before the chunks)
STREAM_ENGINES = {
    "nonstationary": (dict(), NONSTATIONARY, 0),
    "stationary-first-chunk": (dict(stationary=True), STATIONARY, 1),
    "stationary-clip": (dict(stationary=True, y_noise="clip"), STATIONARY, 1),
    "stationary-whole-file": (dict(stationary=True, clip_noise_stationary=False), STATIONARY, 0),
    "torch": (dict(use_torch=True), TORCH_NONSTATIONARY, 0),
    "torch-stationary": (dict(use_torch=True, stationary=True), STATIONARY, 0),
}


def _stream_wav(tmp_path, channels=2):
    from noisereduce_tpu_torch.utils import io as nrio

    y = (0.3 * np.random.default_rng(140).standard_normal((STREAM_N, channels))).astype(
        np.float32).clip(-1, 1)
    path = str(tmp_path / "in.wav")
    nrio.write_wav(path, y, STREAM_SR)  # PCM16: the int16 feed
    return path, nrio.read_wav(path, dtype="float32")[1].T.copy()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", list(STREAM_ENGINES))
def test_file_matches_the_in_memory_call_on_card(cuda, tmp_path, engine):
    """``reduce_noise_file`` on the card against ``reduce_noise`` on the card
    on the samples the file holds, within 5e-5 x max|ref|, each kernel
    launched once a chunk; the whole-file statistics against the in-memory
    gate with the streamed threshold (and that threshold against the
    in-memory one at atol 1e-4, rtol 1e-5)."""
    from noisereduce_tpu_torch import streaming as st
    from noisereduce_tpu_torch.ops.cuda.dispatch import fused_gate_chunked
    from noisereduce_tpu_torch.utils import io as nrio

    kw, kernels, before = STREAM_ENGINES[engine]
    kw = dict(kw, **STREAM_CK)
    if kw.get("y_noise") == "clip":
        kw["y_noise"] = (0.1 * np.random.default_rng(141).standard_normal(6000)).astype(np.float32)
    path, y = _stream_wav(tmp_path)
    out = str(tmp_path / "out.wav")
    K.reset_launch_counts()
    assert nrt.reduce_noise_file(path, out, as_float=True, **kw) == STREAM_N
    counts = {k: v for k, v in K.launch_counts().items() if v}
    want = dict.fromkeys(kernels, 6)
    want["spectra"] += before
    assert counts == want
    got = nrio.read_wav(out, dtype="float32")[1].T
    if engine == "stationary-whole-file":
        cfg = GateConfig(sr=STREAM_SR, stationary=True)
        thr = st._streaming_noise_threshold(path, cfg, cuda)
        yt = torch.as_tensor(y, device=cuda)
        mem_thr = stationary_noise_threshold(yt.mean(dim=0), cfg)
        assert torch.allclose(thr, mem_thr, atol=1e-4, rtol=1e-5)
        with torch.no_grad():
            ref = fused_gate_chunked(yt, cfg, 4000, 1000, thr).cpu().numpy()
    else:
        ref = nrt.reduce_noise(y, STREAM_SR, **kw)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_pinned_pipeline_matches_a_synchronous_loop_on_card(cuda, tmp_path, depth,
                                                           monkeypatch):
    """More chunks (6) than pinned slots (depth + 1): the pipeline's PCM16
    file is the bytes of a loop that waits for every chunk."""
    from noisereduce_tpu_torch import streaming as st
    from noisereduce_tpu_torch.utils import io as nrio

    monkeypatch.setattr(st, "_DEPTH", depth)

    path, _ = _stream_wav(tmp_path)
    cfg = GateConfig(sr=STREAM_SR)
    run = st._view_gate(cfg)

    def core(x):
        return st._chunk_core(x, run, 1000, 4000, True)

    piped, sync = tmp_path / "piped.wav", tmp_path / "sync.wav"
    chunks = list(nrio.stream_chunks(path, 4000, 1000, dtype="int16"))
    assert len(chunks) == 6 and chunks[0][1].dtype == np.int16
    with nrio.WavWriter(str(piped), STREAM_SR, 2, STREAM_N) as w:
        st._pipeline(iter(chunks), [core], (2, 4000), torch.int16, lambda a: w.write(a.T),
                     [cuda])
    with nrio.WavWriter(str(sync), STREAM_SR, 2, STREAM_N) as w:
        for _, c in chunks:
            w.write(core(torch.from_numpy(c).to(cuda)).cpu().numpy().T)
    assert piped.read_bytes() == sync.read_bytes()
    nrt.reduce_noise_file(path, str(tmp_path / "api.wav"), **STREAM_CK)
    assert (tmp_path / "api.wav").read_bytes() == sync.read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("stationary", [False, True])
def test_streaming_gate_matches_the_in_memory_call_on_card(cuda, stationary):
    """Blocks of 4000 with padding 1000, fed in pieces of 1719, against
    ``reduce_noise(chunk_size=4000, padding=1000)`` on the card within 5e-5
    x max|ref|; each block one launch of each kernel (A once more for the
    first block's threshold). That call runs the same kernels, so the
    output is also held to the float64 staged path on the CPU at the
    gate's own short views (about 24 frames), within the same bound (the
    stationary gate where no cell decides its threshold the other way, as
    ``test_stationary_reduce_noise_on_card``)."""
    y = (0.3 * np.random.default_rng(142).standard_normal((2, 5 * 4000 + 321))).astype(np.float32)
    gate = nrt.StreamingGate(STREAM_SR, 4000, 1000, stationary=stationary, channels=2)
    K.reset_launch_counts()
    parts = [gate.process(y[:, s : s + 1719]) for s in range(0, y.shape[-1], 1719)]
    parts.append(gate.flush())
    got = np.concatenate(parts, axis=-1)
    counts = {k: v for k, v in K.launch_counts().items() if v}
    want = dict.fromkeys(STATIONARY if stationary else NONSTATIONARY, 6)
    want["spectra"] += int(stationary)
    assert counts == want
    ref = nrt.reduce_noise(y, STREAM_SR, stationary=stationary, chunk_size=4000, padding=1000)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()
    plain = nrt.reduce_noise(y, STREAM_SR, stationary=stationary, chunk_size=4000,
                             padding=1000, device="cpu", compute_dtype=torch.float64)
    n_flips = 0
    if stationary:
        n_flips, worst = _decision_flips(y, y.mean(axis=0)[:4000],
                                         GateConfig(sr=STREAM_SR, stationary=True),
                                         STREAM_CK)
        assert worst <= 2e-3
    if n_flips == 0:
        assert np.abs(got - plain).max() <= 5e-5 * np.abs(plain).max()


def test_streaming_entry_points_refuse_a_missing_card(tmp_path, monkeypatch):
    """``device="cuda"`` (the default) raises where CUDA is absent, as
    ``reduce_noise`` does, instead of running on the CPU. Needs no card: it
    hides the card if there is one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "in.wav")
    from noisereduce_tpu_torch.utils import io as nrio

    nrio.write_wav(path, np.zeros(9000, np.float32), STREAM_SR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrt.reduce_noise_file(path, str(tmp_path / "o.wav"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrt.StreamingGate(STREAM_SR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrt.reduce_noise(np.zeros(9000), STREAM_SR)



# ---------------------------------------------------------------------------
# chunk sharding over a ChunkMesh on the card
# ---------------------------------------------------------------------------
MESH_KINDS = ["chunk_mesh", "cuda0x4"]


def _card_mesh(kind):
    from noisereduce_tpu_torch.parallel.mesh import ChunkMesh, chunk_mesh

    return chunk_mesh() if kind == "chunk_mesh" else ChunkMesh((torch.device("cuda", 0),) * 4)


def _shard_launches(mesh, n_chunks, group):
    """Launches of each kernel of a path by device: one a shard, or one a
    group of ``group`` chunks."""
    from noisereduce_tpu_torch.parallel.chunking import mesh_ranges

    want = {}
    for dev, _, k in mesh_ranges(n_chunks, mesh):
        want[str(dev)] = want.get(str(dev), 0) + (-(-k // group) if group else 1)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESH_KINDS)
@pytest.mark.parametrize("engine", list(GROUP_ENGINES))
def test_mesh_on_card_is_bitwise_the_unsharded_call(cuda, engine, kind):
    """6 chunks of a stereo signal sharded over the mesh (with and without
    groups of one chunk): the ``mesh=None`` output's bits, and each kernel
    of the path launched once a shard (once a group), counted by device (A
    once more, on the first device, for a clip's threshold)."""
    kw, kernels = GROUP_ENGINES[engine]
    y = np.random.default_rng(150).standard_normal((2, 21200)).astype(np.float32)
    kw = dict(kw, chunk_size=4000, padding=1000)
    if engine in ("stationary", "torch-stationary-clip"):
        kw["y_noise"] = np.random.default_rng(151).standard_normal(6000).astype(np.float32)
    want = nrt.reduce_noise(y, 16000, **kw)
    mesh = _card_mesh(kind)
    for g in (0, 1):
        K.reset_launch_counts()
        got = nrt.reduce_noise(y, 16000, mesh=mesh, max_parallel_chunks=g, **kw)
        torch.cuda.synchronize()
        assert np.array_equal(got, want), (kind, g)
        by_device = K.device_counts()
        for name in by_device:
            expected = _shard_launches(mesh, 6, g) if name in kernels else {}
            if name == "spectra" and "y_noise" in kw:
                first = str(mesh.devices[0])
                expected[first] = expected.get(first, 0) + 1
            assert by_device[name] == expected, (name, g, by_device[name])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESH_KINDS)
@pytest.mark.parametrize("engine", ["nonstationary", "stationary", "torch"])
def test_bf16_and_file_on_a_card_mesh_are_bitwise(cuda, tmp_path, kind, engine):
    """The bf16 mode with a mesh is the unsharded bf16 call bitwise, and
    ``reduce_noise_file`` with a mesh (6 chunks in rounds of the mesh's
    devices, PCM16 in and out) writes the one device's file bytes."""
    kw = dict(chunk_size=4000, padding=1000, stationary=engine == "stationary",
              use_torch=engine == "torch")
    y = np.random.default_rng(152).standard_normal((2, 21200)).astype(np.float32)
    mesh = _card_mesh(kind)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
        want = nrt.reduce_noise(y, 16000, compute_dtype=torch.bfloat16, **kw)
        got = nrt.reduce_noise(y, 16000, compute_dtype=torch.bfloat16, mesh=mesh, **kw)
    assert np.array_equal(got, want)
    path, _ = _stream_wav(tmp_path)
    base, sharded = tmp_path / "base.wav", tmp_path / "mesh.wav"
    nrt.reduce_noise_file(path, str(base), **kw)
    K.reset_launch_counts()
    nrt.reduce_noise_file(path, str(sharded), mesh=mesh, **kw)
    assert sharded.read_bytes() == base.read_bytes()
    assert K.launch_counts()["istft_ola"] == 6


# ---------------------------------------------------------------------------
# the cotangent-precision setting on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("family", ["tpugate", "nonstationary", "stationary", "chunked"])
def test_default_cotangent_mode_casts_on_card(cuda, family, monkeypatch):
    """The default mode (``bf16``) casts the gate-level cotangent of card
    tensors: the value is the serving value bitwise, the gradient float32
    and not the uncast one, within 5e-2 x scale of it (1.5e-1 for the
    stationary gate's binary decisions); ``highest`` is the uncast
    gradient (mode ``high``) bitwise."""
    from noisereduce_tpu_torch.models.spectral_gate import gate_stationary
    from noisereduce_tpu_torch.ops.cuda.dispatch import fused_gate_chunked

    rng = np.random.default_rng(160)
    x = torch.as_tensor(rng.standard_normal((2, 32000)), dtype=torch.float32, device=cuda)
    lim = 5e-2
    if family == "tpugate":
        fn = nrt.TPUGate(sr=16000, nonstationary=True)
    elif family == "nonstationary":
        cfg = GateConfig(sr=16000)
        fn = lambda a: gate_nonstationary(a, cfg)  # noqa: E731
    elif family == "stationary":
        cfg, lim = GateConfig(sr=16000, stationary=True), 1.5e-1
        thr = stationary_noise_threshold(torch.as_tensor(0.8 * rng.standard_normal(16000),
                                                         dtype=torch.float32, device=cuda), cfg)
        fn = lambda a: gate_stationary(a, thr, cfg)  # noqa: E731
    else:
        cfg = GateConfig(sr=16000)
        fn = lambda a: fused_gate_chunked(a, cfg, 8000, 1500)  # noqa: E731
    with torch.no_grad():
        serving = fn(x)
    cot = torch.as_tensor(rng.standard_normal(serving.shape), dtype=torch.float32, device=cuda)

    def grad(mode):
        monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", mode)
        xg = x.clone().requires_grad_()
        out = fn(xg)
        assert torch.equal(out, serving)
        return torch.autograd.grad(out, xg, cot)[0]

    cast, uncast, highest = grad("bf16"), grad("high"), grad("highest")
    assert cast.dtype == torch.float32 and bool(torch.isfinite(cast).all())
    assert not torch.equal(cast, uncast)
    assert _max(cast - uncast) <= lim * _max(uncast)
    assert torch.equal(highest, uncast)


# ---------------------------------------------------------------------------
# the staged H2D and the pieces (parallel/transfer.py) against the one-copy
# path: the same call on a signal already on the card
# ---------------------------------------------------------------------------
STAGE_SR, STAGE_CK = 16000, dict(chunk_size=4000, padding=1000)
STAGE_N = 41000  # 11 chunks, the last of 1000 samples


def _force_pieces(monkeypatch, slab_bytes=6000):
    """Pieces of ceil(chunks / 4) chunks (the rule's floor taken away) over
    slabs of ``slab_bytes``: several slabs a chunk, several chunks a piece."""
    from noisereduce_tpu_torch.parallel import transfer

    monkeypatch.setattr(transfer, "MIN_PIECE_SAMPLES", 1)
    monkeypatch.setattr(transfer, "SLAB_BYTES", slab_bytes)


def _one_copy(y, sr, kw):
    """``reduce_noise(y, sr, **kw)`` with the signal (and a clip) copied to
    the card whole first: the path the staged call must give bitwise."""
    from noisereduce_tpu_torch.api import _as_2d, _run_nonstationary, _run_stationary
    from noisereduce_tpu_torch.api import torch_gate_for

    kw = dict(kw)
    cs, pad = kw.pop("chunk_size"), kw.pop("padding")
    group = kw.pop("max_parallel_chunks", 0)
    cdtype = kw.pop("compute_dtype", torch.float32)
    clip = kw.pop("y_noise", None)
    stationary, use_torch = kw.pop("stationary", False), kw.pop("use_torch", False)
    y = np.asarray(y)
    y2d, flat = _as_2d(y)
    card = torch.as_tensor(np.ascontiguousarray(y2d)).cuda().to(cdtype)
    with torch.no_grad():
        if use_torch:
            gate = torch_gate_for(sr, stationary=stationary, **kw)
            yn = None if clip is None else torch.as_tensor(clip).cuda().to(cdtype)
            out = gate.chunked(card, cs, pad, yn, group)
        else:
            cfg = GateConfig(sr=sr, stationary=stationary, **kw)
            if not stationary:
                out = _run_nonstationary(card, cfg, cs, pad, group)
            else:
                yn = card if clip is None else torch.as_tensor(
                    _as_2d(np.asarray(clip))[0]).cuda().to(cdtype)
                out = _run_stationary(card, yn.mean(dim=0)[..., :cs], cfg, cs, pad, group)
    arr = out.float().cpu().numpy().astype(y.dtype, copy=False)
    return arr.reshape(-1) if flat else arr


def _stage_case(name):
    rng = np.random.default_rng(170)
    mono = rng.standard_normal(STAGE_N)
    stereo = rng.standard_normal((STAGE_N, 2)).T  # a transposed (strided) array
    clip = 0.5 * rng.standard_normal(9000)
    return {
        "float32": (mono.astype(np.float32), {}),
        "float64": (mono, {}),
        "int16": ((mono * 3000).astype(np.int16), {}),
        "bf16": (mono.astype(np.float32), dict(compute_dtype=torch.bfloat16)),
        "stereo": (np.ascontiguousarray(stereo).astype(np.float32), {}),
        "stereo-transposed": (stereo, {}),
        "stationary-clip": (mono.astype(np.float32), dict(stationary=True, y_noise=clip)),
        "stationary-self": (stereo.astype(np.float32), dict(stationary=True)),
        "torch": (mono.astype(np.float32), dict(use_torch=True)),
        "torch-stationary-clip": (mono.astype(np.float32),
                                  dict(use_torch=True, stationary=True,
                                       y_noise=clip.astype(np.float32))),
        "grouped": (mono.astype(np.float32), dict(max_parallel_chunks=8)),
        "one-chunk": (mono[:4000].astype(np.float32), {}),
        "one-chunk-plus-one": (mono[:4001].astype(np.float32), {}),
        "torch-one-chunk": (mono[:4000].astype(np.float32), dict(use_torch=True)),
    }[name]


STAGE_CASES = ["float32", "float64", "int16", "bf16", "stereo", "stereo-transposed",
               "stationary-clip", "stationary-self", "torch", "torch-stationary-clip",
               "grouped", "one-chunk", "one-chunk-plus-one", "torch-one-chunk"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", STAGE_CASES)
def test_staged_reduce_noise_is_bitwise_the_one_copy_path(cuda, name, monkeypatch):
    """Each case through ``reduce_noise`` (slabs of 6,000 bytes, pieces of
    ceil(chunks / 4) chunks: 4 pieces of 11 chunks, 2 of 2;
    max_parallel_chunks 8: 2) is the one-copy path's output bitwise, each
    kernel launched once a piece (A once more for the threshold)."""
    _force_pieces(monkeypatch)
    y, kw = _stage_case(name)
    kw = dict(kw, **STAGE_CK)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
        K.reset_launch_counts()
        got = nrt.reduce_noise(y, STAGE_SR, **kw)
        counts = K.launch_counts()
        want = _one_copy(y, STAGE_SR, kw)
    assert got.dtype == y.dtype and got.shape == y.shape
    assert np.array_equal(got, want), name
    chunks = (y.shape[-1] - 1) // 4000 + 1
    pieces = {11: 4, 2: 2, 1: 1}[chunks]
    if name == "grouped":
        pieces = 2
    clip = 1 if ("y_noise" in kw or name == "stationary-self") else 0
    assert counts["istft_ola"] == pieces, counts
    assert counts["spectra"] == pieces + clip, counts


@pytest.mark.gpu
def test_staged_pieces_wait_for_their_slabs(cuda, monkeypatch):
    """The copy stream held back by ``torch.cuda._sleep`` (and the D2H
    stream too), with the signal's buffer over NaN bytes and a ring of more
    slots than slabs (so the host never waits for a slab's copy and every
    launch is queued before the first slab lands): the kernels of each
    piece still read only samples that have arrived, and the output is the
    one-copy path's bitwise; with the compute stream held back, each
    piece's D2H still waits for its kernels."""
    from noisereduce_tpu_torch.parallel import transfer

    _force_pieces(monkeypatch)
    monkeypatch.setattr(transfer, "RING_SLABS", 256)
    monkeypatch.setattr(transfer._LOCAL, "rings", None, raising=False)
    y, kw = _stage_case("stereo")
    kw = dict(kw, **STAGE_CK)
    want = _one_copy(y, STAGE_SR, kw)
    for engine in ({}, dict(use_torch=True), dict(stationary=True)):
        h2d, d2h = transfer._copy_stream(cuda, "h2d"), transfer._copy_stream(cuda, "d2h")
        with torch.cuda.stream(h2d):
            nan = torch.full((4, STAGE_N), float("nan"), device=cuda)
            del nan
            torch.cuda._sleep(200_000_000)
        with torch.cuda.stream(d2h):
            torch.cuda._sleep(50_000_000)
        got = nrt.reduce_noise(y, STAGE_SR, **kw, **engine)
        assert np.array_equal(got, _one_copy(y, STAGE_SR, dict(kw, **engine))), engine
        if not engine:
            assert np.array_equal(got, want)
        # the compute stream held back instead: each D2H waits for its piece
        torch.cuda._sleep(200_000_000)
        again = nrt.reduce_noise(y, STAGE_SR, **kw, **engine)
        assert np.array_equal(again, got), engine


COPY_SETTINGS = {
    "default": {},
    "many parts": dict(COPY_PART_BYTES=64),
    "3 threads, many parts": dict(COPY_THREADS=3, COPY_PART_BYTES=64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("setting", list(COPY_SETTINGS))
@pytest.mark.parametrize("name", ["float32", "float64", "int16", "bf16", "stereo-transposed",
                                  "stationary-clip"])
def test_staged_native_copy_is_the_one_copy_path(cuda, name, setting, monkeypatch):
    """The host's native copy at each setting (parts of 64 bytes over the
    pool, 3 threads):
    the staged call bitwise the one-copy path (float64 cast by the host,
    bitwise the card's cast; int16 sent as int16; bf16 cast on the card)."""
    from noisereduce_tpu_torch.parallel import transfer

    _force_pieces(monkeypatch)
    for k, v in COPY_SETTINGS[setting].items():
        monkeypatch.setattr(transfer, k, v)
    y, kw = _stage_case(name)
    kw = dict(kw, **STAGE_CK)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
        got = nrt.reduce_noise(y, STAGE_SR, **kw)
        want = _one_copy(y, STAGE_SR, kw)
    assert got.dtype == y.dtype and np.array_equal(got, want), (name, setting)


@pytest.mark.gpu
def test_host_cast_is_the_cards_cast(cuda, monkeypatch):
    """float64 rows cast to float32 by the host's copy (slabs of 6,000
    bytes, parts of 64) land on the card bitwise the card's own cast of the
    float64 rows: ties, subnormal and overflowing results, +-0, +-inf;
    NaN where NaN (the card may write another NaN)."""
    from noisereduce_tpu_torch.parallel import transfer

    _force_pieces(monkeypatch)
    monkeypatch.setattr(transfer, "COPY_PART_BYTES", 64)
    rng = np.random.default_rng(173)
    x = rng.standard_normal((3, 20011)) * 10.0 ** rng.integers(-46, 40, size=(3, 20011))
    f32 = np.finfo(np.float32)
    special = [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 1e-40, -1e-40,
               float(f32.smallest_subnormal) / 2, float(f32.smallest_subnormal) * 0.75,
               1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24, 1e39, float(f32.tiny) * (1 - 2.0 ** -30)]
    x[1, 5:5 + len(special)] = special
    for src in (x, np.ascontiguousarray(x.T).T, x[:, ::-1]):
        hs = transfer.HostSignal(src, torch.float32)
        assert hs.wire_dtype == torch.float32
        got = hs.stage(cuda).tensor()
        want = torch.as_tensor(np.ascontiguousarray(src)).to(cuda).float()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("node", ["the host's", "faked"])
def test_ring_slots_are_pinned_where_the_copy_threads_run(cuda, node, monkeypatch):
    """The ring's slots are pinned (the H2D is a DMA that overlaps the
    host's work), and where the card has a NUMA node (the host's, or faked:
    node 0 of half this process's CPUs) the copy threads are bound to its
    CPUs and, on the host's node, the slots' pages lie on it."""
    from noisereduce_tpu_torch.parallel import host_copy, transfer

    if node == "faked":
        allowed = sorted(os.sched_getaffinity(0))
        half = allowed[: max(1, len(allowed) // 2)]
        monkeypatch.setattr(host_copy, "card_node", lambda device: 0)
        monkeypatch.setattr(host_copy, "numa_nodes", lambda: {0: half})
        monkeypatch.setattr(transfer, "_NODE_CPUS", {})
        monkeypatch.setattr(transfer._LOCAL, "rings", None, raising=False)
    y = _stage_case("stereo")[0]
    want = _one_copy(y, STAGE_SR, STAGE_CK)
    assert np.array_equal(nrt.reduce_noise(y, STAGE_SR, **STAGE_CK), want)
    ring = transfer._ring(cuda)
    assert len(ring) == transfer.RING_SLABS
    for slot in ring:
        assert slot.buf.is_pinned() and slot.nbytes >= transfer.SLAB_BYTES
    card = host_copy.card_node(cuda)
    pool = transfer._copy_pool(cuda)
    assert all(slot.pool is pool for slot in ring)
    if card is None:
        assert pool.cpus is None
    else:
        assert pool.cpus and set(pool.cpus) <= set(host_copy.numa_nodes()[card])
    if node == "the host's" and card is not None:
        held = host_copy.pages_by_node([(slot.ptr, slot.nbytes) for slot in ring])
        assert card in held, held  # numa_maps counts whole mappings: others may merge in


@pytest.mark.gpu
def test_staged_slots_wait_for_their_copies(cuda, monkeypatch):
    """The copy stream held back by ``torch.cuda._sleep`` with the ring's 4
    slots over 55 slabs: the host refills a slot (the native copy) only
    once the H2D that read it has run, so the output is the one-copy
    path's bitwise; without that wait the host overwrites slabs still
    queued."""
    from noisereduce_tpu_torch.parallel import transfer

    _force_pieces(monkeypatch)
    monkeypatch.setattr(transfer._LOCAL, "rings", None, raising=False)
    y, kw = _stage_case("stereo")
    kw = dict(kw, **STAGE_CK)
    want = _one_copy(y, STAGE_SR, kw)
    for case in ("float32", "float64"):
        x = y if case == "float32" else y.astype(np.float64) * (1 + 2.0 ** -30)
        expect = want if case == "float32" else _one_copy(x, STAGE_SR, kw)
        with torch.cuda.stream(transfer._copy_stream(cuda, "h2d")):
            torch.cuda._sleep(200_000_000)
        assert np.array_equal(nrt.reduce_noise(x, STAGE_SR, **kw), expect), case


@pytest.mark.gpu
def test_staged_results_stay_independent(cuda, monkeypatch):
    """A result outlives the next call (its pinned output is its own), the
    same array twice gives the same output, an array written between calls
    gives the new one, and no call writes its input."""
    _force_pieces(monkeypatch)
    y, kw = _stage_case("float32")
    kw = dict(kw, **STAGE_CK)
    keep = y.copy()
    first = nrt.reduce_noise(y, STAGE_SR, **kw)
    first_copy = first.copy()
    second = nrt.reduce_noise(y, STAGE_SR, **kw)
    assert np.array_equal(y, keep)
    assert np.array_equal(first, first_copy) and np.array_equal(second, first)
    y[:] = np.random.default_rng(171).standard_normal(y.shape).astype(np.float32)
    third = nrt.reduce_noise(y, STAGE_SR, **kw)
    assert np.array_equal(first, first_copy)
    assert np.array_equal(third, _one_copy(y, STAGE_SR, kw))
    assert not np.array_equal(third, first)


@pytest.mark.gpu
@pytest.mark.parametrize("use_torch", [False, True])
def test_staged_batch_is_the_one_copy_path(cuda, use_torch):
    """``reduce_noise_batch`` on 6 rows of one length (a group staged as one
    block) and 2 of another, stationary with self-noise: each row bitwise
    the one-copy path's batch of its group."""
    from noisereduce_tpu_torch.api import _run_stationary

    rng = np.random.default_rng(172)
    ys = [rng.standard_normal(20000).astype(np.float32) for _ in range(6)]
    ys += [rng.standard_normal(12000).astype(np.float32) for _ in range(2)]
    got = nrt.reduce_noise_batch(ys, STAGE_SR, stationary=True, use_torch=use_torch)
    for idx in (range(6), range(6, 8)):
        card = torch.as_tensor(np.stack([ys[i] for i in idx])).cuda()
        with torch.no_grad():
            if use_torch:
                gate = nrt.api.torch_gate_for(STAGE_SR, stationary=True)
                want = gate.chunked(card, 600000, 30000)
            else:
                cfg = GateConfig(sr=STAGE_SR, stationary=True)
                want = _run_stationary(card, card[..., :600000], cfg, 600000, 30000)
        for row, i in enumerate(idx):
            assert np.array_equal(got[i], want[row].cpu().numpy()), i


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["nonstationary", "stationary-clip", "torch"])
def test_staged_mesh_is_the_one_copy_path(cuda, engine, monkeypatch):
    """A mesh of ``(cuda:0,) * 2``: each device's slice staged in slabs and
    its chunks in pieces (6 and 5 chunks: 3 pieces each), bitwise the
    one-copy path without a mesh, each kernel once a piece by device."""
    from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

    _force_pieces(monkeypatch)
    name = {"nonstationary": "float32", "stationary-clip": "stationary-clip",
            "torch": "torch"}[engine]
    y, kw = _stage_case(name)
    kw = dict(kw, **STAGE_CK)
    mesh = ChunkMesh((torch.device("cuda", 0),) * 2)
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, STAGE_SR, mesh=mesh, **kw)
    by_device = K.device_counts()
    assert np.array_equal(got, _one_copy(y, STAGE_SR, kw))
    assert by_device["istft_ola"] == {"cuda:0": 6}, by_device
    assert by_device["spectra"] == {"cuda:0": 6 + ("y_noise" in kw)}, by_device


# ---------------------------------------------------------------------------
# a float64 caller's output: widened on the card, sent into the call's
# pinned output (parallel/transfer.py::PinnedCores, api._finalize_reduce_output)
# ---------------------------------------------------------------------------
def _float64_case(name):
    """A float64 caller's signal (mono, or stereo as a transposed strided
    array) and its keywords; whether the result is the call's pinned
    output (a mesh's signal of one chunk comes back through pageable
    memory, widened on the card all the same)."""
    from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

    rng = np.random.default_rng(174)
    mono = rng.standard_normal(STAGE_N)
    stereo = rng.standard_normal((STAGE_N, 2)).T
    clip = 0.5 * rng.standard_normal(9000)
    mesh = ChunkMesh((torch.device("cuda", 0),) * 2)
    return {
        "mono": (mono, {}, True),
        "stereo": (stereo, {}, True),
        "stationary-clip": (mono, dict(stationary=True, y_noise=clip), True),
        "stationary-self": (stereo, dict(stationary=True), True),
        "torch": (mono, dict(use_torch=True), True),
        "torch-stationary-clip": (mono, dict(use_torch=True, stationary=True, y_noise=clip),
                                  True),
        "bf16": (mono, dict(compute_dtype=torch.bfloat16), True),
        "grouped": (mono, dict(max_parallel_chunks=8), True),
        "one-chunk": (mono[:4000], {}, True),
        "mesh": (stereo, dict(mesh=mesh), True),
        "mesh-torch": (mono, dict(mesh=mesh, use_torch=True), True),
        "staged-twin": (stereo, dict(hop_length=300), True),
        "mesh-staged-twin": (mono, dict(mesh=mesh, hop_length=300), True),
        "mesh-one-chunk": (mono[:4000], dict(mesh=mesh), False),
    }[name]


FLOAT64_CASES = ["mono", "stereo", "stationary-clip", "stationary-self", "torch",
                 "torch-stationary-clip", "bf16", "grouped", "one-chunk", "mesh", "mesh-torch",
                 "staged-twin", "mesh-staged-twin", "mesh-one-chunk"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", FLOAT64_CASES)
def test_float64_caller_gets_the_float32_output_widened(cuda, name, monkeypatch):
    """A float64 caller's output is float64, bitwise the float32 caller's
    output of the same signal cast to float32 (``reduce_noise(y.astype(
    np.float32)).astype(np.float64)``: the staged path sends float64 as
    float32, cast by the host bitwise numpy's cast), and bf16 compute the
    one-copy path's output widened; on every path the array is the call's
    pinned output, widened on the card (no host copy of the output), but
    a mesh's signal of one chunk (pageable)."""
    _force_pieces(monkeypatch)
    y, kw, pinned = _float64_case(name)
    kw = dict(kw, **STAGE_CK)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
        got = nrt.reduce_noise(y, STAGE_SR, **kw)
        if kw.get("compute_dtype") == torch.bfloat16:
            want = _one_copy(y, STAGE_SR, kw)  # float64 rounds to bf16 once, on the card
        else:
            want = nrt.reduce_noise(y.astype(np.float32), STAGE_SR, **kw).astype(np.float64)
    assert got.dtype == np.float64 and got.shape == y.shape
    assert np.array_equal(got, want), name
    assert torch.from_numpy(got).is_pinned() == pinned, name


@pytest.mark.gpu
def test_float64_batch_rows_are_views_of_the_pinned_output(cuda, monkeypatch):
    """``reduce_noise_batch`` over rows of float64 (two lengths), float32
    and int16: each float64 row float64, bitwise the float32 call's row
    widened, a view of its group's pinned float64 output; every other row
    bitwise the float32 call's."""
    _force_pieces(monkeypatch)
    rng = np.random.default_rng(175)
    ys = [rng.standard_normal(20000) for _ in range(3)]
    ys += [rng.standard_normal(12000) for _ in range(2)]
    ys += [rng.standard_normal(16000).astype(np.float32) for _ in range(2)]
    ys += [(rng.standard_normal(16000) * 3000).astype(np.int16)]
    for kw in (dict(stationary=True), dict(use_torch=True)):
        got = nrt.reduce_noise_batch(ys, STAGE_SR, **kw)
        want = nrt.reduce_noise_batch(
            [y.astype(np.float32) if y.dtype == np.float64 else y for y in ys], STAGE_SR, **kw)
        for y, g, w in zip(ys, got, want):
            assert g.dtype == y.dtype and g.shape == y.shape
            if y.dtype == np.float64:
                assert np.array_equal(g, w.astype(np.float64)), kw
                assert g.base is not None and torch.from_numpy(g).is_pinned()
            else:
                assert np.array_equal(g, w), kw
        # one pinned output a group: its rows side by side
        for i, j in ((0, 1), (1, 2), (3, 4)):
            assert got[i].base is got[j].base, (i, j)
            gap = torch.from_numpy(got[j]).data_ptr() - torch.from_numpy(got[i]).data_ptr()
            assert gap == got[i].nbytes, (i, j)


@pytest.mark.gpu
def test_float64_result_waits_for_its_copies(cuda, monkeypatch):
    """The D2H stream held back by ``torch.cuda._sleep`` and every free
    pinned block of the output's size over NaN (the output takes one of
    them): the float64 result is read only after its copies end, bitwise
    the float32 output widened; with the compute stream held back instead,
    each widening and copy still waits for its piece."""
    from noisereduce_tpu_torch.parallel import transfer

    _force_pieces(monkeypatch)
    y = _float64_case("mono")[0]
    want = nrt.reduce_noise(y.astype(np.float32), STAGE_SR, **STAGE_CK).astype(np.float64)
    for held in ("d2h", "compute"):
        blocks = [torch.full((1, STAGE_N), float("nan"), dtype=torch.float64, pin_memory=True)
                  for _ in range(16)]
        ptrs = {b.data_ptr() for b in blocks}
        del blocks
        if held == "d2h":
            with torch.cuda.stream(transfer._copy_stream(cuda, "d2h")):
                torch.cuda._sleep(200_000_000)
        else:
            torch.cuda._sleep(200_000_000)
        got = nrt.reduce_noise(y, STAGE_SR, **STAGE_CK)
        assert torch.from_numpy(got).data_ptr() in ptrs, held
        assert np.array_equal(got, want), held


@pytest.mark.gpu
def test_float64_results_stay_independent(cuda, monkeypatch):
    """A kept float64 result is its own pinned memory: the next call, on
    another signal, leaves it as it was."""
    _force_pieces(monkeypatch)
    y = _float64_case("mono")[0]
    first = nrt.reduce_noise(y, STAGE_SR, **STAGE_CK)
    keep = first.copy()
    other = np.random.default_rng(176).standard_normal(STAGE_N)
    second = nrt.reduce_noise(other, STAGE_SR, **STAGE_CK)
    assert np.array_equal(first, keep)
    assert not np.shares_memory(first, second)
    want = nrt.reduce_noise(other.astype(np.float32), STAGE_SR, **STAGE_CK)
    assert np.array_equal(second, want.astype(np.float64))


# ---------------------------------------------------------------------------
# an integer or float16 caller's output: narrowed on the card by kernel H
# (ops/cuda/kernels.py::output_cast), sent into the call's pinned output
# ---------------------------------------------------------------------------
CAST_NAMES = ["int8", "uint8", "int16", "uint16", "int32", "float16"]


def _cast_values(n: int, seed: int) -> np.ndarray:
    """float32 values where a cast to an integer or float16 goes wrong
    first (each type's bounds +-0.5 and +-1, 2^15, 2^16, 2^31 and their
    neighbours, 1e10, float16's overflow and ties, +-inf, NaNs with
    payloads, subnormals), then ``n`` seeded values and bit patterns."""
    base = [0.0, 0.5, 0.9, 1.5, 2.5, 2.0**15, 2.0**16, 2.0**31, 2.0**32, 3e9, 1e10,
            2147483520.0, 40000.5, 65535.5, 65504.0, 65519.0, 65520.0, 1 + 2.0**-11,
            1 + 3 * 2.0**-11, 2.0**-24, 2.0**-25, 3 * 2.0**-25]
    for dt in (np.int8, np.uint8, np.int16, np.uint16, np.int32):
        for b in (float(np.iinfo(dt).min), float(np.iinfo(dt).max)):
            base += [b - 1, b - 0.5, b, b + 0.5, b + 1]
    f = np.array(base, dtype=np.float32)
    f = np.concatenate([f, -f])
    f = np.concatenate([f, np.nextafter(f, np.float32(np.inf)),
                        np.nextafter(f, np.float32(-np.inf))])
    special = np.array([0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                        0x7FC0DD1D, 0x7F800001, 0xFF800001, 0x7F802000, 0x7F801FFF,
                        0x7FFFFFFF, 0x00000001, 0x80000001, 0x007FFFFF], dtype=np.uint32)
    rng = np.random.default_rng(seed)
    rand = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 12, size=n)).astype(np.float32)
    rand[::3] = rng.integers(0, 2**32, size=len(rand[::3]), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return np.concatenate([f, special.view(np.float32), rand])


CAST_LAYOUTS = {  # (rows, width, row stride, element offset)
    "contiguous": (3, 1031, 1031, 0),
    "row-offset": (5, 257, 260, 1),
    "strided-rows": (4, 333, 2 * 333 + 5, 3),
    "width-1": (9, 1, 4, 1),
    "one-long-row": (1, 1 << 20 | 13, 1 << 20 | 13, 2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(CAST_LAYOUTS) + ["bf16"])
@pytest.mark.parametrize("name", CAST_NAMES)
def test_output_cast_is_numpys_astype_on_card(cuda, name, layout):
    """Kernel H over the edge grid and seeded values, in rows of odd
    widths, at row offsets and row strides (and from bfloat16 cores):
    bitwise numpy's ``astype`` of the same float32 values on the machine that runs it,
    and bitwise its plain version on the card; one launch a call."""
    dt = getattr(torch, name)
    rows, w, stride, offset = CAST_LAYOUTS.get(layout, (2, 4099, 4100, 1))
    values = _cast_values(rows * w, 190 + len(layout))
    store = torch.full((offset + rows * stride,), float("nan"), device=cuda)
    store[offset:].view(rows, stride)[:, :w] = torch.from_numpy(
        np.resize(values, rows * w).reshape(rows, w))
    if layout == "bf16":
        store = store.to(torch.bfloat16)
    x = store[offset:].view(rows, stride)[:, :w]
    K.reset_launch_counts()
    got = K.output_cast(x, dt)
    torch.cuda.synchronize()
    assert K.launch_counts()["output_cast"] == 1
    assert K.dtype_counts()["output_cast"][str(x.dtype).removeprefix("torch.")] == 1
    assert got.dtype == dt and got.shape == x.shape and got.device == x.device
    ref = K.output_cast_ref(x, dt)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    with np.errstate(invalid="ignore", over="ignore"):
        want = x.float().cpu().numpy().astype(getattr(np, name))
    assert np.array_equal(got.cpu().view(torch.uint8).numpy(), want.view(np.uint8))


@pytest.mark.gpu
def test_output_cast_writes_into_out_and_raises_instead_of_falling_back(cuda):
    """``out`` is written in place (a row-offset view too); float64 cores, a
    dtype H does not write, rows whose elements are not adjacent or an
    ``out`` of another shape raise, with nothing launched."""
    x = torch.randn(3, 1000, device=cuda) * 4e4
    store = torch.zeros(3 * 1003 + 1, dtype=torch.int16, device=cuda)
    out = store[1:].view(3, 1003)[:, :1000]
    assert K.output_cast(x, torch.int16, out) is out
    assert torch.equal(out, K.output_cast_ref(x, torch.int16))
    assert (store[1:].view(3, 1003)[:, 1000:] == 0).all() and store[0] == 0
    K.reset_launch_counts()
    with pytest.raises(TypeError):
        K.output_cast(x.double(), torch.int16)
    with pytest.raises(TypeError):
        K.output_cast(x, torch.int64)
    with pytest.raises(ValueError):
        K.output_cast(x.T, torch.int16)
    with pytest.raises(ValueError):
        K.output_cast(x, torch.int16, torch.empty(3, 999, dtype=torch.int16, device=cuda))
    assert K.launch_counts()["output_cast"] == 0


def _narrow_case(name):
    """A caller's signal, its keywords, whether the result is the call's
    pinned output (a mesh's signal of one chunk comes back through
    pageable memory, narrowed on the card all the same) and kernel H's
    launches: one a piece (4 pieces of 11 chunks; a mesh of 2: 3 a
    device), one for a card tensor (a signal of one chunk, the staged
    twins' geometry)."""
    from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

    rng = np.random.default_rng(177)
    mono = rng.standard_normal(STAGE_N) * 3000
    stereo = (rng.standard_normal((STAGE_N, 2)) * 3000).T
    clip = 0.5 * rng.standard_normal(9000)
    mesh = ChunkMesh((torch.device("cuda", 0),) * 2)
    i16 = mono.astype(np.int16)
    return {
        "int16": (i16, {}, True, 4),
        "int16-stereo-transposed": (stereo.astype(np.int16), {}, True, 4),
        "int8": ((mono / 40).astype(np.int8), {}, True, 4),
        "uint8": (np.clip(128 + mono / 40, 0, 255).astype(np.uint8), {}, True, 4),
        "uint16": ((mono + 30000).astype(np.uint16), {}, True, 4),
        "int32": ((mono * 1000).astype(np.int32), {}, True, 4),
        "float16": ((mono / 3000).astype(np.float16), {}, True, 4),
        "int16-stationary-clip": (i16, dict(stationary=True, y_noise=clip), True, 4),
        "int16-torch": (i16, dict(use_torch=True), True, 4),
        "int16-torch-stationary-clip": (i16, dict(use_torch=True, stationary=True,
                                                  y_noise=clip), True, 4),
        "int16-bf16": (i16, dict(compute_dtype=torch.bfloat16), True, 4),
        "int16-grouped": (i16, dict(max_parallel_chunks=8), True, 2),
        "int16-one-chunk": (i16[:4000], {}, True, 1),
        "int16-torch-one-chunk": (i16[:4000], dict(use_torch=True), True, 1),
        "int16-staged-twin": (stereo.astype(np.int16), dict(hop_length=300), True, 1),
        "int16-mesh": (stereo.astype(np.int16), dict(mesh=mesh), True, 6),
        "int16-mesh-torch": (i16, dict(mesh=mesh, use_torch=True), True, 6),
        "int16-mesh-staged-twin": (i16, dict(mesh=mesh, hop_length=300), True, 2),
        "int16-mesh-one-chunk": (i16[:4000], dict(mesh=mesh), False, 1),
        "float16-bf16": ((mono / 3000).astype(np.float16), dict(compute_dtype=torch.bfloat16),
                         True, 4),
    }[name]


NARROW_CASES = ["int16", "int16-stereo-transposed", "int8", "uint8", "uint16", "int32", "float16",
                "int16-stationary-clip", "int16-torch", "int16-torch-stationary-clip",
                "int16-bf16", "int16-grouped", "int16-one-chunk", "int16-torch-one-chunk",
                "int16-staged-twin", "int16-mesh", "int16-mesh-torch", "int16-mesh-staged-twin",
                "int16-mesh-one-chunk", "float16-bf16"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", NARROW_CASES)
def test_narrow_caller_gets_numpys_cast_in_its_pinned_output(cuda, name, monkeypatch):
    """An integer or float16 caller's staged call (every engine, grouped,
    bf16 compute, a signal of one chunk, the staged twins' geometry, a mesh
    of ``(cuda:0,) * 2``): its own dtype and shape, bitwise numpy's cast of
    the one-copy path's float32 (or bf16) output, the array the call's
    pinned output (but a mesh's signal of one chunk), narrowed on the card
    by kernel H (once a piece, or once for a card tensor; in the build of
    the cores' dtype) and by no host cast."""
    _force_pieces(monkeypatch)
    y, kw, pinned, casts = _narrow_case(name)
    kw = dict(kw, **STAGE_CK)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
        K.reset_launch_counts()
        got = nrt.reduce_noise(y, STAGE_SR, **kw)
        counts, dtypes = K.launch_counts(), K.dtype_counts()
        want = _one_copy(y, STAGE_SR, {k: v for k, v in kw.items() if k != "mesh"})
    assert got.dtype == y.dtype and got.shape == y.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), name
    assert torch.from_numpy(got).is_pinned() == pinned, name
    assert counts["output_cast"] == casts, counts
    build = "bfloat16" if kw.get("compute_dtype") == torch.bfloat16 else "float32"
    assert dtypes["output_cast"][build] == casts, dtypes


@pytest.mark.gpu
@pytest.mark.parametrize("use_torch", [False, True])
def test_narrow_batch_rows_are_views_of_the_pinned_output(cuda, use_torch):
    """``reduce_noise_batch`` over int16 rows of two lengths, float16 and
    uint8 rows (each group a card tensor of one chunk a row): each row its
    caller's dtype, bitwise numpy's cast of the float32 call's row, a view
    of its group's pinned output, kernel H launched once a group."""
    rng = np.random.default_rng(178)
    ys = [(rng.standard_normal(20000) * 3000).astype(np.int16) for _ in range(3)]
    ys += [(rng.standard_normal(12000) * 3000).astype(np.int16) for _ in range(2)]
    ys += [rng.standard_normal(16000).astype(np.float16) for _ in range(2)]
    ys += [np.clip(128 + 40 * rng.standard_normal(16000), 0, 255).astype(np.uint8)]
    kw = dict(stationary=True, use_torch=use_torch)
    K.reset_launch_counts()
    got = nrt.reduce_noise_batch(ys, STAGE_SR, **kw)
    assert K.launch_counts()["output_cast"] == 4  # a group a (length, dtype)
    want = nrt.reduce_noise_batch([y.astype(np.float32) for y in ys], STAGE_SR, **kw)
    for y, g, w in zip(ys, got, want):
        assert g.dtype == y.dtype and g.shape == y.shape
        with np.errstate(invalid="ignore", over="ignore"):
            assert np.array_equal(g.view(np.uint8), w.astype(y.dtype).view(np.uint8))
        assert g.base is not None and torch.from_numpy(g).is_pinned()
    for i, j in ((0, 1), (1, 2), (3, 4), (5, 6)):
        assert got[i].base is got[j].base, (i, j)
        gap = torch.from_numpy(got[j]).data_ptr() - torch.from_numpy(got[i]).data_ptr()
        assert gap == got[i].nbytes, (i, j)


@pytest.mark.gpu
def test_narrow_result_waits_for_its_copies(cuda, monkeypatch):
    """The D2H stream held back by ``torch.cuda._sleep`` and every free
    pinned block of the int16 output's size over a sentinel (the output
    takes one of them): the result is read only after its copies end,
    bitwise numpy's cast of the float32 output; with the compute stream
    held back instead, each narrowing and copy still waits for its piece."""
    from noisereduce_tpu_torch.parallel import transfer

    _force_pieces(monkeypatch)
    y = _narrow_case("int16")[0]
    want = nrt.reduce_noise(y.astype(np.float32), STAGE_SR, **STAGE_CK).astype(np.int16)
    assert not (want == -12345).any()
    for held in ("d2h", "compute"):
        blocks = [torch.full((1, STAGE_N), -12345, dtype=torch.int16, pin_memory=True)
                  for _ in range(16)]
        ptrs = {b.data_ptr() for b in blocks}
        del blocks
        if held == "d2h":
            with torch.cuda.stream(transfer._copy_stream(cuda, "d2h")):
                torch.cuda._sleep(200_000_000)
        else:
            torch.cuda._sleep(200_000_000)
        got = nrt.reduce_noise(y, STAGE_SR, **STAGE_CK)
        assert torch.from_numpy(got).data_ptr() in ptrs, held
        assert np.array_equal(got, want), held
