"""PyTorch port on a CUDA card: each kernel against its plain version, and
``reduce_noise`` / ``reduce_noise_batch`` on the card against the CPU parity
mode and the per-signal calls.

Every test here is marked ``gpu`` and skips without a card. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; there, skip the repository's conftest (it configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

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
twin's at 5e-5 x scale. Kernels A and D are held on both their routes
(the FFT route of a power-of-two n_fft, the product route of n_fft 1536),
and every path is checked to launch them on its geometry's route only.
"""
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
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
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
    x = torch.zeros((1, 8000), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.spectra(x, gate_geometry(StftConfig(), 8000))
    with pytest.raises(TypeError, match="float32"):
        nrt.reduce_noise(np.zeros(8000), 16000, compute_dtype=torch.float64)


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


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["tpugate", "nonstationary", "stationary"])
def test_gradient_on_card_is_the_float64_twins(cuda, family):
    """Under grad the value is the serving value bitwise, with the serving
    launches; the backward pass launches nothing; the gradient matches the
    float64 staged twin's on the card (5e-5 x scale). A stationary gate is
    compared where no binary decision differs between float32 and float64."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _gate_stationary_staged,
        gate_stationary,
    )
    from noisereduce_tpu_torch.ops.dsp import amp_to_db
    from noisereduce_tpu_torch.ops.stft import stft

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
# kernels A and D: the FFT route (power-of-two n_fft) and the product route
# ---------------------------------------------------------------------------
ROUTE_GEOMS = [dict(n_fft=512, hop_length=128), dict(n_fft=1024, hop_length=256),
               dict(n_fft=2048, win_length=1024, hop_length=256),
               dict(n_fft=1536, hop_length=384)]
ROUTE_IDS = ["nfft512", "nfft1024", "nfft2048-win1024", "nfft1536"]


def _routes(route, n=1):
    other = "product" if route == "fft" else "fft"
    return {"spectra": {route: n, other: 0}, "istft_ola": {route: n, other: 0}}


@pytest.mark.gpu
@pytest.mark.parametrize("convention", ["scipy", "torch"])
@pytest.mark.parametrize("kw", ROUTE_GEOMS, ids=ROUTE_IDS)
def test_spectra_and_istft_routes_match_plain_versions(cuda, kw, convention):
    """The geometry picks the route (a power-of-two n_fft the FFT, 1536 the
    product); each launch is counted on its route; both routes hold their
    plain versions at 2e-5 x max|ref| (1e-5 under torch conventions)."""
    extra = {} if convention == "scipy" else dict(convention="torch", quantize_window_f32=True)
    geo = gate_geometry(StftConfig(**kw, **extra), 8000 + 2 * 1500)
    route = "fft" if kw["n_fft"] != 1536 else "product"
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
    if route == "fft":  # the product route serves every geometry the kernels take
        y = K._istft_ola_on("product", re, im, mask, geo, 1500, 8000)
        assert _max(y - K.istft_ola_ref(re, im, mask, geo, 1500, 8000)) <= tol * _max(y)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,route", [
    ({}, "fft"), (dict(stationary=True), "fft"), (dict(use_torch=True), "fft"),
    (dict(n_fft=1536, hop_length=384), "product"),
    (dict(n_fft=1536, hop_length=384, use_torch=True), "product"),
], ids=["nonstationary", "stationary", "use_torch", "nfft1536", "nfft1536-use_torch"])
def test_paths_take_the_route_of_their_geometry(cuda, kw, route):
    """A path with a power-of-two n_fft launches no product-route A or D,
    and n_fft 1536 no FFT-route one; the output matches the CPU parity
    mode."""
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
