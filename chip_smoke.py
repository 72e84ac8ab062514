#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or more (any failure exits non-zero, and the
last line is printed only when every phase passed):

1. environment: torch version, the card's name and power limit
   (``nvidia-smi``); TF32 off, so the plain versions run in full FP32;
2. build: kernels A-G from ``noisereduce_tpu_torch/ops/cuda/csrc`` with
   ``nvcc`` (seconds printed), A and D on both routes;
3. per kernel, at the headline shapes (77 halo'd 660,000-sample chunk views
   of 48 kHz audio): the kernel against its plain version on the same
   inputs, max |dev| against the bound below, the kernel's, the plain
   version's and one library call's time, and the bound the card's memory
   rate and FP32 rate set (for A and D from the function's own bytes, no
   table); A and D run their FFT route (n_fft 1024), and their product
   route is held and timed at the same shapes beside it; also kernel A on a
   10 s noise row (the
   threshold spectra) and kernel B with one unit tap (the staged mask);
   then, under torch conventions (the gate ``reduce_noise(use_torch=True)``
   runs), A with the torch table, F, E with each view's own statistics and
   D with the torch tail; and kernel G on the same spectra laid out
   frequency-major, (77, 513, 2579) complex64;
4. golden: ``reduce_noise(..., device="cuda")`` in float32 on
   ``tests/golden/golden_v1.npz`` (44.1 kHz): the two non-stationary, the
   four stationary and the two torch-convention configurations against the
   reference outputs;
5. headline: 960 s of 48 kHz mono (tones plus non-stationary noise, from a
   seed) through ``reduce_noise`` with its defaults, against the port's
   staged plain path on the card; every kernel of the path must have
   launched; wall time as the minimum of 3 runs after a warm-up (CUDA
   events);
6. stationary headline: the same signal with a separate 10 s noise clip,
   ``stationary=True``, the same way;
7. batch: ``reduce_noise_batch`` on 32 clips of 10 s, stationary with
   self-noise, against the per-signal calls;
8. staged geometry: hop 300 with a 1024 window, which kernels A-D do not
   serve, through the staged path with kernel B's mask;
9. split geometry: a frequency smoothing wide enough that the JAX package
   takes its split path, on both engines;
10. torch headline: the headline signal through
    ``reduce_noise(use_torch=True)`` (kernels A, F, C, D) against the
    staged plain path of the torch convention on the card, timed;
11. torch stationary headline with the 10 s noise clip (A twice, E, C, D),
    timed, held to the plain path as the stationary headline is;
12. torch batch: ``reduce_noise_batch(..., use_torch=True,
    stationary=True)`` on the 32 clips, each its own statistics, against
    the per-signal calls, timed;
13. torch staged geometry: hop 300, which A and D do not serve, through
    the plain STFT and iSTFT around F and C, against the staged plain path;
    then the product route geometry: n_fft 1536 (not a power of two) with
    hop 384 on the first 60 s of the headline signal through
    ``reduce_noise``, where A and D take their DFT-product route, against
    the staged plain path, and those two kernels against their plain
    versions at its shapes;
14. gradient: the fused masks of TPU rows 6 (kernel G, frequency-major)
    and 7 (kernel B, one unit tap) under grad on an 8-view plane; the
    training step of ``TPUGate(sr=16000, nonstationary=True)``, loss
    mean(gate(x)**2), at batch 16 and 256 of 4 s; ``gate_nonstationary``
    and ``gate_stationary`` the same way; each time the value under grad
    against the ``torch.no_grad()`` value (bitwise), the launches of the
    forward pass (the backward pass launches none), the gradient against
    the float64 staged twin on the card, and forward + backward timed;
    then the notebook-3.0 loop, a 31-tap FIR in front of the gate trained
    for 5 Adam steps at batch 256;
15. one JSON line of per-kernel results, then the last line
    ``{"ok": true, "device": {...}}``.

Each path's launches are counted from 0 just before it runs and read just
after, A's and D's also by route: every path with a power-of-two n_fft
must launch them on the FFT route only, the n_fft-1536 path on the product
route only. Stationary outputs are binary-threshold gates: a cell whose dB value
lies within float32 resolution of the threshold may decide either way in
two float32 implementations, and one such cell moves the output by ~1e-3 of
its peak. So a stationary path is held to the plain path twice: as it is,
and with the plain path taking the kernels' decision at the cells within
``BORDER_DB`` of the threshold; every decision that differs must lie there,
and the second comparison must hold the end-to-end bound.

Imports nothing of JAX or of the JAX package ``noisereduce_tpu``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SR = 48000
HEADLINE_SECONDS = 960
NOISE_SECONDS = 10
CHUNK, PADDING = 600000, 30000
BATCH_CLIPS, BATCH_SECONDS = 32, 10
STAGED_SR, STAGED_SECONDS, STAGED_KW = 16000, 30, dict(n_fft=1024, hop_length=300)
# n_grad_freq 64: the merged TPU kernel's frequency halo (66 bins) leaves
# under 16 owned bins per 128-lane tile, so the JAX package splits the gate
SPLIT_SR, SPLIT_SECONDS, SPLIT_KW = 16000, 30, dict(freq_mask_smooth_hz=2000)
# an n_fft that is not a power of two: A and D take their product route
PRODUCT_SECONDS, PRODUCT_KW = 60, dict(n_fft=1536, hop_length=384)
# the card's published peaks (H100 SXM data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 agreement bounds, each with its reason
BOUNDS = {
    # an FP32 FFT (the product route: 1024-term FP32 sums) in another order
    # than cuFFT's: x max|ref|
    "spectra": 2e-5,
    # mask units (the mask is in [0, 1]); float64 IIR carry in both, float
    # vs double rounding of the stored floor, amplified by the sigmoid
    # slope of 10: absolute
    "nonstationary_mask": 1e-4,
    # 2n+1 = 11 FMAs of values <= 1: absolute
    "freq_smooth_blend": 1e-6,
    # an FP32 inverse FFT and 4-term overlap-add (the product route: 4 * 2 *
    # 513-term FP32 sums) vs cuFFT's irfft + fold: x max|ref|
    "istft_ola": 2e-5,
    # mask units, over the cells whose binary decision agrees: a few FMAs of
    # the time taps in another order: absolute
    "stationary_mask": 1e-5,
    # mask units; float64 window sums in both, rounded once, through a
    # sigmoid of slope 1/temp = 10: absolute
    "torch_nonstationary_mask": 1e-5,
    # mask units, as kernel B for the same reason (the same recurrence and
    # sigmoid; no time smoothing): absolute
    "fm_nonstationary_mask": 1e-4,
}
# kernels A and D under torch conventions: the same FP32 sums as above,
# held tighter: x max|ref|
TORCH_TABLE_BOUND = 1e-5
RELATIVE = {"spectra", "istft_ola"}
# kernel E: the share of cells that may differ by more than its bound (a
# dB value within float32 resolution of the threshold decides either way;
# NOTES.md:638-639)
FLIP_SHARE = 1e-5
# a decision may differ only where |dB - threshold| is below the float32
# resolution of the threshold statistics (tests/test_fused_pipeline.py:265)
BORDER_DB = 2e-3
# end to end, as tests/test_fused_pipeline.py:55 holds the TPU kernel: x max|ref|
E2E_BOUND = 5e-5
# the FFT route of A and D, the route of every power-of-two n_fft
SOURCES = {
    "spectra": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_fft.cu",
    "nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/nonstationary_mask.cu",
    "freq_smooth_blend": "noisereduce_tpu_torch/ops/cuda/csrc/freq_smooth_blend.cu",
    "istft_ola": "noisereduce_tpu_torch/ops/cuda/csrc/istft_fft.cu",
    "stationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/stationary_mask.cu",
    "torch_nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/torch_nonstationary_mask.cu",
    "fm_nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/fm_nonstationary_mask.cu",
    # the product route of A and D, for an n_fft that is not a power of two
    "spectra_product": "noisereduce_tpu_torch/ops/cuda/csrc/spectra.cu",
    "istft_ola_product": "noisereduce_tpu_torch/ops/cuda/csrc/istft_ola.cu",
}
# JSON entries of A and D: (the wrapper that launches them, the route)
ROUTED = {"spectra": ("spectra", "fft"), "istft_ola": ("istft_ola", "fft"),
          "spectra_product": ("spectra", "product"),
          "istft_ola_product": ("istft_ola", "product")}
# the TPU kernel each replaces (file:line), and the rows of PERF.md's
# kernel table it serves
REPLACES = {
    "spectra": "noisereduce_tpu/ops/pallas/kernels.py:152 (rows 1, 1s, 2, 4, 5); "
               "noisereduce_tpu/ops/pallas/dispatch.py:556 (row 3, both callers)",
    "nonstationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:422 (rows 1, 2); "
                          "noisereduce_tpu/ops/pallas_mask.py:364 (row 7)",
    "freq_smooth_blend": "noisereduce_tpu/ops/pallas/kernels.py:906 (rows 1, 1s, 2, 4); "
                         "noisereduce_tpu/ops/pallas/torch_dispatch.py:537 (row 5)",
    "istft_ola": "noisereduce_tpu/ops/pallas/kernels.py:736 (rows 1, 1s, 2, 4); "
                 "noisereduce_tpu/ops/pallas/torch_dispatch.py:561 (row 5)",
    "stationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:533 (rows 1s, 2, 4; "
                       "self statistics :583); "
                       "noisereduce_tpu/ops/pallas/torch_dispatch.py:526 (row 5)",
    "torch_nonstationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:635 (row 4, "
                                "torch_dispatch.py:382); "
                                "noisereduce_tpu/ops/pallas/torch_dispatch.py:485 (row 5)",
    "fm_nonstationary_mask": "noisereduce_tpu/ops/pallas_mask.py:229 (row 6)",
}
REPLACES["spectra_product"] = REPLACES["spectra"]
REPLACES["istft_ola_product"] = REPLACES["istft_ola"]
# the gradient phase: the training workload of benchmarks/bench_all.py:316-331
GRAD_SR, GRAD_SECONDS, GRAD_BATCHES = 16000, 4, (16, 256)
# the masks' backward on 8 views of the headline plane (rows 6 and 7)
GRAD_VIEWS = 8
# a float32 gradient against the float64 staged twin's, both on the card
# with TF32 off: float32 rounding of the spectra and of the floor, through
# a sigmoid of slope 10, as the forward is held end to end: x max|ref|
GRAD_BOUND = 5e-5
FIR_TAPS, FIR_STEPS, FIR_LR = 31, 5, 3e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 3) -> float:
    """Minimum over ``reps`` runs after one warm-up, CUDA events, ms."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def headline_signal(seconds: int, sr: int = SR, seed: int = SEED) -> np.ndarray:
    """Tones (one gated on and off) over noise whose level drifts: the case
    the non-stationary gate is for. float32, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = seconds * sr
    t = np.arange(n, dtype=np.float64) / sr
    gate = (np.floor(t / 2.0) % 2 == 0).astype(np.float64)
    tones = 0.3 * gate * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(
        2 * np.pi * 1250.0 * t
    )
    level = 0.05 + 0.04 * np.sin(2 * np.pi * t / 37.0)
    x = tones + level * rng.standard_normal(n)
    return x.astype(np.float32)


def noise_clip(seconds: int, sr: int = SR, seed: int = SEED + 1) -> np.ndarray:
    """A separate noise recording for the stationary statistics: white noise
    at the headline's mean noise level. float32."""
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal(seconds * sr)).astype(np.float32)


def max_dev(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max()), float(ref.abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: float):
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 rate, ms."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_ops(n_fft: int) -> float:
    """Operations of one real FFT of length n_fft (2.5 N log2 N)."""
    return 2.5 * n_fft * np.log2(n_fft)


def measure(label, lim, fn, ref_fn, got, ref, moved, ops, library_fn=None, scale_bound=False):
    """One kernel against its plain version: max |dev| within ``lim``
    (times max|ref| with ``scale_bound``), the kernel's, the plain
    version's and the library call's times, and the card's bound. Fails on
    a disagreement; returns the numbers of the kernels JSON line."""
    dev, scale = max_dev(got, ref)
    lim = lim * (scale if scale_bound else 1.0)
    finite = bool(torch.isfinite(got).all())
    ms = time_ms(fn)
    plain_ms = time_ms(ref_fn)
    library_ms = time_ms(library_fn) if library_fn is not None else None
    bound_ms, bound_by = bound(moved, ops)
    lib = f"{library_ms:.3f} ms" if library_ms is not None else "none"
    print(
        f"kernel {label}: max|dev| {dev:.3e} bound {lim:.3e} "
        f"(max|ref| {scale:.4g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library {lib} card bound {bound_ms:.3f} ms ({bound_by}, "
        f"{moved / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP)",
        flush=True,
    )
    if not finite or not dev <= lim:
        fail(f"kernel {label} disagrees with its plain version")
    return dict(max_abs_err=dev, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def product_route(label, fn, ref, lim):
    """The product route of kernel A or D (the earlier kernel, which now
    serves only an n_fft that is not a power of two) at the same shapes:
    within ``lim`` x max|ref| of the plain version, and its time."""
    dev, scale = max_dev(fn(), ref)
    ms = time_ms(fn)
    print(f"kernel {label}, product route at the same shapes: max|dev| {dev:.3e} "
          f"bound {lim * scale:.3e}, {ms:.3f} ms", flush=True)
    if not dev <= lim * scale:
        fail(f"kernel {label}: the product route disagrees with its plain version")
    return dict(max_abs_err=dev, ms=ms)


def kernel_phase(x_cuda: torch.Tensor, noise_cuda: torch.Tensor, cfg, scfg):
    """Each kernel against its plain version at the main path's shapes.
    ``cfg`` is the non-stationary configuration, ``scfg`` the stationary
    one (the same STFT geometry and smoothing)."""
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.dsp import tri_norm
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    ngf, ngt = cfg.smoothing
    tt, tf = tri_norm(ngt), tri_norm(ngf)
    window = torch.hann_window(geo.win, periodic=True, device=x_cuda.device)
    results = {}

    def record(name, fn, ref_fn, got, ref, moved, ops, library_fn=None, label=None):
        r = measure(label or name, BOUNDS[name], fn, ref_fn, got, ref, moved, ops,
                    library_fn, scale_bound=name in RELATIVE)
        if label is None:
            results[name] = r

    # A: spectra of the 77 halo'd views, read straight from the signal
    a = (x_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    rre, rim = K.spectra_ref(*a)
    torch.cuda.synchronize()
    views = extract_chunks(x_cuda[None], CHUNK, PADDING).reshape(-1, geo.view_len)
    views = views.contiguous()
    record(
        "spectra", lambda: K.spectra(*a), lambda: K.spectra_ref(*a),
        torch.stack([re, im]), torch.stack([rre, rim]),
        nbytes(x_cuda, re, im), re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            views, geo.n_fft, geo.hop, geo.win, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
    )
    results["spectra"]["product_route"] = product_route(
        "spectra", lambda: torch.stack(K._spectra_on("product", *a)),
        torch.stack([rre, rim]), BOUNDS["spectra"])
    del rre, rim, views

    # A on the noise clip (TPU kernel row 3: the threshold's spectra)
    ngeo = gate_geometry(cfg.stft, noise_cuda.shape[-1])
    an = (noise_cuda[None], ngeo)
    nre, nim = K.spectra(*an)
    nrre, nrim = K.spectra_ref(*an)
    record(
        "spectra", lambda: K.spectra(*an), lambda: K.spectra_ref(*an),
        torch.stack([nre, nim]), torch.stack([nrre, nrim]),
        nbytes(noise_cuda, nre, nim), nre.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            noise_cuda, geo.n_fft, geo.hop, geo.win, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        label="spectra (10 s noise row)",
    )
    del nre, nim, nrre, nrim

    cells = re.numel()
    b = (re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
         cfg.sigmoid_slope_nonstationary, tt)
    m = K.nonstationary_mask(*b)
    rm = K.nonstationary_mask_ref(*b)
    record("nonstationary_mask", lambda: K.nonstationary_mask(*b),
           lambda: K.nonstationary_mask_ref(*b), m, rm,
           nbytes(re, im, m), cells * (30.0 + 2 * len(tt)))
    del rm

    # B with one unit tap (TPU kernel row 7: the staged path's mask)
    b1 = b[:-1] + ((1.0,),)
    m1 = K.nonstationary_mask(*b1)
    rm1 = K.nonstationary_mask_ref(*b1)
    record("nonstationary_mask", lambda: K.nonstationary_mask(*b1),
           lambda: K.nonstationary_mask_ref(*b1), m1, rm1,
           nbytes(re, im, m1), cells * 32.0, label="nonstationary_mask (unit tap)")
    del m1, rm1

    # G on the same spectra laid out frequency-major (TPU row 6)
    zf = torch.complex(re, im).transpose(1, 2).contiguous()
    g = (zf, cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    mg = K.fm_nonstationary_mask(*g)
    rmg = K.fm_nonstationary_mask_ref(*g)
    record("fm_nonstationary_mask", lambda: K.fm_nonstationary_mask(*g),
           lambda: K.fm_nonstationary_mask_ref(*g), mg, rmg, nbytes(zf, mg), cells * 30.0)
    del zf, mg, rmg

    c = (m, tf, cfg.prop_decrease)
    mb = K.freq_smooth_blend(*c)
    rmb = K.freq_smooth_blend_ref(*c)
    taps_f = torch.as_tensor(tf, dtype=torch.float32, device=re.device).view(1, 1, -1)
    m_rows = m.reshape(-1, 1, geo.n_bins)
    record("freq_smooth_blend", lambda: K.freq_smooth_blend(*c),
           lambda: K.freq_smooth_blend_ref(*c), mb, rmb,
           nbytes(m, mb), cells * (2.0 * len(tf) + 2),
           # prop_decrease 1: the blend is the identity, so one convolution
           # computes the same function
           library_fn=lambda: F.conv1d(m_rows, taps_f, padding=ngf))
    del rmb

    d = (re, im, mb, geo, PADDING, CHUNK)
    y = K.istft_ola(*d)
    ry = K.istft_ola_ref(*d)
    zm = torch.complex(re * mb, im * mb).transpose(1, 2).contiguous()
    record("istft_ola", lambda: K.istft_ola(*d), lambda: K.istft_ola_ref(*d),
           y, ry, nbytes(re, im, mb, y),
           re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
           library_fn=lambda: torch.istft(
               zm, geo.n_fft, geo.hop, geo.win, window, center=True,
               length=geo.view_len))
    results["istft_ola"]["product_route"] = product_route(
        "istft_ola", lambda: K._istft_ola_on("product", *d), ry, BOUNDS["istft_ola"])
    del zm, y, ry, m, mb

    # E against its plain version, the threshold from a 10 s noise clip
    thr = stationary_noise_threshold(noise_cuda, scfg)
    e = (re, im, thr, 1, scfg.prop_decrease, tt)
    got = K.stationary_mask(*e)
    ref = K.stationary_mask_ref(*e)
    diff = (got - ref).abs()
    off = diff > BOUNDS["stationary_mask"]
    n_off = int(off.sum())
    rest = float(diff[~off].max())
    dev = float(diff.max())
    ms, plain_ms = time_ms(lambda: K.stationary_mask(*e)), time_ms(lambda: K.stationary_mask_ref(*e))
    bound_ms, bound_by = bound(nbytes(re, im, thr, got), cells * (12.0 + 2 * len(tt)))
    print(
        f"kernel stationary_mask: {n_off} of {cells} cells off by more than "
        f"{BOUNDS['stationary_mask']:.0e} (bound {FLIP_SHARE * cells:.0f}, a "
        f"share of {FLIP_SHARE:.0e}); max|dev| over the rest {rest:.3e} bound "
        f"{BOUNDS['stationary_mask']:.0e}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library none card bound {bound_ms:.3f} ms ({bound_by})",
        flush=True,
    )
    if n_off > FLIP_SHARE * cells or not rest <= BOUNDS["stationary_mask"]:
        fail("kernel stationary_mask disagrees with its plain version")
    results["stationary_mask"] = dict(
        max_abs_err=dev, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, cells_flipped=n_off,
        max_abs_err_unflipped=rest,
    )
    return results


def torch_kernel_phase(x_cuda: torch.Tensor, noise_cuda: torch.Tensor, gate, results) -> None:
    """Kernels A (torch table; on the views and on the 10 s noise row, TPU
    row 3's torch caller), F, E (each view's own statistics) and D (torch
    tail) against their plain versions at the shapes the torch headline
    gives them; ``gate`` is the one ``reduce_noise(use_torch=True)`` builds.
    Adds F's entry to ``results`` and the others' torch numbers to
    theirs."""
    from noisereduce_tpu_torch.ops import dsp
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    geo = gate_geometry(gate.stft_config, CHUNK + 2 * PADDING)
    ft, tt = _rank1_taps(gate.smoothing)
    window = torch.hann_window(gate.win_length, dtype=torch.float32, device=x_cuda.device)

    a = (x_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    rre, rim = K.spectra_ref(*a)
    views = extract_chunks(x_cuda[None], CHUNK, PADDING).reshape(-1, geo.view_len)
    views = views.contiguous()
    results["spectra"]["torch_table"] = measure(
        "spectra (torch table)", TORCH_TABLE_BOUND, lambda: K.spectra(*a),
        lambda: K.spectra_ref(*a), torch.stack([re, im]), torch.stack([rre, rim]),
        nbytes(x_cuda, re, im), re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            views, geo.n_fft, geo.hop, gate.win_length, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        scale_bound=True,
    )
    results["spectra"]["torch_table"]["product_route"] = product_route(
        "spectra (torch table)", lambda: torch.stack(K._spectra_on("product", *a)),
        torch.stack([rre, rim]), TORCH_TABLE_BOUND)
    del rre, rim, views

    ngeo = gate_geometry(gate.stft_config, noise_cuda.shape[-1])
    an = (noise_cuda[None], ngeo)
    nre, nim = K.spectra(*an)
    nrre, nrim = K.spectra_ref(*an)
    results["spectra"]["torch_table_noise_row"] = measure(
        "spectra (torch table, 10 s noise row)", TORCH_TABLE_BOUND,
        lambda: K.spectra(*an), lambda: K.spectra_ref(*an),
        torch.stack([nre, nim]), torch.stack([nrre, nrim]),
        nbytes(noise_cuda, nre, nim), nre.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            noise_cuda, geo.n_fft, geo.hop, gate.win_length, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        scale_bound=True,
    )
    del nre, nim, nrre, nrim

    cells = re.numel()
    f = (re, im, gate.n_movemean_nonstationary, gate.n_thresh_nonstationary,
         gate.temp_coeff_nonstationary, gate.prop_decrease, tt)
    m = K.torch_nonstationary_mask(*f)
    rm = K.torch_nonstationary_mask_ref(*f)
    results["torch_nonstationary_mask"] = measure(
        "torch_nonstationary_mask", BOUNDS["torch_nonstationary_mask"],
        lambda: K.torch_nonstationary_mask(*f), lambda: K.torch_nonstationary_mask_ref(*f),
        m, rm, nbytes(re, im, m), cells * (40.0 + 2 * len(tt)))
    del rm

    mb = K.freq_smooth_blend(m, ft, 1.0)
    d = (re, im, mb, geo, PADDING, CHUNK)
    y = K.istft_ola(*d)
    ry = K.istft_ola_ref(*d)
    zm = torch.complex(re * mb, im * mb).transpose(1, 2).contiguous()
    results["istft_ola"]["torch_tail"] = measure(
        "istft_ola (torch tail)", TORCH_TABLE_BOUND, lambda: K.istft_ola(*d),
        lambda: K.istft_ola_ref(*d), y, ry, nbytes(re, im, mb, y),
        re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
        library_fn=lambda: torch.istft(
            zm, geo.n_fft, geo.hop, gate.win_length, window, center=True,
            length=geo.view_len),
        scale_bound=True,
    )
    results["istft_ola"]["torch_tail"]["product_route"] = product_route(
        "istft_ola (torch tail)", lambda: K._istft_ola_on("product", *d), ry,
        TORCH_TABLE_BOUND)
    del zm, y, ry, m, mb

    # E with each view's own statistics: the decisions against the plain
    # version's float64 margins, then the output with the plain version
    # taking E's decisions within BORDER_DB of the threshold
    e = (re, im, None, 1, gate.prop_decrease, tt)
    ekw = dict(top_db=40.0, n_std=gate.n_std_thresh_stationary)
    got = K.stationary_mask(*e, **ekw)
    dec_k = K.stationary_mask(re, im, None, 1, 1.0, (1.0,), **ekw)
    db = torch.log(torch.sqrt(re * re + im * im) + dsp.EPS_F64) * K._DB_PER_NEPER
    mx = db.amax(dim=-2, keepdim=True)
    db = torch.maximum(db, mx - 40.0)
    margin = db.double() - K._self_threshold(db, mx, gate.n_std_thresh_stationary)[:, None, :]
    del db, mx
    dec_p = (margin > 0).to(re.dtype)
    flips = dec_k != dec_p
    n_flips = int(flips.sum())
    worst = float(margin.abs()[flips].max()) if n_flips else 0.0
    dec = torch.where(margin.abs() <= BORDER_DB, dec_k, dec_p)
    del margin, dec_k, dec_p, flips
    ref = dsp.conv_same(dec * gate.prop_decrease + (1.0 - gate.prop_decrease), tt, -2)
    del dec
    diff = (got - ref).abs()
    n_off = int((diff > BOUNDS["stationary_mask"]).sum())
    dev = float(diff.max())
    del diff, ref
    ms = time_ms(lambda: K.stationary_mask(*e, **ekw))
    plain_ms = time_ms(lambda: K.stationary_mask_ref(*e, **ekw))
    bound_ms, bound_by = bound(nbytes(re, im, got), cells * (20.0 + 2 * len(tt)))
    print(
        f"kernel stationary_mask (self statistics, top_db 40): decisions that "
        f"differ from the plain version's {n_flips} of {cells} cells, largest "
        f"|dB - thr| among them {worst:.3e} dB (bound {BORDER_DB:.0e}); with the "
        f"plain version taking E's decisions there: {n_off} cells off by more "
        f"than {BOUNDS['stationary_mask']:.0e}, max|dev| {dev:.3e}; kernel "
        f"{ms:.3f} ms plain {plain_ms:.3f} ms library none card bound "
        f"{bound_ms:.3f} ms ({bound_by})",
        flush=True,
    )
    if worst > BORDER_DB or n_off:
        fail("kernel stationary_mask (self statistics) disagrees with its plain version")
    results["stationary_mask"]["self_statistics"] = dict(
        max_abs_err=dev, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, decisions_differing=n_flips,
        largest_margin_db=worst,
    )


def product_kernel_phase(xq_cuda: torch.Tensor, cfg, results) -> None:
    """Kernels A and D on their product route (n_fft 1536, not a power of
    two) against their plain versions at the shapes the product route
    geometry's path gives them; adds the entries ``spectra_product`` and
    ``istft_ola_product`` to ``results``."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.dsp import tri_norm
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    ngf, ngt = cfg.smoothing
    window = torch.hann_window(geo.win, periodic=True, device=xq_cuda.device)
    a = (xq_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    rre, rim = K.spectra_ref(*a)
    views = extract_chunks(xq_cuda[None], CHUNK, PADDING).reshape(-1, geo.view_len).contiguous()
    results["spectra_product"] = measure(
        "spectra (product route, n_fft 1536)", BOUNDS["spectra"], lambda: K.spectra(*a),
        lambda: K.spectra_ref(*a), torch.stack([re, im]), torch.stack([rre, rim]),
        nbytes(xq_cuda, re, im), re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            views, geo.n_fft, geo.hop, geo.win, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        scale_bound=True,
    )
    del rre, rim
    m = K.freq_smooth_blend(
        K.nonstationary_mask(re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
                             cfg.sigmoid_slope_nonstationary, tri_norm(ngt)),
        tri_norm(ngf), cfg.prop_decrease)
    d = (re, im, m, geo, PADDING, CHUNK)
    zm = torch.complex(re * m, im * m).transpose(1, 2).contiguous()
    results["istft_ola_product"] = measure(
        "istft_ola (product route, n_fft 1536)", BOUNDS["istft_ola"], lambda: K.istft_ola(*d),
        lambda: K.istft_ola_ref(*d), K.istft_ola(*d), K.istft_ola_ref(*d),
        nbytes(re, im, m) + 4 * d[0].shape[0] * CHUNK,
        re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
        library_fn=lambda: torch.istft(
            zm, geo.n_fft, geo.hop, geo.win, window, center=True, length=geo.view_len),
        scale_bound=True,
    )


def torch_staged(y2d, gate, chunk_size, padding, xn=None):
    """The torch convention's staged plain path over (rows, n), chunked as
    ``reduce_noise(use_torch=True)`` chunks: each view through
    ``TPUGate._call_staged``, its natural-length deficit zero filled, the
    cores assembled."""
    from noisereduce_tpu_torch.parallel.chunking import process_chunked

    def call(c):
        v = c.reshape(-1, c.shape[-1])
        out = gate._call_staged(v, xn)
        return F.pad(out, (0, v.shape[-1] - out.shape[-1])).reshape(c.shape)

    with torch.no_grad():
        return process_chunked(call, y2d, chunk_size, padding)


def torch_stationary_vs_plain(label, out, y2d, yn, gate, chunk_size, padding):
    """``stationary_vs_plain`` for the torch convention: a stationary
    TorchGate output from the card against the staged plain path on the
    card, as it is and with the plain path taking the kernels' decisions
    within ``BORDER_DB`` of the threshold. ``yn``: (1, n_clip) noise rows,
    or None for each view's own statistics."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _torch_threshold_stats
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, smooth_mask_2d_torchgate
    from noisereduce_tpu_torch.ops.stft import istft, stft
    from noisereduce_tpu_torch.parallel.chunking import assemble_chunks

    rows, n = y2d.shape
    scfg = gate.stft_config
    n_std = gate.n_std_thresh_stationary
    with torch.no_grad():
        plain = torch_staged(y2d, gate, chunk_size, padding, yn)
        views, k = gate_views(y2d, chunk_size, padding)
        re, im = K.spectra(views, gate_geometry(scfg, views.shape[-1]))
        if yn is None:
            dec_k = K.stationary_mask(re, im, None, 1, 1.0, (1.0,), top_db=40.0, n_std=n_std)
        else:
            thr = _torch_threshold_stats(yn, gate).contiguous()
            dec_k = K.stationary_mask(re, im, thr, re.shape[0], 1.0, (1.0,), top_db=40.0)
        del re, im
        re, im = stft(views, scfg)
        db = amp_to_db(torch.sqrt(re * re + im * im), top_db=40.0, axis=-2)
        if yn is None:
            ref_db = db
        else:
            rn, imn = stft(yn, scfg)
            ref_db = amp_to_db(torch.sqrt(rn * rn + imn * imn), top_db=40.0, axis=-2)
        thr_s = ref_db.mean(dim=-2) + ref_db.std(dim=-2, correction=1) * n_std
        margin = db - thr_s[:, None, :]
        del db, ref_db
        dec_s = (margin > 0).to(re.dtype)
        flips = dec_s != dec_k
        n_flips = int(flips.sum())
        worst = float(margin.abs()[flips].max()) if n_flips else 0.0
        mask = torch.where(margin.abs() <= BORDER_DB, dec_k, dec_s)
        del margin, dec_k, dec_s, flips
        mask = gate.prop_decrease * (mask - 1.0) + 1.0
        mask = smooth_mask_2d_torchgate(mask, *gate.smoothing, time_major=True)
        y = istft((re * mask, im * mask), scfg)
        y = F.pad(y, (0, views.shape[-1] - y.shape[-1]))
        if k > 1:
            aligned = assemble_chunks(y.reshape(rows, k, -1), chunk_size, padding, n)
        else:
            aligned = y[:, padding : padding + n]
    out_t = torch.as_tensor(np.asarray(out, np.float64)).reshape(rows, n)
    dev, _ = max_dev(out_t, plain.cpu())
    dev_al, scale_al = max_dev(out_t, aligned.cpu())
    lim = E2E_BOUND * scale_al
    print(
        f"{label} vs staged plain path: max|dev| {dev:.3e}; decisions that "
        f"differ {n_flips} of {views.shape[0] * scfg.n_frames(views.shape[-1]) * scfg.n_bins} "
        f"cells, largest |dB - thr| among them {worst:.3e} dB (bound "
        f"{BORDER_DB:.0e}); with the plain path taking the kernels' decisions "
        f"there: max|dev| {dev_al:.3e} bound {lim:.3e} (max|ref| {scale_al:.4g})",
        flush=True,
    )
    if worst > BORDER_DB or not dev_al <= lim:
        fail(f"{label} disagrees with the staged plain path")


def gate_views(y2d: torch.Tensor, chunk_size: int, padding: int):
    """The views the gate sees (``parallel.chunking.process_chunked``):
    (rows * n_chunks, view) and n_chunks."""
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    if y2d.shape[-1] <= chunk_size:
        return F.pad(y2d, (padding, padding)), 1
    v = extract_chunks(y2d, chunk_size, padding)
    return v.reshape(-1, v.shape[-1]).contiguous(), v.shape[1]


def kernel_decisions(views, k, yn, cfg):
    """The kernels' binary decisions on (rows * k, view) views: kernel A's
    spectra, the kernel-route threshold of the noise rows ``yn``, E with
    prop 1 and one unit tap."""
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry

    re, im = K.spectra(views, gate_geometry(cfg.stft, views.shape[-1]))
    return K.stationary_mask(re, im, stationary_noise_threshold(yn, cfg), k, 1.0, (1.0,))


def staged_margin(views, k, yn, cfg):
    """The staged path's spectra of the views and their dB - threshold."""
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, noise_db_threshold
    from noisereduce_tpu_torch.ops.stft import stft

    re, im = stft(views, cfg.stft)
    thr = noise_db_threshold(*stft(yn, cfg.stft), cfg.n_std_thresh_stationary)
    if thr.ndim == 2:
        thr = thr.repeat_interleave(k, 0)[:, None, :]
    return re, im, amp_to_db(torch.sqrt(re * re + im * im), top_db=80.0, axis=-2) - thr


def stationary_vs_plain(label, out, y2d, yn, cfg, chunk_size, padding):
    """Hold a stationary gate's output from the card against the staged
    plain path on the card, as it is and with the plain path taking the
    kernels' decisions within ``BORDER_DB`` of the threshold (see the
    module note). y2d: (rows, n) and yn: noise rows, on the card."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _apply_mask_and_invert, _gate_stationary_staged,
    )
    from noisereduce_tpu_torch.ops.dsp import noise_db_threshold, smooth_mask
    from noisereduce_tpu_torch.ops.stft import stft
    from noisereduce_tpu_torch.parallel.chunking import assemble_chunks, process_chunked

    rows, n = y2d.shape
    with torch.no_grad():
        thr_s = noise_db_threshold(*stft(yn, cfg.stft), cfg.n_std_thresh_stationary)
        plain = process_chunked(
            lambda c: _gate_stationary_staged(c, thr_s, cfg), y2d, chunk_size, padding
        )
        views, k = gate_views(y2d, chunk_size, padding)
        dec_k = kernel_decisions(views, k, yn, cfg)
        re, im, margin = staged_margin(views, k, yn, cfg)
        dec_s = (margin > 0).to(re.dtype)
        flips = dec_s != dec_k
        n_flips = int(flips.sum())
        worst = float(margin.abs()[flips].max()) if n_flips else 0.0
        mask = torch.where(margin.abs() <= BORDER_DB, dec_k, dec_s)
        del margin, dec_k, dec_s, flips
        mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
        if cfg.smoothing is not None:
            mask = smooth_mask(mask, *cfg.smoothing, time_major=True)
        y = _apply_mask_and_invert((re, im), mask, cfg, views.shape[-1])
        if k > 1:
            aligned = assemble_chunks(y.reshape(rows, k, -1), chunk_size, padding, n)
        else:
            aligned = y[:, padding : padding + n]
    out_t = torch.as_tensor(np.asarray(out, np.float64)).reshape(rows, n)
    dev, _ = max_dev(out_t, plain.cpu())
    dev_al, scale_al = max_dev(out_t, aligned.cpu())
    lim = E2E_BOUND * scale_al
    print(
        f"{label} vs staged plain path: max|dev| {dev:.3e}; decisions that "
        f"differ {n_flips} of {re.numel()} cells, largest |dB - thr| among them "
        f"{worst:.3e} dB (bound {BORDER_DB:.0e}); with the plain path taking "
        f"the kernels' decisions there: max|dev| {dev_al:.3e} bound {lim:.3e} "
        f"(max|ref| {scale_al:.4g})",
        flush=True,
    )
    if worst > BORDER_DB or not dev_al <= lim:
        fail(f"{label} disagrees with the staged plain path")


def grad_check(label, g, ref, lim):
    """A gradient from the card against its float64 reference: finite and
    within ``lim`` x max|ref| (a complex one as its real pairs)."""
    if g.is_complex():
        g, ref = torch.view_as_real(g), torch.view_as_real(ref)
    dev, scale = max_dev(g, ref)
    finite = bool(torch.isfinite(g).all())
    print(f"{label}: gradient vs float64 twin max|dev| {dev:.3e} bound {lim * scale:.3e} "
          f"(max|ref| {scale:.4g}, {lim:.0e} x), finite {finite}", flush=True)
    if not finite or not dev <= lim * scale:
        fail(f"{label}: the gradient disagrees with the float64 twin")


def under_grad(K, label, fn, args, cot, expected, launches):
    """``fn(*args)`` under grad with its value against the ``torch.no_grad()``
    value (bitwise) and the serving launches, then the backward pass of the
    cotangent ``cot``, which must launch nothing. Returns the gradients.
    The path is counted from the forward pass to the end of the backward."""
    with torch.no_grad():
        serving = fn(*args)
    args = [a.detach().requires_grad_() for a in args]
    holder = {}

    def path():
        out = fn(*args)
        torch.cuda.synchronize()
        holder["forward"] = K.launch_counts()
        holder["bitwise"] = out.grad_fn is not None and torch.equal(out, serving)
        return torch.autograd.grad(out, args, cot)

    grads, launches[label] = run_path(K, label, path, expected)
    print(f"{label}: value under grad bitwise the no-grad value: {holder['bitwise']}; "
          f"forward launches {holder['forward']}", flush=True)
    if not holder["bitwise"] or holder["forward"] != launches[label]:
        fail(f"{label}: the value under grad or the backward's launches")
    return grads


ROUTES = {}  # path label -> kernels A and D's launches by route


def run_path(K, label, fn, expected, route="fft"):
    """Run one path with the launch counts set to 0 just before it and read
    just after; every kernel in ``expected`` must have launched exactly
    that often (the others not at all), A and D all on ``route``."""
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    ROUTES[label] = routes = K.route_counts()
    print(f"{label} launches: {counts}; A and D by route: {routes}", flush=True)
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    if any(r[route] != counts[name] for name, r in routes.items()):
        fail(f"{label}: A or D launched off the {route} route: {routes}")
    return out, counts


def check_output(label, out, like) -> None:
    if out.shape != like.shape or out.dtype != like.dtype:
        fail(f"{label} output shape/dtype")
    if not np.isfinite(out).all():
        fail(f"{label} output not finite")


def golden_phase(nr) -> None:
    data = np.load(os.path.join(HERE, "tests", "golden", "golden_v1.npz"))
    with open(os.path.join(HERE, "tests", "golden", "golden_v1.json")) as f:
        meta = json.load(f)
    sr = meta["sr"]
    # the torch configurations name device="cpu" (the reference's CPU run):
    # here they run on the card, in float32 like the others
    for name in ("nonstationary", "nonstationary_chunked", "stationary_self",
                 "stationary_noise_clip", "stationary_multichannel",
                 "stationary_recorded_noise_nfft2048", "torch_nonstationary_chunked",
                 "torch_stationary_chunked"):
        cfg = meta["configs"][name]
        kw = dict(cfg["kwargs"], device="cuda")
        if cfg["use_noise"]:
            kw["y_noise"] = data["noise"][: sr // 4]
        if cfg.get("use_recorded_noise"):
            kw["y_noise"] = data["cafe_clip"]
        y = data[cfg["input"]]
        out = nr.reduce_noise(y, sr, **kw)
        ref = data[f"out_{name}"]
        dev = float(np.abs(out.astype(np.float64) - ref).max())
        scale = float(np.abs(ref).max())
        bound_ = E2E_BOUND * scale
        print(f"golden {name}: max|dev| {dev:.3e} bound {bound_:.3e} "
              f"({dev / scale:.2e} x max|ref|)", flush=True)
        if out.shape != ref.shape or out.dtype != ref.dtype or not dev <= bound_:
            if kw.get("stationary") and not kw.get("use_torch"):
                golden_flip_report(nr, y, sr, kw)
            fail(f"golden {name}")


def golden_flip_report(nr, y, sr, kw) -> None:
    """Print the cells where the card's stationary decisions differ from a
    float64 staged run on the CPU, with their dB margins."""
    cfg = nr.GateConfig(sr=sr, stationary=True, **{
        k: v for k, v in kw.items() if k not in ("stationary", "y_noise", "device")})
    y2d = np.atleast_2d(y)
    yn = np.atleast_2d(kw.get("y_noise", y)).mean(axis=0)[:CHUNK]

    def on(dev, dt):
        views, k = gate_views(torch.as_tensor(y2d, dtype=dt, device=dev), CHUNK, PADDING)
        return views, k, torch.as_tensor(yn, dtype=dt, device=dev)

    dec = kernel_decisions(*on("cuda", torch.float32), cfg).cpu() > 0
    margin = staged_margin(*on("cpu", torch.float64), cfg)[2]
    flips = dec != (margin > 0)
    print(f"  {int(flips.sum())} cells decide otherwise than float64; their "
          f"|dB - thr|: {margin.abs()[flips][:10].tolist()}", flush=True)


def stationary_reference(x, thr, cfg):
    """The float64 reference of the stationary gate's gradient: the staged
    twin in float64 taking the float32 twin's decisions (the ones the
    backward pass differentiates) at the cells within ``BORDER_DB`` of the
    threshold; every decision that differs must lie there. Returns the
    float64 function of x64, the number of such cells and the largest
    |dB - thr| among them."""
    from noisereduce_tpu_torch.models.spectral_gate import _apply_mask_and_invert
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, smooth_mask
    from noisereduce_tpu_torch.ops.stft import stft

    def margin(a, t):
        re, im = stft(a, cfg.stft)
        return amp_to_db(torch.sqrt(re * re + im * im), top_db=80.0, axis=-2) - t

    with torch.no_grad():
        dec32 = margin(x, thr.float()) > 0
        m64 = margin(x.double(), thr.double())
        dec64 = m64 > 0
        flips = dec32 != dec64
        n_flips = int(flips.sum())
        worst = float(m64.abs()[flips].max()) if n_flips else 0.0
        mask = torch.where(m64.abs() <= BORDER_DB, dec32, dec64).double()
        mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
        mask = smooth_mask(mask, *cfg.smoothing, time_major=True)

    def twin(x64):  # _gate_stationary_staged after the compare
        return _apply_mask_and_invert(stft(x64, cfg.stft), mask, cfg, x64.shape[-1])

    return twin, n_flips, worst


def gradient_phase(nr, K, card, launches, dev="cuda") -> None:
    """Phase 14: rows 6 and 7 under grad, the training step of the three
    gate families at batch 16 and 256, and the notebook-3.0 loop."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _gate_nonstationary_staged, gate_nonstationary, gate_stationary,
        stationary_noise_threshold,
    )
    from noisereduce_tpu_torch.ops.cuda_mask import (
        _mask_impl, _mask_impl_tm, fused_nonstationary_mask, fused_nonstationary_mask_tm,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # rows 6 and 7: the masks of 8 views of the headline's frame count
    cfg = nr.GateConfig(sr=SR)
    mk = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    n_frames = cfg.stft.n_frames(CHUNK + 2 * PADDING)
    z = randn(GRAD_VIEWS, cfg.stft.n_bins, n_frames, dtype=torch.complex64)
    cot = randn(*z.shape)
    (gz,) = under_grad(K, "row 6 mask under grad", lambda a: fused_nonstationary_mask(a, *mk),
                       [z], cot, dict(fm_nonstationary_mask=1), launches)
    z64 = z.to(torch.complex128).requires_grad_()
    (rz,) = torch.autograd.grad(_mask_impl(z64, *mk), z64, cot.double())
    grad_check(f"row 6 mask ({tuple(z.shape)} complex64)", gz, rz, GRAD_BOUND)
    del z, z64, gz, rz
    re, im = randn(GRAD_VIEWS, n_frames, cfg.stft.n_bins), randn(GRAD_VIEWS, n_frames, cfg.stft.n_bins)
    grads = under_grad(K, "row 7 mask under grad",
                       lambda r, i: fused_nonstationary_mask_tm(r, i, *mk), [re, im], cot.transpose(1, 2),
                       dict(nonstationary_mask=1), launches)
    r64, i64 = (t.double().requires_grad_() for t in (re, im))
    refs = torch.autograd.grad(_mask_impl_tm(r64, i64, *mk), (r64, i64), cot.transpose(1, 2).double())
    for name, g, r in zip(("re", "im"), grads, refs):
        grad_check(f"row 7 mask ({tuple(re.shape)}, d/d{name})", g, r, GRAD_BOUND)
    del re, im, r64, i64, grads, refs, cot
    torch.cuda.empty_cache()

    # the training step of the three gate families
    n = GRAD_SR * GRAD_SECONDS
    gate = nr.TPUGate(sr=GRAD_SR, nonstationary=True)
    ncfg = nr.GateConfig(sr=GRAD_SR)
    scfg = nr.GateConfig(sr=GRAD_SR, stationary=True)
    thr = stationary_noise_threshold(0.8 * randn(NOISE_SECONDS * GRAD_SR), scfg)
    families = (
        ("TPUGate", gate, gate._call_staged,
         dict(spectra=1, torch_nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
        ("gate_nonstationary", lambda a: gate_nonstationary(a, ncfg),
         lambda a: _gate_nonstationary_staged(a, ncfg),
         dict(spectra=1, nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
        ("gate_stationary", lambda a: gate_stationary(a, thr, scfg), None,
         dict(spectra=1, stationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
    )
    for batch in GRAD_BATCHES:
        x = randn(batch, n)
        for name, fn, twin, expected in families:
            label = f"training step {name} (batch {batch} x {GRAD_SECONDS} s)"
            with torch.no_grad():
                cot = randn(*fn(x).shape)
            (g,) = under_grad(K, label, fn, [x], cot, expected, launches)
            flips = ""
            if twin is None:
                twin, n_flips, worst = stationary_reference(x, thr, scfg)
                flips = (f"; {n_flips} decisions differ between the float32 and float64 "
                         f"twins, largest |dB - thr| among them {worst:.3e} dB (bound "
                         f"{BORDER_DB:.0e})")
                if worst > BORDER_DB:
                    fail(f"{label}: a decision differs away from the threshold")
            x64 = x.double().requires_grad_()
            (r,) = torch.autograd.grad(twin(x64), x64, cot.double())
            grad_check(label + flips, g, r, GRAD_BOUND)
            del x64, r, g, cot

            xg = x.clone().requires_grad_()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

            def step():
                xg.grad = None
                (fn(xg) ** 2).mean().backward()

            fwd_ms = time_ms(lambda: fn(xg))
            step_ms = time_ms(step)
            print(
                f"{label}: forward + backward {step_ms:.2f} ms ({batch * GRAD_SECONDS / (step_ms / 1e3):.0f} "
                f"audio s per wall s), forward under grad {fwd_ms:.2f} ms, backward "
                f"share {1 - fwd_ms / step_ms:.1%}, peak memory of the timed steps "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, on {card}",
                flush=True,
            )
            del xg

    # the notebook-3.0 loop: a learnable FIR in front of the gate
    batch = GRAD_BATCHES[-1]
    t = torch.arange(n, device=dev, dtype=torch.float32) / GRAD_SR
    clean = torch.sin(2 * np.pi * 440 * t) + 0.5 * torch.sin(2 * np.pi * 220 * t)
    noisy = clean + 0.4 * randn(batch, n)
    fir = torch.zeros(FIR_TAPS, device=dev)
    fir[FIR_TAPS // 2] = 1.0
    fir.requires_grad_()
    adam = torch.optim.Adam([fir], lr=FIR_LR)
    losses = []

    def loop():
        for _ in range(FIR_STEPS):
            adam.zero_grad()
            pre = F.conv1d(noisy[:, None], fir.view(1, 1, -1), padding=FIR_TAPS // 2)[:, 0]
            est = gate(pre)
            loss = ((est - clean[: est.shape[-1]]) ** 2).mean()
            loss.backward()
            adam.step()
            losses.append(loss.item())

    expected = dict(spectra=FIR_STEPS, torch_nonstationary_mask=FIR_STEPS,
                    freq_smooth_blend=FIR_STEPS, istft_ola=FIR_STEPS)
    _, launches["notebook loop"] = run_path(K, "notebook loop", loop, expected)
    print(f"notebook loop ({FIR_TAPS}-tap FIR + TPUGate, Adam lr {FIR_LR}, batch {batch} x "
          f"{GRAD_SECONDS} s): losses {[f'{v:.6f}' for v in losses]}", flush=True)
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("notebook loop: the loss did not fall")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    import noisereduce_tpu_torch as nr
    from noisereduce_tpu_torch.api import _as_2d
    from noisereduce_tpu_torch.models.spectral_gate import _gate_nonstationary_staged
    from noisereduce_tpu_torch.ops.cuda import build
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.parallel.chunking import process_chunked

    t_start = time.perf_counter()
    build.load()
    print(
        f"build: {build.library_path().relative_to(HERE)} in "
        f"{time.perf_counter() - t_start:.1f} s (nvcc {build.build_seconds})",
        flush=True,
    )

    x = headline_signal(HEADLINE_SECONDS)
    noise = noise_clip(NOISE_SECONDS)
    cfg = nr.GateConfig(sr=SR)
    scfg = nr.GateConfig(sr=SR, stationary=True)
    x_cuda = torch.as_tensor(x).cuda()
    noise_cuda = torch.as_tensor(noise).cuda()
    results = kernel_phase(x_cuda, noise_cuda, cfg, scfg)
    tgate = nr.api.torch_gate_for(SR)  # the gate of reduce_noise(x, SR, use_torch=True)
    tsgate = nr.api.torch_gate_for(SR, stationary=True)
    torch_kernel_phase(x_cuda, noise_cuda, tgate, results)
    del x_cuda
    torch.cuda.empty_cache()

    golden_phase(nr)

    def nonstationary_plain(y2d_np, c, cs=CHUNK, pad=PADDING):
        y2d = torch.as_tensor(y2d_np).cuda()
        with torch.no_grad():
            return process_chunked(
                lambda v: _gate_nonstationary_staged(v, c), y2d, cs, pad)

    launches = {}
    ck = dict(chunk_size=CHUNK, padding=PADDING)  # the API's defaults

    # headline: the main path as a user calls it, numpy in and out
    out, launches["headline"] = run_path(
        K, "headline", lambda: nr.reduce_noise(x, SR, **ck),
        dict(spectra=1, nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("headline", out, x)
    ref = nonstationary_plain(_as_2d(x)[0], cfg)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"headline vs staged plain path: max|dev| {dev:.3e} bound {lim:.3e}",
          flush=True)
    if not dev <= lim:
        fail("headline disagrees with the staged plain path")
    ms = time_ms(lambda: nr.reduce_noise(x, SR, **ck))
    plain_ms = time_ms(lambda: nonstationary_plain(_as_2d(x)[0], cfg).cpu())
    print(
        f"headline {HEADLINE_SECONDS} s @ {SR} Hz: reduce_noise {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), staged "
        f"plain path {plain_ms:.1f} ms, on {card}",
        flush=True,
    )

    # stationary headline: a separate noise clip
    out, launches["stationary headline"] = run_path(
        K, "stationary headline",
        lambda: nr.reduce_noise(x, SR, stationary=True, y_noise=noise, **ck),
        dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("stationary headline", out, x)
    y2d = torch.as_tensor(x[None]).cuda()
    yn = torch.as_tensor(noise).cuda()
    stationary_vs_plain("stationary headline", out, y2d, yn, scfg, CHUNK, PADDING)
    ms = time_ms(lambda: nr.reduce_noise(x, SR, stationary=True, y_noise=noise, **ck))
    print(
        f"stationary headline {HEADLINE_SECONDS} s @ {SR} Hz with a "
        f"{NOISE_SECONDS} s noise clip: reduce_noise {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), on {card}",
        flush=True,
    )
    del y2d, out
    torch.cuda.empty_cache()

    # batch: 32 clips of 10 s, stationary, each its own noise
    clips = [x[i * BATCH_SECONDS * SR : (i + 1) * BATCH_SECONDS * SR]
             for i in range(BATCH_CLIPS)]
    outs, launches["batch"] = run_path(
        K, "batch", lambda: nr.reduce_noise_batch(clips, SR, stationary=True, **ck),
        dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    n_bitwise, dev, scale = 0, 0.0, 0.0
    for clip, o in zip(clips, outs):
        check_output("batch", o, clip)
        want = nr.reduce_noise(clip, SR, stationary=True, **ck)
        n_bitwise += int(np.array_equal(o, want))
        dev = max(dev, float(np.abs(o.astype(np.float64) - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    ms = time_ms(lambda: nr.reduce_noise_batch(clips, SR, stationary=True, **ck))
    print(
        f"batch {BATCH_CLIPS} x {BATCH_SECONDS} s @ {SR} Hz stationary, "
        f"self-noise: {n_bitwise} of {BATCH_CLIPS} outputs bitwise the "
        f"per-signal calls', max|dev| {dev:.3e} bound {E2E_BOUND * scale:.3e}; "
        f"reduce_noise_batch {ms:.1f} ms on {card}",
        flush=True,
    )
    if not dev <= E2E_BOUND * scale:
        fail("batch disagrees with the per-signal calls")

    # staged geometry: a hop that does not divide the window (row 7)
    xs = headline_signal(STAGED_SECONDS, STAGED_SR, SEED + 2)
    out, launches["staged geometry"] = run_path(
        K, "staged geometry", lambda: nr.reduce_noise(xs, STAGED_SR, **STAGED_KW, **ck),
        dict(nonstationary_mask=1))
    check_output("staged geometry", out, xs)
    c = nr.GateConfig(sr=STAGED_SR, **STAGED_KW)
    ref = nonstationary_plain(_as_2d(xs)[0], c)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"staged geometry (n_fft 1024, hop 300) vs staged plain path: max|dev| "
          f"{dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("staged geometry disagrees with the staged plain path")

    # split geometry (row 2), both engines
    xp = headline_signal(SPLIT_SECONDS, SPLIT_SR, SEED + 3)
    out, launches["split geometry"] = run_path(
        K, "split geometry", lambda: nr.reduce_noise(xp, SPLIT_SR, **SPLIT_KW, **ck),
        dict(spectra=1, nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("split geometry", out, xp)
    c = nr.GateConfig(sr=SPLIT_SR, **SPLIT_KW)
    ref = nonstationary_plain(_as_2d(xp)[0], c)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"split geometry (freq_mask_smooth_hz 2000 @ 16 kHz) vs staged plain "
          f"path: max|dev| {dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("split geometry disagrees with the staged plain path")
    out, launches["split geometry, stationary"] = run_path(
        K, "split geometry, stationary",
        lambda: nr.reduce_noise(xp, SPLIT_SR, stationary=True, **SPLIT_KW, **ck),
        dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("split geometry, stationary", out, xp)
    yp = torch.as_tensor(xp[None]).cuda()
    stationary_vs_plain("split geometry, stationary", out, yp, yp[0],
                        nr.GateConfig(sr=SPLIT_SR, stationary=True, **SPLIT_KW),
                        CHUNK, PADDING)

    # torch headline: reduce_noise(use_torch=True), kernels A, F, C, D
    xt = torch.as_tensor(x[None]).cuda()
    out, launches["torch headline"] = run_path(
        K, "torch headline", lambda: nr.reduce_noise(x, SR, use_torch=True, **ck),
        dict(spectra=1, torch_nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("torch headline", out, x)
    ref = torch_staged(xt, tgate, CHUNK, PADDING)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"torch headline vs staged plain path: max|dev| {dev:.3e} bound {lim:.3e}",
          flush=True)
    if not dev <= lim:
        fail("torch headline disagrees with the staged plain path")
    ms = time_ms(lambda: nr.reduce_noise(x, SR, use_torch=True, **ck))
    plain_ms = time_ms(lambda: torch_staged(torch.as_tensor(x[None]).cuda(), tgate, CHUNK,
                                            PADDING).cpu())
    print(
        f"torch headline {HEADLINE_SECONDS} s @ {SR} Hz: reduce_noise(use_torch=True) "
        f"{ms:.1f} ms ({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), staged "
        f"plain path {plain_ms:.1f} ms, on {card}",
        flush=True,
    )
    del out, ref
    torch.cuda.empty_cache()

    # torch stationary headline: the 10 s noise clip
    out, launches["torch stationary headline"] = run_path(
        K, "torch stationary headline",
        lambda: nr.reduce_noise(x, SR, stationary=True, use_torch=True, y_noise=noise, **ck),
        dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("torch stationary headline", out, x)
    torch_stationary_vs_plain("torch stationary headline", out, xt,
                              torch.as_tensor(noise[None]).cuda(), tsgate, CHUNK, PADDING)
    ms = time_ms(lambda: nr.reduce_noise(x, SR, stationary=True, use_torch=True,
                                         y_noise=noise, **ck))
    print(
        f"torch stationary headline {HEADLINE_SECONDS} s @ {SR} Hz with a "
        f"{NOISE_SECONDS} s noise clip: reduce_noise(use_torch=True) {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), on {card}",
        flush=True,
    )
    del xt, out
    torch.cuda.empty_cache()

    # torch batch: 32 clips of 10 s, stationary, each view its own statistics
    tk = dict(stationary=True, use_torch=True, **ck)
    outs, launches["torch batch"] = run_path(
        K, "torch batch", lambda: nr.reduce_noise_batch(clips, SR, **tk),
        dict(spectra=1, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    n_bitwise = 0
    for clip, o in zip(clips, outs):
        check_output("torch batch", o, clip)
        n_bitwise += int(np.array_equal(o, nr.reduce_noise(clip, SR, **tk)))
    torch_stationary_vs_plain("torch batch", np.stack(outs), torch.as_tensor(np.stack(clips)).cuda(),
                              None, tsgate, CHUNK, PADDING)
    ms = time_ms(lambda: nr.reduce_noise_batch(clips, SR, **tk))
    print(
        f"torch batch {BATCH_CLIPS} x {BATCH_SECONDS} s @ {SR} Hz stationary, "
        f"self statistics: {n_bitwise} of {BATCH_CLIPS} outputs bitwise the "
        f"per-signal calls'; reduce_noise_batch(use_torch=True) {ms:.1f} ms on {card}",
        flush=True,
    )
    if n_bitwise != BATCH_CLIPS:
        fail("torch batch differs from the per-signal calls")

    # torch staged geometry: the plain STFT and iSTFT around F and C
    out, launches["torch staged geometry"] = run_path(
        K, "torch staged geometry",
        lambda: nr.reduce_noise(xs, STAGED_SR, use_torch=True, **STAGED_KW, **ck),
        dict(torch_nonstationary_mask=1, freq_smooth_blend=1))
    check_output("torch staged geometry", out, xs)
    ref = torch_staged(torch.as_tensor(xs[None]).cuda(),
                       nr.api.torch_gate_for(STAGED_SR, **STAGED_KW), CHUNK,
                       PADDING)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"torch staged geometry (n_fft 1024, hop 300) vs staged plain path: "
          f"max|dev| {dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("torch staged geometry disagrees with the staged plain path")

    # product route: n_fft 1536 on the first 60 s of the headline signal
    xq = x[: PRODUCT_SECONDS * SR]
    out, launches["product route geometry"] = run_path(
        K, "product route geometry", lambda: nr.reduce_noise(xq, SR, **PRODUCT_KW, **ck),
        dict(spectra=1, nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1),
        route="product")
    check_output("product route geometry", out, xq)
    c = nr.GateConfig(sr=SR, **PRODUCT_KW)
    ref = nonstationary_plain(_as_2d(xq)[0], c)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"product route geometry (n_fft 1536, hop 384, {PRODUCT_SECONDS} s) vs staged "
          f"plain path: max|dev| {dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("product route geometry disagrees with the staged plain path")
    product_kernel_phase(torch.as_tensor(xq).cuda(), c, results)

    gradient_phase(nr, K, card, launches)

    main_path = {name: "headline" for name in SOURCES}
    main_path.update(stationary_mask="stationary headline",
                     torch_nonstationary_mask="torch headline",
                     fm_nonstationary_mask="row 6 mask under grad",
                     spectra_product="product route geometry",
                     istft_ola_product="product route geometry")

    def count(name, path):
        if name in ROUTED:
            kernel, route = ROUTED[name]
            return ROUTES[path][kernel][route]
        return launches[path][name]

    kernels = [
        dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=count(name, main_path[name]),
            launches_by_path={p: count(name, p) for p in launches},
            **results[name],
        )
        for name in SOURCES
    ]
    print(f"all phases in {time.perf_counter() - t_start:.0f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
