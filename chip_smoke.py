#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero, and the last
line is printed only when every phase passed):

1. environment: torch version, the card's name and power limit
   (``nvidia-smi``); TF32 off, so the plain versions run in full FP32;
2. build: kernels A-D from ``noisereduce_tpu_torch/ops/cuda/csrc`` with
   ``nvcc`` (seconds printed);
3. per kernel, at the headline shapes (77 halo'd 660,000-sample chunk views
   of 48 kHz audio): the kernel against its plain version on the same
   inputs, max |dev| against the bound below, and both times;
4. golden: ``reduce_noise(..., device="cuda")`` in float32 on
   ``tests/golden/golden_v1.npz`` (44.1 kHz), unchunked and chunk 8000 /
   padding 1500, against the reference outputs;
5. headline: 960 s of 48 kHz mono (tones plus non-stationary noise, from a
   seed) through ``reduce_noise`` with its defaults, against the port's
   staged plain path on the card; every kernel must have launched on that
   run; wall time as the minimum of 3 runs after a warm-up (CUDA events);
6. one JSON line of per-kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

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

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SR = 48000
HEADLINE_SECONDS = 960
CHUNK, PADDING = 600000, 30000
# float32 agreement bounds, each with its reason
BOUNDS = {
    # 1024-term FP32 sums in another order than cuFFT: x max|ref|
    "spectra": 2e-5,
    # mask units (the mask is in [0, 1]); FMA vs separate rounding in the
    # IIR, amplified by the sigmoid slope of 10: absolute
    "nonstationary_mask": 1e-4,
    # 2n+1 = 11 FMAs of values <= 1: absolute
    "freq_smooth_blend": 1e-6,
    # 4 * 2 * 513-term FP32 sums vs cuFFT's irfft + fold: x max|ref|
    "istft_ola": 2e-5,
}
RELATIVE = {"spectra", "istft_ola"}
# end to end, as tests/test_fused_pipeline.py:55 holds the TPU kernel: x max|ref|
E2E_BOUND = 5e-5
SOURCES = {
    "spectra": "noisereduce_tpu_torch/ops/cuda/csrc/spectra.cu",
    "nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/nonstationary_mask.cu",
    "freq_smooth_blend": "noisereduce_tpu_torch/ops/cuda/csrc/freq_smooth_blend.cu",
    "istft_ola": "noisereduce_tpu_torch/ops/cuda/csrc/istft_ola.cu",
}
REPLACES = {
    "spectra": "noisereduce_tpu/ops/pallas/kernels.py:152",
    "nonstationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:422",
    "freq_smooth_blend": "noisereduce_tpu/ops/pallas/kernels.py:906",
    "istft_ola": "noisereduce_tpu/ops/pallas/kernels.py:736",
}


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


def max_dev(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max()), float(ref.abs().max())


def kernel_phase(x_cuda: torch.Tensor, cfg):
    """Each kernel against its plain version at the main path's shapes."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.dsp import tri_norm

    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    ngf, ngt = cfg.smoothing
    tt, tf = tri_norm(ngt), tri_norm(ngf)
    results = {}

    def record(name, fn, ref_fn, got, ref):
        dev, scale = max_dev(got, ref)
        bound = BOUNDS[name] * (scale if name in RELATIVE else 1.0)
        finite = bool(torch.isfinite(got).all())
        ms = time_ms(fn)
        plain_ms = time_ms(ref_fn)
        print(
            f"kernel {name}: max|dev| {dev:.3e} bound {bound:.3e} "
            f"(max|ref| {scale:.4g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms",
            flush=True,
        )
        if not finite or not dev <= bound:
            fail(f"kernel {name} disagrees with its plain version")
        results[name] = dict(max_abs_err=dev, ms=ms, plain_ms=plain_ms)

    a = (x_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    rre, rim = K.spectra_ref(*a)
    torch.cuda.synchronize()
    record(
        "spectra", lambda: K.spectra(*a), lambda: K.spectra_ref(*a),
        torch.stack([re, im]), torch.stack([rre, rim]),
    )
    del rre, rim

    b = (re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
         cfg.sigmoid_slope_nonstationary, tt)
    m = K.nonstationary_mask(*b)
    rm = K.nonstationary_mask_ref(*b)
    record("nonstationary_mask", lambda: K.nonstationary_mask(*b),
           lambda: K.nonstationary_mask_ref(*b), m, rm)
    del rm

    c = (m, tf, cfg.prop_decrease)
    mb = K.freq_smooth_blend(*c)
    rmb = K.freq_smooth_blend_ref(*c)
    record("freq_smooth_blend", lambda: K.freq_smooth_blend(*c),
           lambda: K.freq_smooth_blend_ref(*c), mb, rmb)
    del rmb

    d = (re, im, mb, geo, PADDING, CHUNK)
    y = K.istft_ola(*d)
    ry = K.istft_ola_ref(*d)
    record("istft_ola", lambda: K.istft_ola(*d), lambda: K.istft_ola_ref(*d),
           y, ry)
    return results


def golden_phase(nr) -> None:
    data = np.load(os.path.join(HERE, "tests", "golden", "golden_v1.npz"))
    with open(os.path.join(HERE, "tests", "golden", "golden_v1.json")) as f:
        sr = json.load(f)["sr"]
    y = data["y_mono"]
    for name, kw in (
        ("nonstationary", {}),
        ("nonstationary_chunked", dict(chunk_size=8000, padding=1500)),
    ):
        out = nr.reduce_noise(y, sr, device="cuda", **kw)
        ref = data[f"out_{name}"]
        dev = float(np.abs(out.astype(np.float64) - ref).max())
        bound = E2E_BOUND * float(np.abs(ref).max())
        print(f"golden {name}: max|dev| {dev:.3e} bound {bound:.3e}", flush=True)
        if out.shape != ref.shape or out.dtype != ref.dtype or not dev <= bound:
            fail(f"golden {name}")


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

    t0 = time.perf_counter()
    build.load()
    print(
        f"build: {build.library_path().relative_to(HERE)} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds})",
        flush=True,
    )

    x = headline_signal(HEADLINE_SECONDS)
    cfg = nr.GateConfig(sr=SR)
    x_cuda = torch.as_tensor(x).cuda()
    results = kernel_phase(x_cuda, cfg)

    golden_phase(nr)

    # headline: the main path as a user calls it, numpy in and out
    K.reset_launch_counts()
    out = nr.reduce_noise(x, SR)
    launches = K.launch_counts()
    print(f"headline launches: {launches}", flush=True)
    if out.shape != x.shape or out.dtype != x.dtype:
        fail("headline output shape/dtype")
    if not np.isfinite(out).all():
        fail("headline output not finite")
    if min(launches.values()) < 1:
        fail("a kernel of the main path did not launch")

    def plain_path():
        y2d = torch.as_tensor(_as_2d(x)[0]).cuda()
        with torch.no_grad():
            return process_chunked(
                lambda c: _gate_nonstationary_staged(c, cfg), y2d, CHUNK, PADDING
            )

    ref = plain_path()[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    bound = E2E_BOUND * float(np.abs(ref).max())
    print(f"headline vs staged plain path: max|dev| {dev:.3e} bound {bound:.3e}",
          flush=True)
    if not dev <= bound:
        fail("headline disagrees with the staged plain path")

    ms = time_ms(lambda: nr.reduce_noise(x, SR))
    plain_ms = time_ms(lambda: plain_path().cpu())
    print(
        f"headline {HEADLINE_SECONDS} s @ {SR} Hz: reduce_noise {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), staged "
        f"plain path {plain_ms:.1f} ms, on {card}",
        flush=True,
    )

    kernels = [
        dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name], **results[name],
        )
        for name in SOURCES
    ]
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
