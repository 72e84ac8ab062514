"""PyTorch port: ``reduce_noise`` at n_fft values beyond the powers of two,
against the JAX package's ``reduce_noise`` (CPU, float64): the
scipy-convention non-stationary and stationary engines and the TorchGate
engine (``use_torch=True``), on a 2 s signal, whole and chunked. Kernels A
and D take the FFT route at 1536 (2 x 768, 768 = 2^8 x 3), 400 (2 x 200,
200 = 2^3 x 5^2), 1100 (2 x 550, 550 = 2 x 5^2 x 11: radix 11) and the odd
441 (3^2 x 7^2, two frames a transform) and at 1102 (2 x 551, 551 = 19 x
29: the radix-19 and -29 stages); the chirp-z route at the odd 1101 (3 x
367); the global chirp route at the odd 40005 (3^2 x 5 x 7 x 127, past
32,768 points). The JAX package takes DFT products at every n_fft on its
TPU and ``jnp.fft`` on the CPU.

On the CPU the port runs the kernels' plain versions; the route's own
arithmetic is emulated by tests/test_torch_fft.py and held on a card by
tests/test_torch_cuda.py. Bound: 1e-9 x max|ref| (float64), and 1e-8 x for
``use_torch=True``, whose kernels smooth with the rank-1 SVD factors of
TorchGate's float32-rounded kernel where the JAX staged path takes every
rank (tests/test_torch_torchgate_api.py).
"""
import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import StftConfig
from noisereduce_tpu_torch.ops.cuda.geometry import fft_route

torch.set_num_threads(2)

F64_TOL, RANK1_TOL = 1e-9, 1e-8
# name: (sample rate, STFT arguments, the route of kernels A and D)
GEOMS = {"nfft1536-48k": (48000, dict(n_fft=1536, hop_length=384), "fft"),
         "nfft400-16k": (16000, dict(n_fft=400, hop_length=100), "fft"),
         "nfft441-44k": (44100, dict(n_fft=441, hop_length=147), "fft"),
         "nfft1102-44k": (44100, dict(n_fft=1102, hop_length=551), "fft"),
         "nfft1101-44k": (44100, dict(n_fft=1101, hop_length=367), "chirp"),
         "nfft1100-48k": (48000, dict(n_fft=1100, hop_length=275), "fft"),
         # 0.83 s frames: n = 40005 = 3^2 5 7 127 past 32,768 points, L =
         # 81,000 on the global chirp route; a hop of 167 ms takes 500 ms of
         # time smoothing (at least one hop)
         "nfft40005-48k": (48000, dict(n_fft=40005, hop_length=8001, time_mask_smooth_ms=500),
                           "global_chirp")}
ENGINES = {"nonstationary": {}, "stationary": dict(stationary=True),
           "use_torch": dict(use_torch=True)}


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("engine", ENGINES, ids=ENGINES.keys())
@pytest.mark.parametrize("geom", GEOMS, ids=GEOMS.keys())
def test_reduce_noise_matches_jax(geom, engine, chunked):
    sr, kw, route = GEOMS[geom]
    assert fft_route(StftConfig(n_fft=kw["n_fft"], hop_length=kw["hop_length"])) == route
    rng = np.random.default_rng(60)
    t = np.arange(2 * sr) / sr
    y = np.sin(2 * np.pi * 440 * t) * (t % 1 < 0.5) + 0.3 * rng.standard_normal(t.size)
    kw = dict(kw, **ENGINES[engine])
    if chunked:  # chunks of at least two frames (TorchGate's least input)
        kw.update(chunk_size=max(sr // 2, 2 * kw["n_fft"]), padding=max(sr // 8, kw["n_fft"] // 4))
    got = nrt.reduce_noise(y, sr, device="cpu", compute_dtype=torch.float64, **kw)
    ref = np.asarray(jnr.reduce_noise(y, sr, **kw))
    assert got.shape == ref.shape == y.shape and got.dtype == ref.dtype
    tol = RANK1_TOL if engine == "use_torch" else F64_TOL
    dev, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert dev <= tol * scale, f"rel dev {dev / scale:.3e}"
