"""PyTorch port on a CUDA card: each kernel against its plain version, and
``reduce_noise`` on the card against the CPU parity mode.

Every test here is marked ``gpu`` and skips without a card. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; there, skip the repository's conftest (it configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Float32 bounds, as chip_smoke.py states them: spectra and istft_ola 2e-5 x
max|ref| (long FP32 sums in another order than cuFFT), the mask 1e-4
absolute (sigmoid slope 10 over an IIR floor), the frequency smoothing
1e-6 absolute, end to end 5e-5 x max|ref|.
"""
import numpy as np
import pytest
import torch

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig, StftConfig
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
from noisereduce_tpu_torch.ops.dsp import tri_norm

torch.set_num_threads(2)

GEOMS = [dict(n_fft=1024, hop_length=256), dict(n_fft=512, hop_length=128),
         dict(n_fft=2048, win_length=1024, hop_length=256)]
GEOM_IDS = ["nfft1024", "nfft512", "nfft2048-win1024"]


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
    assert set(K.launch_counts().values()) == {1}


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(chunk_size=8000, padding=1500)],
                         ids=["unchunked", "chunked"])
def test_reduce_noise_on_card_matches_cpu_parity_mode(cuda, kw):
    y = np.random.default_rng(7).standard_normal((2, 30000))
    K.reset_launch_counts()
    got = nrt.reduce_noise(y, 16000, **kw)
    assert min(K.launch_counts().values()) >= 1
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
