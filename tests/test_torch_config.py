"""PyTorch port: configuration parity, import isolation and the API's
device and argument errors.

The port's config is its own copy (the JAX package's config module imports
JAX through its package ``__init__``); these tests pin the copy to the JAX
one.
"""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from noisereduce_tpu.config import GateConfig as JGateConfig
from noisereduce_tpu.config import StftConfig as JStftConfig
from noisereduce_tpu.config import smoothing_kernel_sizes as j_sizes

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig, StftConfig, smoothing_kernel_sizes
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry, kernels_supported
from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

torch.set_num_threads(2)

GEOMS = [
    dict(n_fft=1024),
    dict(n_fft=512, hop_length=128),
    dict(n_fft=2048, win_length=1024, hop_length=256),
    dict(n_fft=1024, hop_length=300),
]


@pytest.mark.parametrize("kw", GEOMS, ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("n", [1, 255, 8000, 30001])
def test_stft_geometry_matches_jax(kw, n):
    a, b = StftConfig(**kw), JStftConfig(**kw)
    assert (a.n_bins, a.frame_length, a.boundary_pad) == (
        b.n_bins, b.frame_length, b.boundary_pad)
    assert a.n_frames(n) == b.n_frames(n)
    assert a.istft_length(a.n_frames(n)) == b.istft_length(b.n_frames(n))


@pytest.mark.parametrize("sr", [8000, 16000, 44100, 48000])
@pytest.mark.parametrize("kw", [
    {}, dict(time_constant_s=0.5), dict(n_fft=512, hop_length=128),
    dict(freq_mask_smooth_hz=None), dict(time_mask_smooth_ms=None),
    dict(freq_mask_smooth_hz=None, time_mask_smooth_ms=None),
], ids=["default", "tc0.5", "nfft512", "no-freq", "no-time", "no-smoothing"])
def test_gate_config_matches_jax(sr, kw):
    a, b = GateConfig(sr=sr, **kw), JGateConfig(sr=sr, **kw)
    assert a.smoothing == b.smoothing
    assert a.iir_b == b.iir_b
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_from_fields_round_trips_a_jax_config():
    j = JGateConfig(sr=16000, prop_decrease=0.7, n_fft=512, hop_length=128,
                    thresh_n_mult_nonstationary=1.5)
    p = GateConfig.from_fields(dataclasses.asdict(j))
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert (p.smoothing, p.iir_b, p.stft.n_bins) == (j.smoothing, j.iir_b, j.stft.n_bins)
    with pytest.raises(ValueError, match="unknown GateConfig fields"):
        GateConfig.from_fields({**dataclasses.asdict(j), "bogus": 1})


@pytest.mark.parametrize("args", [
    (8000, 1024, 256, 5, 50),     # freq too narrow
    (44100, 1024, 256, 500, 1),   # time too short
])
def test_smoothing_value_errors_match_jax(args):
    with pytest.raises(ValueError) as ours:
        smoothing_kernel_sizes(*args)
    with pytest.raises(ValueError) as theirs:
        j_sizes(*args)
    assert str(ours.value) == str(theirs.value)


def test_win_longer_than_nfft_raises():
    with pytest.raises(ValueError, match="win_length must be <= n_fft"):
        StftConfig(n_fft=512, win_length=1024)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, noisereduce_tpu_torch\n"
        "import noisereduce_tpu_torch.ops.cuda.dispatch\n"
        "import noisereduce_tpu_torch.ops.cuda.torch_dispatch\n"
        "import noisereduce_tpu_torch.models.tpu_gate\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'noisereduce_tpu' or m.startswith('noisereduce_tpu.')]\n"
        "assert not bad, bad\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_kernel_geometry_predicate():
    assert kernels_supported(StftConfig(n_fft=1024))
    assert kernels_supported(StftConfig(n_fft=2048, win_length=1024, hop_length=256))
    assert not kernels_supported(StftConfig(n_fft=1024, hop_length=300))
    # the torch convention: the hop must divide n_fft, the analysis frame
    assert kernels_supported(StftConfig(convention="torch", quantize_window_f32=True))
    assert kernels_supported(StftConfig(n_fft=2048, win_length=1024, convention="torch"))
    assert not kernels_supported(StftConfig(n_fft=1024, hop_length=300, convention="torch"))
    with pytest.raises(NotImplementedError, match="hop that divides"):
        gate_geometry(StftConfig(n_fft=1024, hop_length=300), 8000)


@pytest.mark.parametrize("out_off,out_len", [(0, 8000), (1500, 8000), (0, 1), (7999, 5)])
def test_out_blocks_cover_the_window(out_off, out_len):
    geo = gate_geometry(StftConfig(n_fft=1024), 11000)
    j0, n_out = geo.out_blocks(out_off, out_len)
    lo, hi = geo.bpad + out_off, geo.bpad + out_off + out_len
    assert j0 * geo.hop <= lo and (j0 + n_out) * geo.hop >= hi
    assert (j0 + 1) * geo.hop > lo and (j0 + n_out - 1) * geo.hop < hi


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    y = np.zeros(4000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrt.reduce_noise(y, 16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrt.reduce_noise(y, 16000, device="cuda:0")


@pytest.mark.parametrize("kw,err", [
    # bfloat16 is ported (tests/test_torch_bf16.py); float16 is not
    (dict(stationary=True, compute_dtype=torch.float16), NotImplementedError),
    (dict(use_torch=True, compute_dtype=torch.float16), NotImplementedError),
    (dict(mesh=object()), TypeError),  # a mesh is a ChunkMesh; use_tqdm=True is ported
    (dict(compute_dtype=torch.float16), NotImplementedError),
    (dict(freq_mask_smooth_hz=5), ValueError),
])
def test_unported_and_invalid_arguments_raise(kw, err):
    with pytest.raises(err):
        nrt.reduce_noise(np.zeros(4000), 16000, device="cpu", **kw)


def test_mesh_of_cpu_devices_is_the_unsharded_call():
    """A ``ChunkMesh`` is taken where another object raises: on 3 CPU
    devices, 5 chunks give the unsharded output bitwise."""
    y = np.random.default_rng(1).standard_normal(20000)
    kw = dict(device="cpu", chunk_size=4000, padding=700)
    mesh = ChunkMesh((torch.device("cpu"),) * 3)
    assert np.array_equal(nrt.reduce_noise(y, 16000, mesh=mesh, **kw),
                          nrt.reduce_noise(y, 16000, **kw))


def test_three_dim_input_raises():
    with pytest.raises(ValueError, match="Waveform must be in shape"):
        nrt.reduce_noise(np.zeros((2, 2, 4000)), 16000, device="cpu")


def test_launch_counters_stay_zero_on_cpu():
    K.reset_launch_counts()
    y = np.random.default_rng(0).standard_normal(20000)
    nrt.reduce_noise(y, 16000, device="cpu", chunk_size=8000, padding=1500)
    nrt.reduce_noise(y, 16000, device="cpu")
    nrt.reduce_noise(y, 16000, device="cpu", stationary=True)
    nrt.reduce_noise(y, 16000, device="cpu", use_torch=True)
    nrt.reduce_noise(y, 16000, device="cpu", use_torch=True, stationary=True)
    assert K.launch_counts() == {
        "spectra": 0, "nonstationary_mask": 0, "freq_smooth_blend": 0,
        "istft_ola": 0, "stationary_mask": 0, "torch_nonstationary_mask": 0,
        "fm_nonstationary_mask": 0, "output_cast": 0,
    }


def test_build_lists_the_sources_and_needs_nvcc(monkeypatch, tmp_path):
    from noisereduce_tpu_torch.ops.cuda import build

    names = {p.name for p in build.sources()}
    assert {"spectra_fft.cu", "nonstationary_mask.cu", "freq_smooth_blend.cu",
            "istft_fft.cu", "stationary_mask.cu", "torch_nonstationary_mask.cu",
            "fm_nonstationary_mask.cu", "fft_smem.cuh"} <= names
    # the retired DFT-product route's sources are gone
    assert not {"spectra.cu", "istft_ola.cu", "gemm_tile.cuh"} & names
    assert build.library_path().parent.parent == build.BUILD_ROOT
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


@pytest.mark.parametrize("fails", [False, True], ids=["builds", "reports-failure"])
def test_build_compiles_each_source_side_by_side_then_links(monkeypatch, tmp_path, fails):
    """One nvcc process per .cu source, then one link; a failing compile
    raises with nvcc's output (a stand-in nvcc records its arguments)."""
    from noisereduce_tpu_torch.ops.cuda import build

    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        + ('case "$*" in *stationary_mask.cu*) echo broken >&2; exit 3;; esac\n'
           if fails else "")
        + 'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    out = tmp_path / "build" / "libnrtorch.so"
    if fails:
        with pytest.raises(RuntimeError, match="(?s)nvcc failed \\(3\\).*broken"):
            build._compile(out)
        assert not out.exists()
        return
    build._compile(out)
    calls = log.read_text().splitlines()
    compiled = sorted(c.split()[-1].rsplit("/", 1)[-1] for c in calls if " -c " in c)
    assert compiled == sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert "-shared" in calls[-1] and len(calls) == len(compiled) + 1
    assert out.exists()
