"""PyTorch port: the command line ``python -m noisereduce_tpu_torch in.wav
out.wav`` against ``reduce_noise_file`` and the JAX package's CLI (CPU,
``--device cpu``), and the slice's independence from JAX.

Outputs are held to ``reduce_noise_file`` with the same arguments exactly
(the CLI wraps it), and to the JAX package's CLI within atol 2e-6, the
JAX streaming tests' envelope (``tests/test_streaming.py:43``).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from noisereduce_tpu.__main__ import build_parser as jax_build_parser
from noisereduce_tpu.__main__ import main as jax_main
from noisereduce_tpu.utils import io as jio

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.__main__ import build_parser, main
from noisereduce_tpu_torch.utils import io as nrio

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
SMALL = ["--chunk-size", "8000", "--padding", "1000"]  # 4 chunks of the 2 s clip


@pytest.fixture(scope="module")
def noisy_wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    t = np.arange(SR * 2) / SR
    y = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    src, noise = str(d / "in.wav"), str(d / "noise.wav")
    nrio.write_wav(src, y, SR)  # PCM16, as recordings are
    nrio.write_wav(noise, 0.1 * rng.standard_normal(SR).astype(np.float32), SR, as_float=True)
    return src, noise


def _read(path, dtype="float32"):
    return nrio.read_wav(path, dtype=dtype)[1]


@pytest.mark.parametrize("flags,kw", [
    ([], {}),
    (["--stationary"], dict(stationary=True)),
    (["--stationary", "--no-clip-noise"], dict(stationary=True, clip_noise_stationary=False)),
    (["--torch-convention"], dict(use_torch=True)),
    (["--n-fft", "512", "--prop-decrease", "0.8"], dict(n_fft=512, prop_decrease=0.8)),
], ids=["nonstationary", "stationary", "whole-file", "torch", "options"])
def test_cli_matches_reduce_noise_file_and_the_jax_cli(noisy_wav, tmp_path, flags, kw):
    src, _ = noisy_wav
    out, ref, jref = (str(tmp_path / f) for f in ("out.wav", "ref.wav", "jref.wav"))
    assert main([src, out, "--quiet", "--float", "--device", "cpu", *SMALL, *flags]) == 0
    nrt.reduce_noise_file(src, ref, as_float=True, device="cpu", chunk_size=8000,
                          padding=1000, **kw)
    np.testing.assert_array_equal(_read(out), _read(ref))
    assert jax_main([src, jref, "--quiet", "--float", *SMALL, *flags]) == 0
    np.testing.assert_allclose(_read(out), jio.read_wav(jref, dtype="float32")[1], atol=2e-6)


def test_cli_noise_clip_implies_stationary(noisy_wav, tmp_path, capsys):
    src, noise = noisy_wav
    out, ref = str(tmp_path / "out.wav"), str(tmp_path / "ref.wav")
    assert main([src, out, "--noise", noise, "--float", "--device", "cpu", *SMALL]) == 0
    err = capsys.readouterr().err
    assert "implies --stationary" in err
    assert "x real-time" in err and "32000 frames" in err  # the summary line
    nrt.reduce_noise_file(src, ref, stationary=True, y_noise=_read(noise), as_float=True,
                          device="cpu", chunk_size=8000, padding=1000)
    np.testing.assert_array_equal(_read(out), _read(ref))


def test_cli_pcm16_output_by_default(noisy_wav, tmp_path):
    src, _ = noisy_wav
    out, ref = str(tmp_path / "out16.wav"), str(tmp_path / "ref16.wav")
    assert main([src, out, "--quiet", "--device", "cpu", *SMALL]) == 0
    nrt.reduce_noise_file(src, ref, device="cpu", chunk_size=8000, padding=1000)
    got = _read(out, "int16")
    assert got.dtype == np.int16 and got.shape == (2 * SR,)
    np.testing.assert_array_equal(got, _read(ref, "int16"))


def test_cli_parser_matches_the_jax_cli():
    """The JAX CLI's flags and defaults (the reference's reduce_noise
    defaults, noisereduce.py:13-36), plus --device, cuda by default."""
    ours = vars(build_parser().parse_args(["i.wav", "o.wav"]))
    theirs = vars(jax_build_parser().parse_args(["i.wav", "o.wav"]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert (ours["chunk_size"], ours["padding"], ours["n_fft"]) == (600000, 30000, 1024)


def test_cli_runs_on_the_card_by_default(noisy_wav, tmp_path, monkeypatch):
    """Without --device the CLI asks for CUDA, and raises where it is
    absent rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([noisy_wav[0], str(tmp_path / "o.wav"), "--quiet", *SMALL])


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT)}


def test_cli_end_to_end_in_a_subprocess(noisy_wav, tmp_path):
    src, _ = noisy_wav
    out, ref = str(tmp_path / "cli_out.wav"), str(tmp_path / "ref.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "noisereduce_tpu_torch", src, out, "--device", "cpu",
         "--stationary", "--no-clip-noise", "--progress", "--float", *SMALL],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=_env(),
    )
    assert proc.returncode == 0, proc.stderr
    assert "real-time" in proc.stderr
    nrt.reduce_noise_file(src, ref, stationary=True, clip_noise_stationary=False,
                          as_float=True, device="cpu", chunk_size=8000, padding=1000)
    np.testing.assert_array_equal(_read(out), _read(ref))


def test_the_slice_imports_no_jax(noisy_wav, tmp_path):
    """The package, its streaming module and its CLI, run end to end, load
    no module of JAX or of the JAX package."""
    src, _ = noisy_wav
    code = (
        "import sys\n"
        "import noisereduce_tpu_torch, noisereduce_tpu_torch.streaming\n"
        "from noisereduce_tpu_torch.__main__ import main\n"
        f"assert main([{src!r}, {str(tmp_path / 'o.wav')!r}, '--quiet', '--device', 'cpu',"
        " '--chunk-size', '8000', '--padding', '1000']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'noisereduce_tpu')]\n"
        "print(len(bad), bad[:5])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT), env=_env())
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[0] == "0", proc.stdout
    assert (tmp_path / "o.wav").stat().st_size == 44 + 2 * 2 * SR
