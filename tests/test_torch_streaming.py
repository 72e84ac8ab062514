"""PyTorch port: ``reduce_noise_file`` against the JAX package's and against
the port's own in-memory ``reduce_noise`` (CPU, ``device="cpu"``: the
kernels' plain versions, float32 as the JAX streaming path is).

The file: 16 kHz, 21,200 frames, ``chunk_size`` 4000 and ``padding`` 1000
(6 chunks, the last short), mono and stereo, IEEE float and PCM16 sources.
Tolerances, each the JAX streaming tests' own envelope:

- float output against the JAX package's file output and against the
  port's in-memory call: atol 2e-6 (``tests/test_streaming.py:43``), the
  whole-recording statistics included;
- the streamed whole-recording threshold against the JAX package's and the
  in-memory one: atol 1e-4, rtol 1e-5 (``tests/test_streaming.py:110``);
- PCM16 output against the JAX package's: within one LSB (its float input
  differs in the last bits); against the host quantize of the port's own
  float output: exact.
"""
import numpy as np
import pytest
import torch

import noisereduce_tpu.streaming as jst
from noisereduce_tpu.config import Convention as JConvention
from noisereduce_tpu.config import GateConfig as JGateConfig
from noisereduce_tpu.streaming import reduce_noise_file as jax_file
from noisereduce_tpu.utils import io as jio

import noisereduce_tpu_torch as nrt
import noisereduce_tpu_torch.streaming as st
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
from noisereduce_tpu_torch.parallel.mesh import ChunkMesh
from noisereduce_tpu_torch.utils import io as nrio

torch.set_num_threads(2)

SR, N = 16000, 21200
CK = dict(chunk_size=4000, padding=1000)
ATOL = 2e-6
_rng = np.random.default_rng(3)
_t = np.arange(N) / SR
MONO = (0.4 * np.sin(2 * np.pi * 440 * _t) + 0.1 * _rng.standard_normal(N)).astype(np.float32)
STEREO = np.stack([
    MONO, (0.3 * np.sin(2 * np.pi * 660 * _t) + 0.1 * _rng.standard_normal(N)).astype(np.float32),
])
NOISE = (0.1 * _rng.standard_normal(6000)).astype(np.float32)
ENGINES = {
    "nonstationary": dict(),
    "stationary-first-chunk": dict(stationary=True),
    "stationary-clip": dict(stationary=True, y_noise=NOISE),
    "stationary-stereo-clip": dict(stationary=True, y_noise=np.stack([NOISE, NOISE[::-1]])),
    "stationary-whole-file": dict(stationary=True, clip_noise_stationary=False),
    "torch": dict(use_torch=True),
    "torch-stationary": dict(use_torch=True, stationary=True),
    "torch-stationary-clip": dict(use_torch=True, stationary=True, y_noise=NOISE),
}
SOURCES = {"mono-float": (MONO, True), "mono-pcm16": (MONO, False),
           "stereo-float": (STEREO.T, True)}


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = {}
    for name, (data, as_float) in SOURCES.items():
        paths[name] = str(d / f"{name}.wav")
        nrio.write_wav(paths[name], data, SR, as_float=as_float)
    return paths


def _read(path, dtype="float32"):
    return nrio.read_wav(path, dtype=dtype)[1]


def _in_memory(path, **kw):
    """The port's reduce_noise on the samples the file holds, (frames[,
    channels]) as the file reads."""
    x = _read(path)
    return nrt.reduce_noise(x.T if x.ndim == 2 else x, SR, device="cpu", **kw).T


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_file_matches_jax_and_in_memory(tmp_path, wavs, engine, source):
    kw = dict(CK, **ENGINES[engine])
    out, ref = str(tmp_path / "out.wav"), str(tmp_path / "ref.wav")
    assert nrt.reduce_noise_file(wavs[source], out, as_float=True, device="cpu", **kw) == N
    jax_file(wavs[source], ref, as_float=True, **kw)
    got, want = _read(out), jio.read_wav(ref, dtype="float32")[1]
    assert got.shape == want.shape == _read(wavs[source]).shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, _in_memory(wavs[source], **kw), atol=ATOL)


@pytest.mark.parametrize("engine", ["nonstationary", "stationary-first-chunk", "torch"])
@pytest.mark.parametrize("source", ["mono-pcm16", "stereo-float"])
def test_pcm16_output(tmp_path, wavs, engine, source):
    """The device's trunc(clamp(x * 32767)) is the host writer's quantize of
    the float output exactly, and within one LSB of the JAX package's."""
    kw = dict(CK, **ENGINES[engine])
    p16, pf, pj = (str(tmp_path / f) for f in ("o16.wav", "of.wav", "oj.wav"))
    nrt.reduce_noise_file(wavs[source], p16, device="cpu", **kw)
    nrt.reduce_noise_file(wavs[source], pf, as_float=True, device="cpu", **kw)
    jax_file(wavs[source], pj, **kw)
    got = _read(p16, "int16")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(
        got, np.clip(_read(pf) * 32767.0, -32768, 32767).astype(np.int16))
    assert np.abs(got.astype(np.int32) - jio.read_wav(pj, dtype="int16")[1]).max() <= 1


@pytest.mark.parametrize("engine", list(ENGINES))
def test_short_file_takes_the_unchunked_view(tmp_path, wavs, engine):
    """A file of at most chunk_size frames is gated as reduce_noise's one
    n + 2*padding view, not as a zero-extended full chunk."""
    kw = dict(ENGINES[engine], chunk_size=30000, padding=1000)
    out, ref = str(tmp_path / "out.wav"), str(tmp_path / "ref.wav")
    nrt.reduce_noise_file(wavs["mono-float"], out, as_float=True, device="cpu", **kw)
    jax_file(wavs["mono-float"], ref, as_float=True, **kw)
    got = _read(out)
    np.testing.assert_allclose(got, jio.read_wav(ref, dtype="float32")[1], atol=ATOL)
    np.testing.assert_allclose(got, _in_memory(wavs["mono-float"], **kw), atol=ATOL)
    # a full zero-extended chunk would differ: the floor spans other frames
    chunked = str(tmp_path / "chunked.wav")
    nrt.reduce_noise_file(wavs["mono-float"], chunked, as_float=True, device="cpu",
                          **dict(kw, chunk_size=N - 1))
    if not kw.get("stationary"):
        assert np.abs(_read(chunked) - got).max() > 1e-6


@pytest.mark.parametrize("seg_frames", [4096, 17], ids=["one-slab", "17-frame-slabs"])
@pytest.mark.parametrize("source", ["mono-float", "mono-pcm16", "stereo-float"])
def test_whole_file_threshold(wavs, monkeypatch, source, seg_frames):
    """The two streamed passes against the JAX package's and against the
    in-memory threshold of the mono mix; small slabs give many segment
    boundaries and a ragged tail."""
    monkeypatch.setattr(st, "_THRESH_SEG_FRAMES", seg_frames)
    monkeypatch.setattr(jst, "_THRESH_SEG_FRAMES", seg_frames)
    cfg = GateConfig(sr=SR, stationary=True)
    got = st._streaming_noise_threshold(wavs[source], cfg, torch.device("cpu"))
    assert got.shape == (cfg.stft.n_bins,) and got.dtype == torch.float32
    jcfg = JGateConfig(sr=SR, stationary=True, convention=JConvention.SCIPY)
    want = np.asarray(jst._streaming_noise_threshold(wavs[source], jcfg, "auto"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    x = torch.from_numpy(_read(wavs[source]))
    mono = x.mean(dim=1) if x.ndim == 2 else x
    np.testing.assert_allclose(got.numpy(), stationary_noise_threshold(mono, cfg).numpy(),
                               atol=1e-4, rtol=1e-5)


def test_whole_file_statistics_are_not_the_first_chunks(tmp_path, wavs):
    kw = dict(CK, stationary=True, as_float=True, device="cpu")
    whole, first = str(tmp_path / "whole.wav"), str(tmp_path / "first.wav")
    nrt.reduce_noise_file(wavs["mono-float"], whole, clip_noise_stationary=False, **kw)
    nrt.reduce_noise_file(wavs["mono-float"], first, **kw)
    assert np.abs(_read(whole) - _read(first)).max() > 1e-6


@pytest.mark.parametrize("clip", ["long-1d", "long-2d"])
def test_torch_noise_clip_is_cut_along_its_first_axis(tmp_path, wavs, clip):
    """A torch-convention noise clip longer than the file is cut to the
    file's length along its FIRST axis (samples of a 1-D clip, rows of a 2-D
    one), the reference's quirk (streamed_torch_gate.py:57-58)."""
    long = (0.1 * np.random.default_rng(4).standard_normal(N + 3000)).astype(np.float32)
    y_noise = long if clip == "long-1d" else np.stack([long, long[::-1]])
    kw = dict(CK, use_torch=True, stationary=True, y_noise=y_noise)
    out, ref = str(tmp_path / "out.wav"), str(tmp_path / "ref.wav")
    nrt.reduce_noise_file(wavs["stereo-float"], out, as_float=True, device="cpu", **kw)
    jax_file(wavs["stereo-float"], ref, as_float=True, **kw)
    got = _read(out)
    np.testing.assert_allclose(got, jio.read_wav(ref, dtype="float32")[1], atol=ATOL)
    np.testing.assert_allclose(got, _in_memory(wavs["stereo-float"], **kw), atol=ATOL)


@pytest.mark.parametrize("extra", [dict(use_tqdm=True), dict(method="fft"),
                                   dict(method="matmul")], ids=["tqdm", "fft", "matmul"])
def test_progress_and_method_do_not_change_the_output(tmp_path, wavs, extra):
    base, other = str(tmp_path / "base.wav"), str(tmp_path / "other.wav")
    kw = dict(CK, as_float=True, device="cpu")
    nrt.reduce_noise_file(wavs["mono-pcm16"], base, **kw)
    nrt.reduce_noise_file(wavs["mono-pcm16"], other, **kw, **extra)
    np.testing.assert_array_equal(_read(other), _read(base))


def test_mesh_raises_as_reduce_noise_does(tmp_path, wavs):
    """A mesh that is not a ``ChunkMesh`` raises the in-memory call's
    ``TypeError``; a ``ChunkMesh`` streams bitwise the one device's file
    (tests/test_torch_mesh.py holds the engines)."""
    with pytest.raises(TypeError) as file_err:
        nrt.reduce_noise_file(wavs["mono-float"], str(tmp_path / "o.wav"), mesh=object(),
                              device="cpu")
    with pytest.raises(TypeError) as mem_err:
        nrt.reduce_noise(MONO, SR, mesh=object(), device="cpu")
    assert str(file_err.value) == str(mem_err.value)
    assert "ChunkMesh" in str(file_err.value)
    base, sharded = str(tmp_path / "base.wav"), str(tmp_path / "mesh.wav")
    kw = dict(CK, as_float=True, device="cpu")
    nrt.reduce_noise_file(wavs["mono-pcm16"], base, **kw)
    nrt.reduce_noise_file(wavs["mono-pcm16"], sharded,
                          mesh=ChunkMesh((torch.device("cpu"),) * 2), **kw)
    np.testing.assert_array_equal(_read(sharded), _read(base))


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_writes_every_chunk_in_order(n_chunks, depth, monkeypatch):
    """The slots serve in turn and a slot is reused only after its chunk was
    written: the pipeline's output is the synchronous loop's (the shipped
    depth and a ring of two slots)."""
    monkeypatch.setattr(st, "_DEPTH", depth)
    rng = np.random.default_rng(n_chunks)
    chunks = [(i, rng.integers(-2000, 2000, (2, 50)).astype(np.int16))
              for i in range(n_chunks)]
    written = []
    st._pipeline(iter(chunks), [lambda x: x[:, 5:45].to(torch.float32) * 2.0],
                 (2, 40), torch.float32, lambda a: written.append(a.copy()),
                 [torch.device("cpu")])
    assert len(written) == n_chunks
    for (_, c), w in zip(chunks, written):
        np.testing.assert_array_equal(w, c[:, 5:45].astype(np.float32) * 2.0)
