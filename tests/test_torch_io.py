"""PyTorch port: the native IO runtime (``noisereduce_tpu_torch/utils/io.py``
over the package's own copy of ``native/nrio.cpp``), its numpy / scipy
path, and the utilities, against scipy and the JAX package (CPU).

Every IO behaviour is held on both paths: ``native`` (the library the
port builds with g++ into ``noisereduce_tpu_torch/_build/``) and ``numpy``
(``_load`` patched to None, the path of a machine without a compiler).
Reads and writes are exact (atol 0) except a PCM16 round trip, which is
within its quantization: 1.5 LSB of rounding plus the 32767 / 32768 gain
skew (1 LSB). The port's writers give the same bytes as the JAX package's.
"""
import pathlib
import re
import struct

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import noisereduce_tpu as jnr
from noisereduce_tpu.utils import io as jio

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.parallel.chunking import extract_chunks
from noisereduce_tpu_torch.utils import io as nrio

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEECH = str(ROOT / "assets" / "speech.wav")  # 44.1 kHz mono int16, 200,542 frames
LSB = 1.0 / 32768


@pytest.fixture(params=["native", "numpy"])
def path_kind(request, monkeypatch):
    """Run the test on the native library, then on the numpy / scipy path."""
    if request.param == "native":
        if not nrio.native_available():
            pytest.skip("g++ cannot build libnrio.so here")
    else:
        monkeypatch.setattr(nrio, "_load", lambda: None)
    return request.param


@pytest.fixture
def native():
    if not nrio.native_available():
        pytest.skip("g++ cannot build libnrio.so here")
    return nrio._load()


def test_native_source_is_a_copy_of_the_repository_runtime():
    assert (ROOT / "noisereduce_tpu_torch" / "native" / "nrio.cpp").read_bytes() == (
        ROOT / "native" / "nrio.cpp").read_bytes()


def test_library_builds_into_the_ports_own_build_directory(native):
    path = nrio.library_path()
    assert path.parent.parent == ROOT / "noisereduce_tpu_torch" / "_build"
    assert path.name == "libnrio.so" and path.exists()
    assert nrio.build_library() == path
    assert "noisereduce_tpu/_native" not in str(path)


def test_read_int16_matches_scipy(path_kind):
    rate_ref, data_ref = wavfile.read(SPEECH)
    rate, data = nrio.read_wav(SPEECH, dtype="int16")
    assert rate == rate_ref
    np.testing.assert_array_equal(data, data_ref)
    assert nrio.wav_info(SPEECH) == (rate_ref, 1, data_ref.shape[0])


def test_read_f32_scaling(path_kind):
    _, data_ref = wavfile.read(SPEECH)
    _, data = nrio.read_wav(SPEECH, dtype="float32")
    assert data.dtype == np.float32
    np.testing.assert_array_equal(data, data_ref.astype(np.float32) / 32768.0)


def test_read_range(path_kind):
    _, full = nrio.read_wav(SPEECH, dtype="int16")
    _, part = nrio.read_wav(SPEECH, dtype="int16", start=1000, frames=5000)
    np.testing.assert_array_equal(part, full[1000:6000])


def test_write_roundtrip(tmp_path, path_kind):
    y = np.random.default_rng(0).uniform(-0.9, 0.9, 8000).astype(np.float32)
    p16 = str(tmp_path / "a.wav")
    nrio.write_wav(p16, y, 16000)
    rate, back = nrio.read_wav(p16, dtype="float32")
    assert rate == 16000
    np.testing.assert_allclose(back, y, atol=1.5 * LSB + LSB)
    pf = str(tmp_path / "b.wav")
    nrio.write_wav(pf, y, 16000, as_float=True)
    np.testing.assert_array_equal(nrio.read_wav(pf, dtype="float32")[1], y)
    np.testing.assert_array_equal(wavfile.read(pf)[1], y)


def test_write_stereo_roundtrip(tmp_path, path_kind):
    y = np.random.default_rng(1).uniform(-0.5, 0.5, (4000, 2)).astype(np.float32)
    p = str(tmp_path / "st.wav")
    nrio.write_wav(p, y, 44100, as_float=True)
    rate, back = nrio.read_wav(p)
    assert rate == 44100 and back.shape == y.shape
    np.testing.assert_array_equal(back, y)
    assert nrio.wav_info(p) == (44100, 2, 4000)


@pytest.mark.parametrize("as_float", [False, True], ids=["pcm16", "float"])
@pytest.mark.parametrize("shape", [(3000,), (3000, 2)], ids=["mono", "stereo"])
def test_writers_give_the_jax_packages_bytes(tmp_path, path_kind, as_float, shape,
                                             monkeypatch):
    """Each path against the same path of the JAX package."""
    if path_kind == "numpy":
        monkeypatch.setattr(jio, "_load", lambda: None)
    y = np.random.default_rng(2).uniform(-1.2, 1.2, shape).astype(np.float32)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    nrio.write_wav(str(ours), y, 22050, as_float=as_float)
    jio.write_wav(str(theirs), y, 22050, as_float=as_float)
    assert ours.read_bytes() == theirs.read_bytes()
    ch = 1 if len(shape) == 1 else shape[1]
    with nrio.WavWriter(str(ours), 22050, ch, shape[0], as_float=as_float) as w:
        w.write(y[:1234])
        w.write(y[1234:])
    with jio.WavWriter(str(theirs), 22050, ch, shape[0], as_float=as_float) as w:
        w.write(y)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("cs,pad", [(30000, 5000), (25000, 0), (250000, 2000)])
def test_stream_chunks_match_extract_chunks(path_kind, cs, pad):
    _, data = nrio.read_wav(SPEECH, dtype="float32")
    want = extract_chunks(torch.from_numpy(data)[None], cs, pad).numpy()
    seen = dict(nrio.stream_chunks(SPEECH, cs, pad))
    assert sorted(seen) == list(range(want.shape[1]))
    for i in range(want.shape[1]):
        assert seen[i].dtype == np.float32 and seen[i].shape == (1, cs + 2 * pad)
        np.testing.assert_array_equal(seen[i][0], want[0, i])


def test_stream_chunks_numpy_path_matches_native(native, monkeypatch):
    cs, pad = 25000, 2000
    want = dict(nrio.stream_chunks(SPEECH, cs, pad, dtype="int16"))
    monkeypatch.setattr(nrio, "_load", lambda: None)
    got = dict(nrio.stream_chunks(SPEECH, cs, pad, dtype="int16"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int16
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("channels", [1, 2])
def test_int16_feed_is_bit_identical(tmp_path, path_kind, channels):
    """PCM16 sources stream as raw int16; x.float() * 2^-15 on the device
    reproduces the float32 stream bit for bit."""
    y = (np.random.default_rng(7).standard_normal((50000, channels)) * 0.3).clip(-1, 1)
    p = str(tmp_path / "pcm16.wav")
    nrio.write_wav(p, y.astype(np.float32).squeeze(), 16000)  # PCM16
    f32 = list(nrio.stream_chunks(p, 12000, 2000, dtype="float32"))
    i16 = list(nrio.stream_chunks(p, 12000, 2000, dtype="int16"))
    assert [i for i, _ in f32] == [i for i, _ in i16] == list(range(5))
    for (_, a), (_, b) in zip(f32, i16):
        assert a.dtype == np.float32 and b.dtype == np.int16
        assert a.shape == b.shape == (channels, 16000)
        conv = torch.from_numpy(b).to(torch.float32) * 2.0**-15
        np.testing.assert_array_equal(conv.numpy(), a)


def test_int16_feed_yields_float32_for_a_float_source(tmp_path, path_kind):
    p = str(tmp_path / "f.wav")
    nrio.write_wav(p, np.linspace(-0.5, 0.5, 30000, dtype=np.float32), 16000, as_float=True)
    got = list(nrio.stream_chunks(p, 20000, 3000, dtype="int16"))
    assert len(got) == 2 and all(c.dtype == np.float32 for _, c in got)


def test_wav_writer_incremental_and_padded_tail(tmp_path, path_kind):
    y = np.random.default_rng(9).uniform(-0.8, 0.8, (5000, 2)).astype(np.float32)
    p = str(tmp_path / "w.wav")
    with nrio.WavWriter(p, 22050, 2, 5000, as_float=True) as w:
        for i in range(0, 5000, 1234):
            w.write(y[i : i + 1234])
    rate, back = nrio.read_wav(p)
    assert rate == 22050
    np.testing.assert_array_equal(back, y)
    p = str(tmp_path / "pad.wav")
    with nrio.WavWriter(p, 8000, 1, 100, as_float=True) as w:
        w.write(np.ones(40, np.float32))
        w.write(np.ones(10, np.float32)[:, None])
    _, back = nrio.read_wav(p)
    assert back.shape == (100,)
    assert np.all(back[:50] == 1.0) and np.all(back[50:] == 0.0)


def test_wav_writer_drops_frames_past_its_count_and_checks_channels(tmp_path):
    p = str(tmp_path / "c.wav")
    with nrio.WavWriter(p, 8000, 2, 30) as w:
        with pytest.raises(ValueError, match="channel count"):
            w.write(np.zeros((10, 3), np.float32))
        w.write(np.full((50, 2), 0.5, np.float32))
    _, back = nrio.read_wav(p, dtype="int16")
    assert back.shape == (30, 2) and np.all(back == 16383)


def test_wav_writer_passes_prequantized_int16(tmp_path, path_kind):
    p = str(tmp_path / "q.wav")
    q = np.arange(-100, 100, dtype=np.int16)[:, None]
    with nrio.WavWriter(p, 16000, 1, len(q)) as w:
        w.write(q)
    _, back = nrio.read_wav(p, dtype="int16")
    np.testing.assert_array_equal(back, q[:, 0])


def test_wav_writer_quantizes_as_numpy_c_cast(tmp_path):
    """Clip then truncate toward zero, saturating at both ends: the host
    quantize the card's trunc(clamp(x * 32767)) must equal."""
    y = np.array([0.0, 0.49999 / 32767, -1.2, 1.2, -1.0, 1.0, 0.25, -0.25,
                  1.5 / 32767, -1.5 / 32767], np.float32)
    p = str(tmp_path / "q.wav")
    with nrio.WavWriter(p, 8000, 1, len(y)) as w:
        w.write(y)
    _, back = nrio.read_wav(p, dtype="int16")
    np.testing.assert_array_equal(back, [0, 0, -32768, 32767, -32767, 32767, 8191, -8191, 1, -1])
    dev = torch.trunc(torch.clamp(torch.from_numpy(y) * 32767.0, -32768.0, 32767.0))
    np.testing.assert_array_equal(dev.to(torch.int16).numpy(), back)


def test_header_bytes_riff_and_rf64():
    h = nrio.WavWriter.header_bytes(48000, 2, 1000, as_float=True)
    assert h[:4] == b"RIFF" and struct.unpack("<I", h[-4:])[0] == 1000 * 2 * 4
    assert h == jio.WavWriter.header_bytes(48000, 2, 1000, as_float=True)
    n_frames = 48000 * 3600 * 8  # 8 h of stereo float32: past 4 GiB
    data_bytes = n_frames * 2 * 4
    h = nrio.WavWriter.header_bytes(48000, 2, n_frames, as_float=True)
    assert h[:4] == b"RF64" and struct.unpack("<I", h[4:8])[0] == 0xFFFFFFFF
    assert h[8:12] == b"WAVE" and h[12:16] == b"ds64"
    riff64, data64, frames64 = struct.unpack("<QQQ", h[20:44])
    assert (riff64, data64, frames64) == (4 + 36 + 24 + 8 + data_bytes, data_bytes, n_frames)
    assert h[-8:-4] == b"data" and struct.unpack("<I", h[-4:])[0] == 0xFFFFFFFF
    assert h == jio.WavWriter.header_bytes(48000, 2, n_frames, as_float=True)


def test_native_writer_refuses_a_giant_riff(tmp_path, native):
    import ctypes

    dummy = np.zeros(8, np.float32)
    rc = native.nrio_wav_write(
        str(tmp_path / "x.wav").encode(),
        dummy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 2**31, 2, 48000, 1)
    assert rc == -2


def _rf64_blob(payload: np.ndarray) -> bytes:
    data_bytes = payload.nbytes
    fmt_chunk = struct.pack("<IHHIIHH", 16, 3, 1, 8000, 8000 * 4, 4, 32)
    return (
        b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"ds64" + struct.pack("<I", 28)
        + struct.pack("<QQQI", 4 + 36 + 24 + 8 + data_bytes, data_bytes, len(payload), 0)
        + b"fmt " + fmt_chunk
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
        + payload.tobytes()
    )


def test_rf64_read_natively_and_refused_by_the_numpy_path(tmp_path, path_kind):
    payload = np.linspace(-0.5, 0.5, 100, dtype=np.float32)
    p = str(tmp_path / "tiny_rf64.wav")
    pathlib.Path(p).write_bytes(_rf64_blob(payload))
    if path_kind == "native":
        assert nrio.wav_info(p) == (8000, 1, 100)
        np.testing.assert_array_equal(nrio.read_wav(p, dtype="float32")[1], payload)
    else:
        for call in (nrio.wav_info, nrio.read_wav):
            with pytest.raises(IOError, match="RF64"):
                call(p)


def test_native_parses_an_odd_sized_fmt_chunk(tmp_path, native):
    payload = np.arange(10, dtype=np.int16)
    fmt_body = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16) + b"\x07"
    blob = (
        b"RIFF" + struct.pack("<I", 4 + 8 + 18 + 8 + 20) + b"WAVE"
        + b"fmt " + struct.pack("<I", 17) + fmt_body + b"\x00"
        + b"data" + struct.pack("<I", 20) + payload.tobytes()
    )
    p = str(tmp_path / "oddfmt.wav")
    pathlib.Path(p).write_bytes(blob)
    assert nrio.wav_info(p) == (8000, 1, 10)
    np.testing.assert_array_equal(nrio.read_wav(p, dtype="int16")[1], payload)


def test_format_errors(tmp_path, native):
    p = str(tmp_path / "i32.wav")
    wavfile.write(p, 8000, np.zeros(50000, dtype=np.int32))
    with pytest.raises(IOError, match="unsupported sample format"):
        list(nrio.stream_chunks(p, 20000, 1000))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"NOTAWAVE" * 8)
    with pytest.raises(IOError, match="cannot parse"):
        nrio.wav_info(str(bad))
    with pytest.raises(IOError, match="cannot open"):
        list(nrio.stream_chunks(str(bad), 1000, 10))


def test_int32_scaling_on_both_paths(tmp_path, native, monkeypatch):
    p = str(tmp_path / "i32b.wav")
    x = (np.linspace(-1, 1, 1000) * 2**31 * 0.5).astype(np.int32)
    wavfile.write(p, 8000, x)
    _, got_native = nrio.read_wav(p, dtype="float32")
    monkeypatch.setattr(nrio, "_load", lambda: None)
    _, got = nrio.read_wav(p, dtype="float32")
    np.testing.assert_allclose(got, x / 2147483648.0, atol=1e-7)
    np.testing.assert_allclose(got_native, got, atol=1e-7)
    # int16 asked of an int32 source: float32 chunks on the numpy path
    assert all(c.dtype == np.float32 for _, c in nrio.stream_chunks(p, 400, 10, dtype="int16"))


def test_version_single_source():
    m = re.search(r'^version\s*=\s*"([^"]+)"', (ROOT / "pyproject.toml").read_text(),
                  re.MULTILINE)
    assert m and nrt.__version__ == m.group(1) == jnr.__version__


def test_package_exports_the_jax_packages_names():
    want = set(jnr.__all__) - {"band_limited_noise_jax"} | {"band_limited_noise_torch"}
    assert set(nrt.__all__) == want
    for name in nrt.__all__:
        assert getattr(nrt, name) is not None


@pytest.mark.parametrize("data", [
    np.array([-32768, -1, 0, 1, 32767], np.int16),
    np.arange(-40000, 40000, 997, dtype=np.int32),
], ids=["int16", "int32-too-wide"])
def test_int16_converters_match_jax(data):
    if np.abs(data).max() > 32768:
        with pytest.raises(ValueError, match="int16-scaled"):
            nrt.int16_to_float32(data)
        with pytest.raises(ValueError, match="int16-scaled"):
            jnr.int16_to_float32(data)
        return
    got = nrt.int16_to_float32(data)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jnr.int16_to_float32(data))


@pytest.mark.parametrize("data", [
    np.array([0.0, 0.5, -0.5, 1.0, -1.0], np.float32),
    np.array([0.5, 2.0, -0.25], np.float32),   # positive peak past 1: renormalized
    np.array([0.5, -2.0, 0.25], np.float32),   # only negative past 1: wraps
])
def test_float32_to_int16_matches_jax(data):
    np.testing.assert_array_equal(nrt.float32_to_int16(data), jnr.float32_to_int16(data))


def test_numpy_noise_matches_jax():
    np.random.seed(5)
    want = jnr.band_limited_noise(200, 4000, 4096, 16000)
    np.random.seed(5)
    got = nrt.band_limited_noise(200, 4000, 4096, 16000)
    np.testing.assert_array_equal(got, want)
    np.random.seed(6)
    f = np.abs(np.random.default_rng(0).standard_normal(1001))
    np.random.seed(7)
    a = nrt.fftnoise(f)
    np.random.seed(7)
    np.testing.assert_array_equal(a, jnr.fftnoise(f))


@pytest.mark.parametrize("samples", [4096, 4095])
def test_band_limited_noise_torch(samples):
    """Reproducible from its generator, real, and band-limited as
    band_limited_noise_jax: the spectrum's magnitude is 1 on exactly the
    JAX variant's bins in [min, max] (its DC and Nyquist bins as they are)
    and 0 elsewhere, in float64 to 1e-9."""
    import jax

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return nrt.band_limited_noise_torch(300, 3000, samples, 16000, generator=g,
                                            dtype=torch.float64)

    a = draw(1)
    assert a.shape == (samples,) and a.dtype == torch.float64
    assert torch.equal(a, draw(1)) and not torch.equal(a, draw(2))
    spec = np.abs(np.fft.fft(a.numpy()))
    ref = np.asarray(jnr.band_limited_noise_jax(jax.random.PRNGKey(0), 300, 3000, samples, 16000))
    np.testing.assert_allclose(spec, np.abs(np.fft.fft(ref)), atol=1e-9)
    f32 = nrt.band_limited_noise_torch(300, 3000, samples, 16000,
                                       generator=torch.Generator().manual_seed(1))
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(np.abs(np.fft.fft(f32.numpy().astype(np.float64))),
                               np.abs(np.fft.fft(ref)), atol=1e-5)
