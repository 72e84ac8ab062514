"""Native audio IO and the streaming chunk feed (counterpart of
``noisereduce_tpu/utils/io.py``).

Wraps the C++ runtime ``native/nrio.cpp`` of this package (a copy of the
repository's ``native/nrio.cpp``) through ctypes. The library is built with
``g++`` at first use into ``noisereduce_tpu_torch/_build/<hash>/libnrio.so``,
keyed by a hash of the source and the flags, as ``ops/cuda/build.py`` builds
the kernels; nothing is built at import. Where the build is not possible
(no ``g++``), the module falls back to scipy / numpy, as the JAX package's
module does without its prebuilt library; that path refuses RF64 files.

The streaming chunker yields halo'd (channels, chunk + 2*padding) batches,
the views the gate consumes, deinterleaved and zero filled in C++
(reference spectralgate/base.py:167-226), as int16 for PCM16 sources when
asked (the int16 feed).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Iterator, Tuple

import numpy as np

__all__ = [
    "native_available",
    "build_library",
    "wav_info",
    "read_wav",
    "write_wav",
    "stream_chunks",
    "WavWriter",
]

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "nrio.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-fvisibility=hidden",
             "-shared"]

_lock = threading.Lock()
_lib = None
_build_failed = False  # a failed build is not retried in this process


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libnrio.so"


def build_library() -> pathlib.Path:
    """Build ``libnrio.so`` from ``native/nrio.cpp`` unless it is built
    already; return its path. Raises ``RuntimeError`` when ``g++`` is
    missing or fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: libnrio.so is built from {SOURCE} at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        tmp_so = pathlib.Path(tmp) / path.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_so), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_so, path)  # atomic: a concurrent loader sees all or nothing
    return path


def _load():
    """The native library, built on first call; None where it cannot be
    built or loaded (the scipy / numpy path then serves)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        c_i64, c_i32, c_f32p, c_i16p = (
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int16),
        )
        lib.nrio_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_i64)]
        lib.nrio_wav_info.restype = ctypes.c_int
        lib.nrio_wav_read_f32.argtypes = [ctypes.c_char_p, c_f32p, c_i64, c_i64]
        lib.nrio_wav_read_f32.restype = c_i64
        lib.nrio_wav_read_i16.argtypes = [ctypes.c_char_p, c_i16p, c_i64, c_i64]
        lib.nrio_wav_read_i16.restype = c_i64
        lib.nrio_wav_write.argtypes = [ctypes.c_char_p, c_f32p, c_i64, c_i32, c_i32, c_i32]
        lib.nrio_wav_write.restype = ctypes.c_int
        lib.nrio_stream_open.argtypes = [ctypes.c_char_p, c_i64, c_i64]
        lib.nrio_stream_open.restype = ctypes.c_void_p
        lib.nrio_stream_channels.argtypes = [ctypes.c_void_p]
        lib.nrio_stream_channels.restype = ctypes.c_int
        lib.nrio_stream_next.argtypes = [ctypes.c_void_p, c_f32p]
        lib.nrio_stream_next.restype = c_i64
        lib.nrio_stream_next_i16.argtypes = [ctypes.c_void_p, c_i16p]
        lib.nrio_stream_next_i16.restype = c_i64
        lib.nrio_stream_format.argtypes = [ctypes.c_void_p]
        lib.nrio_stream_format.restype = ctypes.c_int
        lib.nrio_stream_close.argtypes = [ctypes.c_void_p]
        lib.nrio_stream_close.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the native runtime serves this process (built if need be)."""
    return _load() is not None


def _reject_rf64_without_native(path: str) -> None:
    """scipy's reader is RIFF-only; fail RF64 clearly, not with a scipy
    parse error deep inside wavfile."""
    with open(path, "rb") as fh:
        if fh.read(4) == b"RF64":
            raise IOError(
                f"{path!r} is an RF64 (>4 GiB) WAV; reading it requires the "
                "native nrio runtime (g++ builds it from native/nrio.cpp)"
            )


def wav_info(path: str) -> Tuple[int, int, int]:
    """(sample_rate, channels, n_frames) without reading sample data."""
    lib = _load()
    if lib is None:
        from scipy.io import wavfile

        _reject_rf64_without_native(path)
        rate, data = wavfile.read(path, mmap=True)
        ch = 1 if data.ndim == 1 else data.shape[1]
        return rate, ch, data.shape[0]
    info = (ctypes.c_int64 * 5)()
    rc = lib.nrio_wav_info(path.encode(), info)
    if rc != 0:
        raise IOError(f"nrio: cannot parse {path!r} (rc={rc})")
    return int(info[0]), int(info[1]), int(info[4])


def read_wav(
    path: str, dtype: str = "float32", start: int = 0, frames: int = -1
) -> Tuple[int, np.ndarray]:
    """Read a WAV file -> (sample_rate, (frames,) or (frames, channels)).

    dtype='float32' scales integer formats to [-1, 1); dtype='int16' returns
    raw PCM16 samples (scipy.io.wavfile-compatible shape/dtype).
    """
    lib = _load()
    if lib is None:
        from scipy.io import wavfile

        _reject_rf64_without_native(path)
        rate, data = wavfile.read(path)
        if frames >= 0 or start:
            end = None if frames < 0 else start + frames
            data = data[start:end]
        if dtype == "float32":
            # scale integer formats to [-1, 1) like the native reader
            if data.dtype == np.int16:
                data = (data / 32768.0).astype(np.float32)
            elif data.dtype == np.int32:
                data = (data / 2147483648.0).astype(np.float32)
            elif data.dtype == np.uint8:
                data = ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
            else:
                data = data.astype(np.float32)
        return rate, data

    info = (ctypes.c_int64 * 5)()
    rc = lib.nrio_wav_info(path.encode(), info)
    if rc != 0:
        raise IOError(f"nrio: cannot parse {path!r} (rc={rc})")
    rate, channels, _bits, _fmt, n_frames = (int(v) for v in info)
    if frames < 0:
        frames = n_frames - start
    frames = max(0, min(frames, n_frames - start))

    if dtype == "int16":
        buf = np.empty(frames * channels, dtype=np.int16)
        got = lib.nrio_wav_read_i16(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            start, frames,
        )
        if got < 0:
            raise IOError(f"nrio: int16 read failed (rc={got})")
    else:
        buf = np.empty(frames * channels, dtype=np.float32)
        got = lib.nrio_wav_read_f32(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            start, frames,
        )
        if got < 0:
            raise IOError(f"nrio: read failed (rc={got})")
    buf = buf[: int(got) * channels]
    data = buf.reshape(-1, channels) if channels > 1 else buf
    return rate, data


def write_wav(path: str, data: np.ndarray, sr: int, as_float: bool = False) -> None:
    """Write float waveform ((frames,) or (frames, channels)) as PCM16 or
    IEEE-float WAV."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        frames, channels = len(data), 1
    else:
        frames, channels = data.shape
    if frames * channels * (4 if as_float else 2) > _RIFF_DATA_MAX:
        # beyond the 32-bit RIFF limit: stream through the RF64-capable
        # incremental writer (scipy and the native fast path are RIFF-only)
        with WavWriter(path, sr, channels, frames, as_float=as_float) as w:
            w.write(data if data.ndim == 2 else data[:, None])
        return
    lib = _load()
    if lib is None:
        from scipy.io import wavfile

        if as_float:
            wavfile.write(path, sr, data)
        else:
            wavfile.write(path, sr, np.clip(data * 32767.0, -32768, 32767).astype(np.int16))
        return
    flat = np.ascontiguousarray(data).reshape(-1)
    rc = lib.nrio_wav_write(
        path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, sr, 1 if as_float else 0,
    )
    if rc != 0:
        raise IOError(f"nrio: write failed (rc={rc})")


# Largest data payload a classic 32-bit RIFF header can describe.
_RIFF_DATA_MAX = 0xFFFFFFFF - 36


class WavWriter:
    """Incremental WAV writer (PCM16 or IEEE float32) for streaming output
    at constant host memory: write the header with the final frame count up
    front, then append frames as they are produced.

    Outputs larger than the 32-bit RIFF limit (>4 GiB of data) use an RF64
    header (EBU Tech 3306: 64-bit sizes in a ``ds64`` chunk).

    Usage::

        with WavWriter(path, sr, channels, n_frames, as_float=True) as w:
            for block in ...:   # (frames,) or (frames, channels) float
                w.write(block)
    """

    def __init__(self, path: str, sr: int, channels: int, n_frames: int,
                 as_float: bool = False):
        self._as_float = as_float
        self._expected = n_frames
        self._written = 0
        self._channels = channels
        self._f = open(path, "wb")
        self._f.write(self.header_bytes(sr, channels, n_frames, as_float))

    @staticmethod
    def header_bytes(sr: int, channels: int, n_frames: int,
                     as_float: bool = False) -> bytes:
        """Complete pre-data header (RIFF, or RF64 past the 4 GiB limit), a
        pure function of the geometry."""
        import struct

        bits = 32 if as_float else 16
        fmt = 3 if as_float else 1
        data_bytes = n_frames * channels * (bits // 8)
        fmt_chunk = struct.pack(
            "<IHHIIHH", 16, fmt, channels, sr,
            sr * channels * (bits // 8), channels * (bits // 8), bits,
        )
        if data_bytes <= _RIFF_DATA_MAX:
            return (
                b"RIFF" + struct.pack("<I", 36 + data_bytes)
                + b"WAVEfmt " + fmt_chunk
                + b"data" + struct.pack("<I", data_bytes)
            )
        # RF64: 32-bit size fields hold 0xFFFFFFFF placeholders; true sizes
        # live in the ds64 chunk. riff64 counts everything after the 8-byte
        # RF64 header: WAVE(4) + ds64(8+28) + fmt(8+16) + data hdr(8) + data.
        riff64 = 4 + 36 + 24 + 8 + data_bytes
        ds64 = struct.pack("<QQQI", riff64, data_bytes, n_frames, 0)  # sizes + empty table
        return (
            b"RF64" + struct.pack("<I", 0xFFFFFFFF)
            + b"WAVE"
            + b"ds64" + struct.pack("<I", 28) + ds64
            + b"fmt " + fmt_chunk
            + b"data" + struct.pack("<I", 0xFFFFFFFF)
        )

    def write(self, block) -> None:
        """Append (frames,) or (frames, channels) samples: float (quantized
        to PCM16 here by clip and C cast unless ``as_float``), or int16
        already quantized the same way (written as they are). Frames past
        the header's count are dropped."""
        block = np.asarray(block)
        if block.ndim == 1:
            block = block[:, None]
        if block.shape[1] != self._channels:
            raise ValueError("channel count mismatch")
        block = block[: self._expected - self._written]
        if not (block.dtype == np.int16 and not self._as_float):
            block = block.astype(np.float32, copy=False)
            if not self._as_float:
                block = np.clip(block * 32767.0, -32768, 32767).astype(np.int16)
        self._f.write(np.ascontiguousarray(block).tobytes())
        self._written += len(block)

    def close(self) -> None:
        if self._written < self._expected:
            pad = np.zeros((self._expected - self._written, self._channels), np.float32)
            self.write(pad)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_PCM16 = 116  # nrio_stream_format's code of a PCM16 source


def stream_chunks(
    path: str, chunk_size: int, padding: int, dtype: str = "float32"
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (chunk_index, (channels, chunk_size + 2*padding)) halo'd
    chunks from a WAV file, zero filled past the signal's edges: the
    geometry of ``parallel.chunking.extract_chunks`` and of the reference's
    per-chunk reads (base.py:130-148).

    ``dtype="int16"`` yields raw int16 chunks when the source is PCM16 (the
    int16 feed: half the host -> device bytes; ``x.float() * 2**-15`` on
    the device is bit-identical to the float32 chunks, since int16 -> f32
    is exact and 2^-15 a power of two). Other sources yield float32 chunks,
    so callers key on the yielded array's dtype."""
    lib = _load()
    view = chunk_size + 2 * padding
    want_i16 = dtype == "int16"
    if lib is None:
        _, data = read_wav(path, dtype="int16" if want_i16 else "float32")
        if data.dtype not in (np.int16, np.float32):  # int16 asked of another format
            _, data = read_wav(path, dtype="float32")
        y = data.T if data.ndim == 2 else data[None]
        n = y.shape[-1]
        n_chunks = (n - 1) // chunk_size + 1
        ypad = np.pad(y, [(0, 0), (padding, n_chunks * chunk_size - n + padding)])
        for i in range(n_chunks):
            yield i, ypad[:, i * chunk_size : i * chunk_size + view].copy()
        return

    h = lib.nrio_stream_open(path.encode(), chunk_size, padding)
    if not h:
        raise IOError(f"nrio: cannot open {path!r}")
    try:
        channels = lib.nrio_stream_channels(h)
        if want_i16 and lib.nrio_stream_format(h) == _PCM16:
            buf = np.empty((channels, view), dtype=np.int16)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
            step = lib.nrio_stream_next_i16
        else:
            buf = np.empty((channels, view), dtype=np.float32)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            step = lib.nrio_stream_next
        while True:
            idx = step(h, ptr)
            if idx == -1:
                break  # end of stream
            if idx < -1:
                raise IOError(
                    f"nrio: streaming unsupported sample format in {path!r} "
                    f"(rc={idx}); streaming supports PCM16/float32; use "
                    "read_wav for other formats"
                )
            yield int(idx), buf.copy()
    finally:
        lib.nrio_stream_close(h)
