"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
under ``noisereduce_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags. Nothing is compiled at import: the CPU tests import every
module on a machine without ``nvcc``.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.
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
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float

# C signatures of the entries (csrc/*.cu); pointers and the stream as void*
_SIGNATURES = {
    "nr_spectra": [
        _vp, _ll, _i, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _vp, _i, _i, _vp,
        _vp, _vp,
    ],
    "nr_nonstationary_mask": [
        _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _f, _f, _vp,
    ],
    "nr_freq_smooth_blend": [_vp, _vp, _vp, _i, _ll, _i, _f, _vp],
    "nr_istft_ola": [
        _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll,
        _ll, _ll, _vp, _vp,
    ],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall seconds of the build this process ran, if any


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        pathlib.Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        pathlib.Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and pathlib.Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC} at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / _digest() / "libnrtorch.so"


def _compile(out: pathlib.Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = pathlib.Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp_so), *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nr_error_string.argtypes = [ctypes.c_int]
            lib.nr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if code != 0:
        msg = load().nr_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
