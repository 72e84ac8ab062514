"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links them into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
``noisereduce_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and flags. Nothing is compiled at import: the CPU tests import every module
on a machine without ``nvcc``. ``ptxas -v``'s report of each source (every
kernel's registers, spills and shared memory) stays beside the library as
``<source stem>.ptxas.txt``.

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
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
                              "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_d = ctypes.c_double
_dp = ctypes.POINTER(ctypes.c_double)

# C signatures of the entries (csrc/*.cu); pointers and the stream as void*;
# the entries of A, B, D, E and F take the planes' type first (csrc/planes.cuh)
_SIGNATURES = {
    "nr_nonstationary_mask": [
        _i, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _dp, _f, _f,
        _i, _vp,
    ],
    "nr_freq_smooth_blend": [_vp, _vp, _vp, _i, _i, _ll, _i, _i, _i, _f, _vp],
    "nr_stationary_mask": [
        _i, _vp, _vp, _vp, _ll, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
        _i, _i, _f, _f, _f, _f, _f, _d, _i, _vp,
    ],
    "nr_torch_nonstationary_mask": [
        _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i,
        _i, _i, _f, _f, _i, _f, _f, _i, _vp,
    ],
    "nr_fm_nonstationary_mask": [
        _vp, _i, _vp, _vp, _ll, _i, _i, _i, _i, _i, _dp, _f, _f, _i, _vp,
    ],
    "nr_spectra_fft": [
        _i, _vp, _ll, _i, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
        _vp, _vp, _vp, _vp,
    ],
    "nr_istft_fft": [
        _i, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll, _ll,
        _ll, _f, _vp, _vp, _vp, _vp, _vp, _vp,
    ],
    "nr_spectra_cplx": [
        _i, _vp, _ll, _i, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
    ],
    "nr_spectra_cluster": [
        _i, _vp, _ll, _i, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _i, _vp, _vp, _vp,
        _vp, _vp, _vp, _vp, _vp,
    ],
    "nr_istft_cluster": [
        _i, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _f,
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp,
    ],
    # kernel A's complex-frame persistent grid: plane, n_fft, slot, tile_frames, hop, win
    "nr_spectra_cplx_capacity": [_i, _i, _i, _i, _i, _i],
    # the real-FFT kernels' persistent grids: plane, n_fft, tile_frames, hop,
    # win (A); plane, n_fft, seg_warps, n_bins, hop, r (D)
    "nr_spectra_fft_capacity": [_i, _i, _i, _i, _i],
    "nr_istft_fft_capacity": [_i, _i, _i, _i, _i, _i],
    "nr_spectra_cluster_capacity": [_i, _i],
    "nr_istft_cluster_capacity": [_i, _i],
    # the cluster chirp route: the chirp length after n_bins (A) or env_int
    # (D), the chirp and filter tables after the split's
    "nr_spectra_cluster_chirp": [
        _i, _vp, _ll, _i, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _vp,
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
    ],
    "nr_istft_cluster_chirp": [
        _i, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _f,
        _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp,
    ],
    "nr_spectra_cluster_chirp_capacity": [_i, _i, _i],
    # the global chirp route: the cluster chirp's arguments, the group of
    # slots after the chirp length, the (L1, L2) twiddle after the stages'
    # tables, the (group, L) complex scratch after the filter
    "nr_spectra_global": [
        _i, _vp, _ll, _i, _i, _ll, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _vp,
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
    ],
    "nr_istft_global": [
        _i, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _f,
        _vp, _vp, _vp, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp,
    ],
    "nr_istft_cluster_chirp_capacity": [_i, _i, _i],
    # kernel H: the plane type, input, its row stride, the output's type
    # (kernels._CAST_CODE), output, its row stride, rows, width
    "nr_output_cast": [_i, _vp, _ll, _i, _vp, _ll, _ll, _ll, _vp],
    "nr_istft_cplx": [
        _i, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll,
        _ll, _ll, _f, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp,
    ],
    # the plane type, n_fft, slot, a segment's warps, n_bins, hop, r
    "nr_istft_cplx_capacity": [_i, _i, _i, _i, _i, _i, _i],
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / _digest() / "libnrtorch.so"


def _run(cmds: list) -> list:
    """Run the commands side by side; wait for all, then raise on the
    first that failed. Returns each command's standard error."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{so}\n{se}"
            )
    return [se for _, se in outs]


def _compile(out: pathlib.Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [pathlib.Path(tmp) / f"{p.stem}.o" for p in sorted(CSRC.glob("*.cu"))]
        reports = _run([
            [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(CSRC / f"{o.stem}.cu")]
            for o in objs
        ])
        for o, report in zip(objs, reports):
            (out.parent / f"{o.stem}.ptxas.txt").write_text(report)
        tmp_so = pathlib.Path(tmp) / out.name
        _run([[nvcc, *LINK_FLAGS, "-o", str(tmp_so), *map(str, objs)]])
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
