#!/usr/bin/env python3
"""Time kernels A and D (``tools/fft_route_timing.py``) in copies of
``noisereduce_tpu_torch`` that route the FFT route's n_fft to other
kernels, first holding each copy's A and D to their plain versions with
the card tests of ``tests/test_torch_cuda.py``. The copies go under
``$TMPDIR``; the repository's sources are not touched. A copy is built
once a run, so ``base cplx_all cplx_all base`` times each tree twice, in
turns.

    python3 tools/fft_route_variants.py base cplx_all cplx_all base --cells 1024,1536
    python3 tools/fft_route_variants.py base big_all_radices big_all_radices base --cells 16384 --library

- ``base``: the sources as they are;
- ``cplx_all``: the complex-frame kernels (``spectra_cplx.cu``,
  ``istft_cplx.cu``) serve every n_fft of the FFT route, the even
  2^k 3^a 5^b 7^c ones too, in place of the real-FFT kernels
  (``spectra_fft.cu``, ``istft_fft.cu``);
- ``big_all_radices``: a big block's even n_fft whose n is a power of
  two (16384) takes the complex-frame kernels' build with every odd radix
  (multiply-high divisions; it spills at 1024 threads) in place of the
  build with the power-of-two stages alone;
- ``cluster_1024``: the cluster route's blocks of 1024 threads, one an SM,
  in place of 512, two an SM;
- ``diag_*``: the cluster route with a piece of its work taken out, to
  see what that piece costs (``diag_no_gather``: A's gather of the signal;
  ``diag_no_window``: the window's loads in that gather;
  ``diag_no_unpack``: A's unpack; ``diag_own_exchange``: the exchange's
  pull from the other blocks, each block pulling from its own buffer;
  ``diag_unit_twiddle``: the exchange's twiddles). Their outputs are wrong
  by design, so no card test holds them.

    python3 tools/fft_route_variants.py base diag_no_unpack base --cells 40000,40000@960

Arguments after the variants go to ``tools/fft_route_timing.py``. Needs
one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "noisereduce_tpu_torch/ops/cuda"
VARIANTS = {  # name: [(file under PKG, code, its replacement)]
    "base": [],
    "cplx_all": [
        ("csrc/fft_smem.cuh",
         "if (r == ROUTE_FFT) return slot == n && !real_kernel(n_fft);",
         "if (r == ROUTE_FFT) return slot == n;"),
        ("csrc/fft_smem.cuh",
         "return with_set<1155, 1365, 15015>(odd, build(N(), N()));",
         "return with_set<1, 3, 5, 7, 15, 21, 35, 105, 1155, 1365, 15015>("
         "odd, build(N(), N()));"),
        ("geometry.py",
         "    return (n_fft % 2 == 0 and FFT_MIN_NFFT <= n_fft <= REAL_MAX_NFFT\n"
         "            and _strip(n_fft // 2, REAL_RADICES) == 1)",
         "    return False"),
    ],
    "big_all_radices": [
        ("csrc/fft_smem.cuh",
         "             : odd == 1 ? f(integral_constant<int, 1>(), N(), N(), Y())\n",
         ""),
    ],
    # the cluster route in blocks of 1024 threads, one an SM
    "cluster_1024": [
        ("csrc/fft_cluster.cuh",
         "constexpr int CLUSTER_THREADS = 512;",
         "constexpr int CLUSTER_THREADS = 1024;"),
        ("csrc/fft_cluster.cuh",
         "constexpr int cluster_min_blocks(int odd) { return odd % 11 ? 2 : 1; }",
         "constexpr int cluster_min_blocks(int odd) { return 1; }"),
    ],
    # diagnostics of the cluster route, each with a piece of its work taken
    # out (their outputs are wrong, so no card test holds them): A's gather
    # of the signal, its window, A's unpack, the exchange's pull from other
    # blocks (each block pulls from its own buffer), the exchange's twiddles
    # from the n-point table (a unit twiddle)
    "diag_no_gather": [
        ("csrc/spectra_cluster.cu",
         "return !PAIRED && sizeof(P) == sizeof(float) && sl.whole && win == 2 * f.n;",
         "return false;"),
        ("csrc/spectra_cluster.cu",
         "if (from_spare) {  // samples 2j and 2j + 1, and the window's (one load each)",
         "return make_float2((float)j, (float)col);\n        if (from_spare) {"),
    ],
    "diag_no_window": [
        ("csrc/spectra_cluster.cu",
         "return make_float2(wv.x * xv.x, wv.y * xv.y);",
         "return xv;"),
    ],
    "diag_no_unpack": [
        ("csrc/spectra_cluster.cu",
         "for (int e = threadIdx.x; e < f.rows * f.n1; e += nrf::CLUSTER_THREADS) {",
         "for (int e = threadIdx.x; e < 0; e += nrf::CLUSTER_THREADS) {"),
    ],
    "diag_own_exchange": [
        ("csrc/fft_cluster.cuh",
         "v[u] = reinterpret_cast<const V*>(cl.map_shared_rank(held, o))",
         "v[u] = reinterpret_cast<const V*>(o < 0 ? nullptr : held)"),
    ],
    "diag_unit_twiddle": [
        ("csrc/fft_cluster.cuh",
         "float2 t = __ldg(twn + j1 * (rank * f.rows + r));  // j1 k2 < n",
         "float2 t = make_float2(1.f, (float)(j1 * r & 0));"),
    ],
}
# the card tests that hold a copy's A and D to their plain versions
CHECK = ("routes_match_plain_versions and (nfft512 or nfft1024 or nfft1536 or nfft400 or "
         "nfft882 or nfft16384 or nfft12000 or nfft40000 or nfft32768 or nfft19683)")


def build_copy(name: str) -> pathlib.Path:
    """A copy of the package with variant ``name``'s edits applied."""
    d = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / f"fft_route_variant_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "noisereduce_tpu_torch", d / "noisereduce_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for file, old, new in VARIANTS[name]:
        p = d / PKG / file
        src = p.read_text()
        if src.count(old) != 1:
            sys.exit(f"variant {name}: {file} no longer holds the code it edits")
        p.write_text(src.replace(old, new))
    return d


def main() -> None:
    names = [a for a in sys.argv[1:] if not a.startswith("-") and a in VARIANTS]
    rest = sys.argv[1 + len(names):]
    if not names or any(a in VARIANTS for a in rest):
        sys.exit(f"usage: fft_route_variants.py VARIANT... [timing arguments]; "
                 f"variants {', '.join(VARIANTS)}")
    copies = {}
    for name in names:
        if name not in copies and name.startswith("diag_"):
            copies[name] = build_copy(name)
            print(f"== variant {name}: a diagnostic, its outputs not held", flush=True)
        elif name not in copies:
            d = copies[name] = build_copy(name)
            # from the copy's directory, so that pytest imports the copy
            check = subprocess.run(
                [sys.executable, "-m", "pytest", str(ROOT / "tests/test_torch_cuda.py"),
                 "--noconftest", "-q", "-p", "no:cacheprovider", "-k", CHECK],
                cwd=d, env=dict(os.environ, PYTHONPATH=str(d)), capture_output=True, text=True)
            print(f"== variant {name}: card tests of A and D: "
                  f"{check.stdout.strip().splitlines()[-1:]}", flush=True)
            if check.returncode:
                sys.exit(check.stdout[-3000:] + check.stderr[-3000:])
        print(f"== variant {name}", flush=True)
        run = subprocess.run(
            [sys.executable, str(ROOT / "tools/fft_route_timing.py"), *rest],
            env=dict(os.environ, PYTHONPATH=str(copies[name])), capture_output=True, text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode:
            sys.exit(run.stderr[-3000:])


if __name__ == "__main__":
    main()
