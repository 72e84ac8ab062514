#!/usr/bin/env python3
"""Time kernels A and D (``tools/fft_route_timing.py``) in copies of
``noisereduce_tpu_torch`` that route the FFT route's n_fft to other
kernels, first holding each copy's A and D to their plain versions with
the card tests of ``tests/test_torch_cuda.py``. The copies go under
``$TMPDIR``; the repository's sources are not touched. A copy is built
once a run, so ``base cplx_all cplx_all base`` times each tree twice, in
turns.

    python3 tools/fft_route_variants.py base cplx_all cplx_all base --cells 1024,1536
    python3 tools/fft_route_variants.py base big_block big_block base --cells 12000,16380 --library
    python3 tools/fft_route_variants.py base in_place in_place base --cells 1100,1323,441,1101 --library

- ``base``: the sources as they are;
- ``cplx_all``: the complex-frame kernels (``spectra_cplx.cu``,
  ``istft_cplx.cu``) serve every n_fft of the FFT route, the even
  2^k 3^a 5^b 7^c ones too, in place of the real-FFT kernels
  (``spectra_fft.cu``, ``istft_fft.cu``);
- ``cluster_1024``: the cluster route's blocks of 1024 threads, one an SM,
  in place of 512, two an SM;
- ``big_block``: every n from 4097 to 8191 points with no prime factor
  above 13 and a cluster shape (12000, 16380, odd 4851, ...) back on the
  FFT route's big block, in place of the cluster route;
- ``in_place``: kernel A's blocks of 512 threads without a large radix
  run their stages in place (``fft_smem.cuh::fft_frames``, ``stage``; the
  chirp's two transforms too), as the big block does, in place of out of
  place through their second buffer;
- ``diag_no_large_sums``, ``diag_no_large_stages``: the large radices'
  stages (``fft_smem.cuh::stage_large``) without their sums, or without
  either pass (wrong outputs by design, not held), to see what they cost
  at n_fft 1102;
  (the route variants' card checks leave out the n_fft whose route tests
  expect another route; ``tools/fft_route_timing.py`` holds the outputs
  of every unchunked long cell to the plain versions where it times
  them, ``*_max_dev``);
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
# kernel A's blocks without a large radix back in place (fft_frames, as
# the big block), their second buffer unused
IN_PLACE = [
    ("csrc/spectra_cplx.cu",
     "template <int ODD, bool PAIRED, bool CHIRP, bool BIG, class P>  // P: the plane type\n",
     "template <int ODD, bool PAIRED, bool CHIRP, bool BIG, class P, bool LARGE>\n"),
    ("csrc/spectra_cplx.cu", "const nrf::Plan<MIXED<ODD, BIG>> plan",
     "const nrf::Plan<MIXED<ODD, BIG || !LARGE>> plan"),
    ("csrc/spectra_cplx.cu",
     "    if constexpr (BIG) {\n      nrf::fft_frames<false, ODD>",
     "    if constexpr (BIG || !LARGE) {\n      nrf::fft_frames<false, ODD>"),
    ("csrc/spectra_cplx.cu",
     "      if constexpr (BIG) {\n        nrf::fft_frames<true, ODD>",
     "      if constexpr (BIG || !LARGE) {\n        nrf::fft_frames<true, ODD>"),
    ("csrc/spectra_cplx.cu",
     "[&](auto odd, auto pr, auto ch, auto bg, auto) {",
     "[&](auto odd, auto pr, auto ch, auto bg, auto lg) {\n"
     "      constexpr bool LARGE = decltype(lg)::value;"),
    ("csrc/spectra_cplx.cu",
     "decltype(ch)::value, BIG, T>,",
     "decltype(ch)::value, BIG, T, LARGE>,"),
    ("csrc/spectra_cplx.cu",
     "std::integral_constant<bool, MIXED<ODD, BIG>>());",
     "std::integral_constant<bool, MIXED<ODD, BIG || !LARGE>>());"),
]
VARIANTS = {  # name: [(file under PKG, code, its replacement)]
    "base": [],
    "cplx_all": [
        ("csrc/fft_smem.cuh",
         "if (r == ROUTE_FFT) return slot == n && !real_kernel(n_fft);",
         "if (r == ROUTE_FFT) return slot == n;"),
        ("csrc/fft_smem.cuh",
         "return with_set<1155, 1365, 15015>(odd, build(N(), N(), N()));",
         "return with_set<1, 3, 5, 7, 15, 21, 35, 105, 1155, 1365, 15015>("
         "odd, build(N(), N(), N()));"),
        ("geometry.py",
         "    return (n_fft % 2 == 0 and 2 <= n_fft <= REAL_MAX_NFFT\n"
         "            and _strip(n_fft // 2, REAL_RADICES) == 1)",
         "    return False"),
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
    # every n below 8192 points with a cluster shape back on the big block
    "big_block": [
        ("csrc/fft_route.cuh",
         "  if (n <= BLOCK_SLOTS) return false;\n  for (c = 2;",
         "  if (n < BIG_SLOTS) return false;\n  for (c = 2;"),
        ("geometry.py",
         "    if n <= FFT_ELEMS:\n        return None",
         "    if n < FFT_BIG_ELEMS:\n        return None"),
    ],
    "in_place": IN_PLACE,
    # the large radices' stages without their sums, or without either pass
    "diag_no_large_sums": [
        ("csrc/fft_smem.cuh",
         "  const int rstep = tstep * ns;  // tw index of e^{-2 pi i / R}: 2M / R",
         "  if (m > 0) return;\n  const int rstep = tstep * ns;"),
    ],
    "diag_no_large_stages": [
        ("csrc/fft_smem.cuh",
         "  const int items = (H + 1) * nb;\n  const int base0 = sg.f0 * m;",
         "  if (m > 0) return;\n  const int items = (H + 1) * nb;\n  const int base0 = sg.f0 * m;"),
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
# a variant whose route tests expect another route than the copy takes
# kernel A's complex-frame builds: every route and radix set, and the walk
CPLX_CHECK = ("(routes_match_plain_versions and (nfft1100 or nfft1040 or nfft441 or nfft1323 "
              "or nfft5005 or nfft1102 or nfft1101 or nfft2035 or nfft2036 or nfft4106 or "
              "nfft493 or nfft1235 or nfft8580)) or cplx_walk")
CHECKS = {"big_block": "routes_match_plain_versions and (nfft40000 or nfft32768 or nfft8580)",
          "in_place": CPLX_CHECK}


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
                 "--noconftest", "-q", "-p", "no:cacheprovider", "-k", CHECKS.get(name, CHECK)],
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
