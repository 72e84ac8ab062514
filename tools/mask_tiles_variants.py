#!/usr/bin/env python3
"""Time kernels B and E (``tools/mask_tiles_timing.py``) in copies of
``noisereduce_tpu_torch`` with other time tiles, or with one piece of the
final passes' work taken out, to see where their time goes. The copies go
under ``$TMPDIR``; the repository's sources are not touched. The copies
that take work out give wrong masks by design: only their times mean
anything.

    python3 tools/mask_tiles_variants.py base tiles:32:64:32:4 no_sigmoid

- ``base``: the sources as they are;
- ``tiles:SEG_B:SEG_E:COLS:SEGS``: segments of SEG_B frames for B and
  SEG_E for E (multiples of 8), and final-pass blocks of COLS columns by
  SEGS segments (geometry.py and the three CUDA sources);
- ``no_sigmoid``: B's final pass stores w + |Z| in place of the sigmoid
  of (|Z| - w) / w' (no division, exp or reciprocal);
- ``float_carries``: B's final pass runs its y and w recurrences in
  float32 (no float64 arithmetic, no float <-> double conversions);
- ``no_smoothing``: the final passes of B and E take one tap of the
  time taps (the correlation's chain of n_taps fmafs per output gone).

Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = "noisereduce_tpu_torch/ops/cuda/csrc"
VARIANTS = {
    "base": [],
    "no_sigmoid": [(
        "nonstationary_mask.cu",
        "    const float ratio = (cy[TILE_COLS] - w) / (w == 0.f ? 1.f : w);\n"
        "    const float z = (ratio - thresh) * slope;\n"
        "    cy[0] = 1.f / (1.f + expf(-z));",
        "    cy[0] = w + cy[TILE_COLS];",
    )],
    "float_carries": [
        ("nonstationary_mask.cu",
         "y = (t == 0) ? (double)mag : fma(a, y, bd * mag);",
         "y = (t == 0) ? mag : fmaf((float)a, (float)y, (float)bd * mag);"),
        ("nonstationary_mask.cu", "const double yt = cy[0];", "const float yt = cy[0];"),
        ("nonstationary_mask.cu",
         "wd = (t == n_frames - 1) ? yt : fma(a, wd, bd * yt);",
         "wd = (t == n_frames - 1) ? yt : fmaf((float)a, (float)wd, (float)bd * yt);"),
    ],
    "no_smoothing": [("time_tiles.cuh", "for (int d = 0;; ++d) {",
                      "for (int d = n_taps - 1;; ++d) {")],
}


def tile_edits(seg_b: str, seg_e: str, cols: str, segs: str) -> list:
    """Regular-expression edits (file, pattern, replacement) that set the
    time tiles' segment lengths and final-pass block shape."""
    return [
        ("../geometry.py", r"(?m)^TILE_SEGS = \d+", f"TILE_SEGS = {segs}"),
        ("time_tiles.cuh", r"constexpr int TILE_SEGS = \d+;", f"constexpr int TILE_SEGS = {segs};"),
        ("../geometry.py", r"(?m)^SEG_B = \d+", f"SEG_B = {seg_b}"),
        ("../geometry.py", r"(?m)^SEG_E = \d+", f"SEG_E = {seg_e}"),
        ("../geometry.py", r"(?m)^TILE_COLS = \d+", f"TILE_COLS = {cols}"),
        ("nonstationary_mask.cu", r"constexpr int SEG = \d+;", f"constexpr int SEG = {seg_b};"),
        ("stationary_mask.cu", r"constexpr int SEG = \d+;", f"constexpr int SEG = {seg_e};"),
        ("time_tiles.cuh", r"constexpr int TILE_COLS = \d+;", f"constexpr int TILE_COLS = {cols};"),
    ]


def build_copy(name: str) -> pathlib.Path:
    """A copy of the package with variant ``name``'s edits applied."""
    d = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / f"mask_tiles_variant_{name.replace(':', '-')}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "noisereduce_tpu_torch", d / "noisereduce_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if name.startswith("tiles:"):
        edits = tile_edits(*name.split(":")[1:])
    else:
        # the code to edit, whatever its indentation
        edits = [(f, r"\s+".join(map(re.escape, old.split())), new.replace("\\", "\\\\"))
                 for f, old, new in VARIANTS[name]]
    for file, pattern, repl in edits:
        p = d / CSRC / file
        src, n = re.subn(pattern, repl, p.read_text(), count=1)
        if n != 1:
            sys.exit(f"variant {name}: {p.name} no longer holds the code it edits")
        p.write_text(src)
    return d


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS and not (name.startswith("tiles:") and name.count(":") == 4):
            sys.exit(f"unknown variant {name}")
    for name in names:
        d = build_copy(name)
        print(f"== variant {name}", flush=True)
        run = subprocess.run(
            [sys.executable, str(ROOT / "tools/mask_tiles_timing.py"), "--reps", "5"],
            env=dict(os.environ, PYTHONPATH=str(d)), capture_output=True, text=True)
        print("\n".join(line for line in run.stdout.splitlines() if not line.startswith("{")),
              flush=True)
        if run.returncode:
            sys.exit(run.stderr[-3000:])


if __name__ == "__main__":
    main()
