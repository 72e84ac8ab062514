#!/usr/bin/env python3
"""Time kernels B, E and F (``tools/mask_tiles_timing.py``) in copies of
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
- ``no_smoothing``: the final passes of B, E and F take one tap of the
  time taps (the correlation's chain of n_taps fmafs per output gone);
- ``f_ieee``: F's three divisions as IEEE divisions, each with its range
  check and branch to the slow path;
- ``f_batch8``, ``f_batch2``: F's final pass in batches of 8 or 2
  frames, not 4;
- ``f_seg48``, ``f_seg56``: F with segments of 48 or 56 frames, not 64
  (a tile of 27 or 31 KB: 8 or 7 blocks an SM, not 6);
- ``ring_chain``: the tap chain of B, E and F with its window of GROUP
  raw values as a ring (taps in runs of GROUP, constant slots, no
  register moves);
- ``f_partials_no_captures``, ``f_partials_float_sum``,
  ``f_partials_no_store``: F's partials without the four offset
  captures, with a float sum, or without the |Z| store;
- ``f_skeleton``: F's final pass with only its loads, stores and tile
  (no floor, sigmoid or tap chain); ``f_skeleton_no_far_reads``: that
  without the reads n frames away;
- ``f_no_far_reads``: F's final pass takes its own frame's |Z| as the
  entering and the leaving frame (no reads n frames away);
- ``f_no_sigmoid``: F's final pass stores |Z| - ma in place of the
  sigmoid of the ratio (the compiler drops the divisions and the exp);
- ``f_no_prefix``: F's floor from the three frames' |Z| in float32 (no
  float64 arithmetic or conversions in the final pass);
- ``g_skeleton``: kernel G without its walks (every region empty): its
  loads, scans, the mask pass over floors left unset, and its stores;
- ``g_no_sigmoid``: G's mask pass stores w + |Z| in place of the sigmoid
  of the ratio (no division, exp or reciprocal);
- ``g_blocks4``, ``g_blocks6``: G built for at least 4 or 6 blocks an SM
  (at most 64 or 40 registers), not 8;
- ``g_one_column``: G's resident route with one column a block at every
  T (geometry.py), not several a block for short columns;
- ``bf16_batch16``: the bfloat16 walk (``time_tiles.cuh::walk``: B's and
  F's partials, every pass of E) in batches of 16 frames (as many bytes
  in flight as float32's 8), not 8;
- ``bf16_stage_walk``: B's final pass stages bfloat16 re/im through the
  walk (batches of loads into registers, widened, stored), not as 4-byte
  words copied with ``cp.async``;
- ``c_span_blocks``: kernel C's design (a), ``tools/variants/
  freq_smooth_blend_spans.cu`` in place of ``csrc/freq_smooth_blend.cu``:
  one block a span, no asynchronous copies (the package's design (b):
  persistent blocks, each loading its next span with ``cp.async`` while
  it smooths this one).

``--cases`` and ``--dtype`` go to ``tools/mask_tiles_timing.py`` (G alone:
``--cases 5,6,8``; C at its four shapes: ``--cases 7,9,10,11``; the
bfloat16 builds of B, E and F: ``--dtype bfloat16 --cases 0,1,2,3,4``).

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
    "g_skeleton": [("fm_nonstationary_mask.cu",
                    "const int n = live ? max(0, min(lane_len, tl - r0)) : 0;",
                    "const int n = 0;")],
    "g_no_sigmoid": [("fm_nonstationary_mask.cu",
                      "const float y = 1.f + expf(-((ratio_of(mag, w) - thresh) * slope));\n"
                      "return isinf(y) ? 0.f : div_by(1.f, y, rcp_refined(y));",
                      "return w + mag;")],
    "g_blocks4": [("fm_nonstationary_mask.cu", "constexpr int MIN_BLOCKS = 8;",
                   "constexpr int MIN_BLOCKS = 4;")],
    "g_blocks6": [("fm_nonstationary_mask.cu", "constexpr int MIN_BLOCKS = 8;",
                   "constexpr int MIN_BLOCKS = 6;")],
    "g_one_column": [("../geometry.py", "for cols in (8, 4, 2, 1):", "for cols in (1,):")],
    "bf16_batch16": [("time_tiles.cuh", "constexpr int BATCH = UNROLL;",
                      "constexpr int BATCH = 2 * UNROLL;")],
    "bf16_stage_walk": [
        ("time_tiles.cuh", "int t_end, float* col, int off) {\n#pragma unroll 4",
         "int t_end, float* col, int off) {\n"
         "  if constexpr (!std::is_same<T, float>::value) {\n"
         "    walk(re, im, base, n_bins, t_begin, t_end, [&](int t, float zr, float zi) {\n"
         "      float* cy = col + 2 * (t + off) * TILE_COLS;\n"
         "      cy[0] = zi;\n"
         "      cy[TILE_COLS] = zr;\n"
         "    });\n"
         "    return;\n"
         "  }\n"
         "#pragma unroll 4"),
        ("time_tiles.cuh",
         "return planes::element_of(__float_as_uint(slot), at0 ^ ((unsigned)t & step));",
         "return slot;"),
    ],
    # a whole source in place of the package's (no pattern)
    "c_span_blocks": [("freq_smooth_blend.cu", None, "tools/variants/freq_smooth_blend_spans.cu")],
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
    "f_ieee": [
        ("torch_nonstationary_mask.cu",
         "const float ratio = ratio_of(own[u], ma[u]);",
         "const float ratio = (own[u] - ma[u]) / (ma[u] == 0.f ? 1.f : ma[u]);"),
        ("torch_nonstationary_mask.cu",
         "const float y = 1.f + expf(-div_sat(ratio - n_thresh, temp, r_temp));",
         "const float y = 1.f + expf(-((ratio - n_thresh) / temp));"),
        ("torch_nonstationary_mask.cu",
         "const float sg = isinf(y) ? 0.f : div_by(1.f, y, rcp_refined(y));", "const float sg = 1.f / y;"),
    ],
    "f_batch8": [("torch_nonstationary_mask.cu", "constexpr int BATCH = 4;",
                  "constexpr int BATCH = 8;")],
    "f_batch2": [("torch_nonstationary_mask.cu", "constexpr int BATCH = 4;",
                  "constexpr int BATCH = 2;")],
    "f_seg48": [("../geometry.py", "SEG_F = 64", "SEG_F = 48"),
                ("torch_nonstationary_mask.cu", "constexpr int SEG = 64;",
                 "constexpr int SEG = 48;")],
    "f_seg56": [("../geometry.py", "SEG_F = 64", "SEG_F = 56"),
                ("torch_nonstationary_mask.cu", "constexpr int SEG = 64;",
                 "constexpr int SEG = 56;")],
    "ring_chain": [("time_tiles.cuh", """    for (int d = 0;; ++d) {
      const float tap = taps ? __ldg(taps + d) : 1.f;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) acc[g] = fmaf(tap, win[g], acc[g]);
      if (d + 1 == n_taps) break;
#pragma unroll
      for (int g = 0; g + 1 < GROUP; ++g) win[g] = win[g + 1];
      win[GROUP - 1] = *p;  // frame t - n_taps/2 + GROUP + d
      p += stride;
    }""", """    for (int d0 = 0; d0 < n_taps; d0 += GROUP) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (d0 + j == n_taps) break;
        const float tap = taps ? __ldg(taps + d0 + j) : 1.f;
#pragma unroll
        for (int g = 0; g < GROUP; ++g) acc[g] = fmaf(tap, win[(g + j) % GROUP], acc[g]);
        if (d0 + j + 1 < n_taps) win[j] = p[(d0 + j) * stride];
      }
    }""")],
    "f_partials_no_captures": [("torch_nonstationary_mask.cu", """         if (u == o.x) sx = s;
         if (u == o.y) sy = s;
         if (u == o.z) sz = s;
         if (u == o.w) sw = s;""", "")],
    "f_partials_float_sum": [
        ("torch_nonstationary_mask.cu", "double s = 0.0, sx = 0.0, sy = 0.0, sz = 0.0, sw = 0.0;",
         "float s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;"),
        ("torch_nonstationary_mask.cu", "s += (double)m;", "s += m;")],
    "f_partials_no_store": [("torch_nonstationary_mask.cu",
                             "mag[c.base + (long long)t * n_bins] = m;", "(void)mag;")],
    "f_no_far_reads": [
        ("torch_nonstationary_mask.cu",
         "e[u] = __ldg(z + (at + enter_off));", "e[u] = o[u];"),
        ("torch_nonstationary_mask.cu",
         "l[u] = __ldg(z + (at - leave_off));", "l[u] = o[u];"),
    ],
    "f_no_sigmoid": [(
        "torch_nonstationary_mask.cu",
        "const float sg = isinf(y) ? 0.f : div_by(1.f, y, rcp_refined(y));",
        "const float sg = own[u] - ma[u];",
    )],
    "f_no_prefix": [("torch_nonstationary_mask.cu",
                     "ma[u] = (float)((a.value() - b.value()) * inv_n);",
                     "ma[u] = (own[u] + enter[u] + leave[u]) * 0.25f;")],
}


# F's final pass reduced to its loads and stores (floor, sigmoid and taps out)
VARIANTS["f_skeleton"] = VARIANTS["no_smoothing"] + VARIANTS["f_no_sigmoid"] + VARIANTS["f_no_prefix"]
VARIANTS["f_skeleton_no_far_reads"] = VARIANTS["f_skeleton"] + VARIANTS["f_no_far_reads"]


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
        for f, old, new in VARIANTS[name]:
            if old is None:
                shutil.copyfile(ROOT / new, d / CSRC / f)
        # the code to edit, whatever its indentation
        edits = [(f, r"\s+".join(map(re.escape, old.split())), new.replace("\\", "\\\\"))
                 for f, old, new in VARIANTS[name] if old is not None]
    for file, pattern, repl in edits:
        p = d / CSRC / file
        src, n = re.subn(pattern, repl, p.read_text(), count=1)
        if n != 1:
            sys.exit(f"variant {name}: {p.name} no longer holds the code it edits")
        p.write_text(src)
    return d


def main() -> None:
    args = sys.argv[1:]
    cases = []
    for flag in ("--cases", "--dtype"):
        if flag in args:
            i = args.index(flag)
            cases, args = cases + [flag, args[i + 1]], args[:i] + args[i + 2:]
    names = args or list(VARIANTS)
    for name in names:
        if name not in VARIANTS and not (name.startswith("tiles:") and name.count(":") == 4):
            sys.exit(f"unknown variant {name}")
    for name in names:
        d = build_copy(name)
        print(f"== variant {name}", flush=True)
        run = subprocess.run(
            [sys.executable, str(ROOT / "tools/mask_tiles_timing.py"), "--reps", "5", *cases],
            env=dict(os.environ, PYTHONPATH=str(d)), capture_output=True, text=True)
        print("\n".join(line for line in run.stdout.splitlines() if not line.startswith("{")),
              flush=True)
        if run.returncode:
            sys.exit(run.stderr[-3000:])


if __name__ == "__main__":
    main()
