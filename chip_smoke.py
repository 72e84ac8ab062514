#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or more (any failure exits non-zero, and the
last line is printed only when every phase passed):

1. environment: torch version, the card's name and power limit
   (``nvidia-smi``); TF32 off, so the plain versions run in full FP32;
2. build: kernels A-H from ``noisereduce_tpu_torch/ops/cuda/csrc`` with
   ``nvcc`` (seconds printed), A and D on both routes;
3. per kernel, at the headline shapes (77 halo'd 660,000-sample chunk views
   of 48 kHz audio): the kernel against its plain version on the same
   inputs, max |dev| against the bound below, the kernel's, the plain
   version's and one library call's time, and the bound the card's memory
   rate and FP32 rate set (for A and D from the function's own bytes, no
   table); A and D run their FFT route (n_fft 1024, radix 8, 8, 8; the
   real-FFT kernels);
   kernel C also at the 32 x 10 s batch's plane, the split geometry's 129
   taps and 641 taps on 257 bins (wider than the line), each with its
   device time (``queued_ms``) and held bitwise from call to call;
   also kernel A on a
   10 s noise row (the
   threshold spectra), kernel B with one unit tap (the staged mask), and
   B and E with a halo past their shared-memory tiles (801 and 1601 time
   taps, on 8 of the views: the separate smoothing launch); B's and E's
   lines also give the kernel's time over its bound and the CUDA launches
   one wrapper call makes (segment partials, column combine, final pass);
   then, under torch conventions (the gate ``reduce_noise(use_torch=True)``
   runs), A with the torch table, F, E with each view's own statistics and
   D with the torch tail (F's line gives the CUDA launches of one call and
   a line after it their device ms from a ``torch.profiler`` trace; F is
   also held at n_movemean 1,875, time_constant_s 10, and at an even
   window, 374); and kernel G on the same spectra laid out
   frequency-major, (77, 513, 2579) complex64, on its resident route and
   on its tiled route forced, then on the tiled route that a longer column
   takes (the first 160 s unchunked, 30,001 frames), and on short columns
   that a block holds several of: the training batch of 256 clips of 4 s,
   here at 16 kHz with n_fft 512 / hop 128 (256 x 257 x 501, 4 columns a
   block), each line with the route, the CUDA launches, the device ms by
   kernel and the bandwidth reached; then the bf16 mode's builds of A, B,
   E, D and (torch convention) A, F, D on the headline signal cast to
   bf16, each against its plain version on the same bf16 inputs (A's
   planes and D's output: each element equal, or one bf16 ulp apart, plus
   the float32 bound; the masks at the float32 bounds, the threshold
   float32), timed beside its float32 twin, with the bound of the bf16
   bytes it moves;
4. golden: ``reduce_noise(..., device="cuda")`` in float32 on
   ``tests/golden/golden_v1.npz`` (44.1 kHz): the two non-stationary, the
   four stationary and the two torch-convention configurations against the
   reference outputs;
5. headline: 960 s of 48 kHz mono (tones plus non-stationary noise, from a
   seed) through ``reduce_noise`` with its defaults, against the port's
   staged plain path on the card; the signal reaches the card through
   pinned slabs (``parallel/transfer.py``) and its 77 chunks run in
   ``HEADLINE_PIECES`` pieces, each launching each kernel once as soon as
   its slabs have arrived, its cores sent back behind it; the output
   bitwise the one-copy path's (the signal on the card whole, then the
   same gate); the same from float64 (cast to float32 by the host's native
   copy), int16, float16, uint8 and bfloat16 callers, each bitwise its
   one-copy path (numpy's cast of its float32 output), the float64 output
   widened and the int16, float16 and uint8 outputs narrowed on the card
   (kernel H, ``output_cast``, once a piece), each the call's pinned
   output; a ``host:`` line (the NUMA nodes and their CPUs, the card's node, the
   process's affinity, the huge page mode, the nodes that hold the ring's
   and the signal's pages; ``parallel/host_copy.py``), and the call's split
   on a line of its own (host wall, the host's copy into pinned memory and
   its GB/s, H2D, kernels, D2H, pieces, the overlaps; ``torch.profiler``)
   for the float32, float64 and int16 headlines; kernel H on the int16
   headline's cores (its 4 pieces' launches) against its plain version on
   the card and numpy's ``astype`` on the same host, bitwise, for each dtype it writes
   (int16, int8, uint8, uint16, int32, float16), timed beside
   ``tensor.to(torch.int16)`` (whose values past int32's range and at NaN
   and infinities are printed beside H's and numpy's) and its bytes bound; wall time as the minimum of 3 runs after a warm-up
   (CUDA events); then the same call with ``max_parallel_chunks=8`` (10
   host-driven groups of chunks, the pieces, each kernel launched once a
   group), bitwise the default call's output, with the peak device memory
   each call adds (``torch.cuda.max_memory_allocated``; a group holds
   fewer chunks than a default piece) and its time;
6. stationary headline: the same signal with a separate 10 s noise clip,
   ``stationary=True``, the same way;
7. batch: ``reduce_noise_batch`` on 32 clips of 10 s, stationary with
   self-noise, against the per-signal calls and bitwise the one-copy path
   (the clips stacked on the card first);
8. staged geometry: hop 300 with a 1024 window, which kernels A-D do not
   serve, through the staged path with kernel B's mask;
9. split geometry: a frequency smoothing wide enough that the JAX package
   takes its split path, on both engines;
10. torch headline: the headline signal through
    ``reduce_noise(use_torch=True)`` (kernels A, F, C, D) against the
    staged plain path of the torch convention on the card, timed;
11. torch stationary headline with the 10 s noise clip (A twice, E, C, D),
    timed, held to the plain path as the stationary headline is;
12. torch batch: ``reduce_noise_batch(..., use_torch=True,
    stationary=True)`` on the 32 clips, each its own statistics, against
    the per-signal calls, timed;
13. torch staged geometry: hop 300, which A and D do not serve, through
    the plain STFT and iSTFT around F and C, against the staged plain path;
    then the cells of A's and D's other routes (``FFT_CELLS``), each
    through ``reduce_noise`` against the staged plain path, its launches
    counted by route, then A and D against their plain versions at its
    shapes beside ``torch.stft`` / ``torch.istft``, in both conventions:
    n_fft 1536 / hop 384 (M = 768
    = 2^8 x 3, the real-FFT kernels' radix 8, 8, 4, 3) on the first 60 s
    of the headline signal and on all 960 s (timed end to end); n_fft
    1100 / hop 275 (M = 550 = 2 x 5^2 x 11, the complex-frame kernels with
    a radix-11 stage) the same way; n_fft 1323 / hop 441 at 44.1 kHz (odd,
    3^3 x 7^2: two frames a complex transform), 60 s; n_fft 1102 / hop 551
    at 44.1 kHz (M = 551 = 19 x 29: the FFT route's radix-19 and -29
    stages, ``stage_large``), 60 s; n_fft 1101 / hop 367 at 44.1 kHz (3 x
    367: the chirp-z route), 60 s; and n_fft 40 / hop 10 at 8 kHz (5 ms
    frames: the real-FFT kernels, 204 frames a tile and a group, runs of
    201 hop blocks; the DFT products before them), 60 s, then A and D
    alone on the same 60 s at the other frames below 64 samples
    (``SMALL_ROUTE_CELLS``: n_fft 2, 16, odd 3 and 63, 34 and 62 with
    radix 17 and 31, the chirp at 37), with the complex-frame builds'
    registers and spills (``ptxas -v``), and on one line the real-FFT
    builds' (``spectra_fft.cu``, ``istft_fft.cu``) with A's and D's
    persistent grids at the headline (``K.real_capacity``); then the long frames
    (``LONG_CELLS``) the same way: n_fft 8580
    / hop 2145 on 60 s (the big block, its persistent grid printed), 40000
    / hop 10000 and 4803 / hop 1601 (3 x 1601: the cluster chirp route) on
    400,000 samples, each of the last two also through the stationary and
    torch engines against the CPU path, with the cluster builds' registers
    and spills (``ptxas -v``, the chirp builds' sources on lines of their
    own); and the global chirp route (``csrc/spectra_global.cu``,
    ``csrc/istft_global.cu``: a chirp-z transform over a four-step FFT
    through device memory): n_fft 40005 / hop 8001 (odd, 0.83 s) on
    400,000 samples, 65538 / hop 21846 and 192000 / hop 48000 (4 s frames,
    whose DFT-product table alone would take 147 GB) on 60 s, then 40005
    on all 960 s, A and D alone in reduce_noise's 77 views (a counted path
    of their own, ``GLOBAL_960``), with the global builds' registers and
    spills;
14. bf16 (``bf16_route_phase``, ``bf16_phase``): A and D's bf16 builds on
    every route (the 60 s cells of n_fft 1536, 1100, 1323, 1102, 1101 and
    the 5 ms frames' n_fft 40), held and timed as above; the H2D of the bf16
    signal through pinned slabs, cast on the host against cast on the card;
    the headline, the
    stationary headline and the torch headline with
    ``compute_dtype=torch.bfloat16``, each launching the bf16 builds of A,
    B or E or F and D only (C float32), within the envelope of the float32
    output (tests/test_bfloat16_mode.py's), wall (min of 3, CUDA events)
    and device time (the path's kernels on a card-resident signal, the
    host's launch work hidden) beside the float32 call's; the
    grouped bf16 headline, bitwise the one-launch one; ``TPUGate`` at
    batch 256 of 4 s, bf16 in and out; the kernels JSON line lists the bf16
    builds as ``<kernel>_bf16``;
15. streaming (``streaming_phase``): the headline signal written as a
    PCM16 WAV (92 MB) through ``reduce_noise_file`` (77 chunks, one launch
    of A, B, C and D each a chunk, the native IO runtime required), held to
    ``reduce_noise`` on the samples the file holds within the end-to-end
    bound (bitwise printed), its PCM16 output equal to the host quantize of
    its float output, its wall time (min of 3) and the wall split by stage
    (reads, H2D, device, D2H, writes, each alone over all chunks); then on
    the first 60 s: the stationary engine with the first chunk's threshold
    and with the whole file's (two streamed passes; that threshold held to
    the in-memory one at atol 1e-4, rtol 1e-5 and the output to the
    in-memory gate given it), and ``use_torch=True``, each held to its
    in-memory call and timed; ``StreamingGate`` (blocks of 4,800, 1,024
    samples of lookahead, irregular feeds, flush) held to
    ``reduce_noise(chunk_size=4800, padding=1024)``, with ms per block
    (events and host wall) against the 100 ms block period; and
    ``python -m noisereduce_tpu_torch`` in a subprocess, its output equal
    to ``reduce_noise_file``'s;
16. mesh (``mesh_phase``): the headline, the stationary headline and the
    torch headline with ``mesh=chunk_mesh()`` and with ``(cuda:0,) * 4``,
    the headline on the latter also with ``max_parallel_chunks=8``, and
    the 960 s file through ``reduce_noise_file(mesh=(cuda:0,) * 4)``, each
    bitwise its ``mesh=None`` call with each kernel launched once a piece
    of a shard (each device's slice staged through pinned slabs, its
    chunks in pieces; per-device counts), timed and its peak device memory
    beside the ``mesh=None`` call's;
17. gradient: the fused masks of TPU rows 6 (kernel G, frequency-major)
    and 7 (kernel B, one unit tap) under grad on an 8-view plane; the
    training step of ``TPUGate(sr=16000, nonstationary=True)``, loss
    mean(gate(x)**2), at batch 16 and 256 of 4 s; ``gate_nonstationary``
    and ``gate_stationary`` the same way; each time, under
    ``NRTPU_COTANGENT_PRECISION=highest``, the value under grad against
    the ``torch.no_grad()`` value (bitwise), the launches of the forward
    pass (the backward pass launches none), the gradient against the
    float64 staged twin on the card, and forward + backward timed; then in
    the default mode (the bf16 cotangent) the value again bitwise, the
    gradient not equal to ``highest``'s and within 5e-2 of it in
    ||dev|| / ||ref|| (``TPUGate`` also in max|dev| / max|ref|, as the JAX
    package's bench asserts), and the ``TPUGate`` step timed in both
    modes; then the
    notebook-3.0 loop, a 31-tap FIR in front of the gate trained for 5
    Adam steps at batch 256 in the default mode;
18. one JSON line of per-kernel results, then the last line
    ``{"ok": true, "device": {...}}``.

Each path's launches are counted from 0 just before it runs and read just
after, A's and D's also by route: every path must launch them on its
geometry's route only (the FFT route at 1024, 2048 in the golden set,
1536, 1100, 1323, 1102 and 40; the chirp-z route at 1101; the global
chirp route at 40005, 65538 and 192000).
The kernels JSON line lists A and D by route (``fft_route``). Stationary
outputs are binary-threshold gates: a cell whose dB value
lies within float32 resolution of the threshold may decide either way in
two float32 implementations, and one such cell moves the output by ~1e-3 of
its peak. So a stationary path is held to the plain path twice: as it is,
and with the plain path taking the kernels' decision at the cells within
``BORDER_DB`` of the threshold; every decision that differs must lie there,
and the second comparison must hold the end-to-end bound.

Imports nothing of JAX or of the JAX package ``noisereduce_tpu``.
"""
from __future__ import annotations

import collections
import json
import os
import re as regex
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SR = 48000
HEADLINE_SECONDS = 960
NOISE_SECONDS = 10
CHUNK, PADDING = 600000, 30000
# the grouping phase: the headline's 77 chunks in groups of this many
GROUP_CHUNKS = 8
# the pieces the headline's 77 chunks run in, each launching each kernel
# once (parallel/transfer.py: piece_chunks)
HEADLINE_PIECES = 4
# streaming: the other file engines and StreamingGate on the first 60 s;
# the gate in blocks of 100 ms with 1,024 samples of lookahead, fed in
# pieces of these lengths in turn
STREAM_SECONDS = 60
BLOCK, BLOCK_PAD = 4800, 1024
FEEDS = (1000, 7919, 4800, 333, 12000)
BATCH_CLIPS, BATCH_SECONDS = 32, 10
STAGED_SR, STAGED_SECONDS, STAGED_KW = 16000, 30, dict(n_fft=1024, hop_length=300)
# n_grad_freq 64: the merged TPU kernel's frequency halo (66 bins) leaves
# under 16 owned bins per 128-lane tile, so the JAX package splits the gate
SPLIT_SR, SPLIT_SECONDS, SPLIT_KW = 16000, 30, dict(freq_mask_smooth_hz=2000)
# The cells of A's and D's other routes, each a path through reduce_noise
# (non-stationary) on the first `seconds` of the headline signal at `sr`
# (48 kHz: the headline's own samples), then A and D against their plain
# versions at its shapes beside torch.stft / torch.istft, in both
# conventions: (label, sr, seconds, STFT arguments, route,
# the JSON entry of A and D it times, or None). A 960 s cell's entry also
# carries the 60 s cell of the same geometry before it.
FFT_CELLS = (
    # 1536 / 2 = 2^8 x 3: the real-FFT kernels with a radix-3 stage
    ("mixed radix geometry", SR, 60, dict(n_fft=1536, hop_length=384), "fft", None),
    ("mixed radix headline", SR, 960, dict(n_fft=1536, hop_length=384), "fft", "mixed_radix"),
    # 1100 / 2 = 2 x 5^2 x 11: the complex-frame kernels with a radix-11 stage
    ("radix-11 geometry", SR, 60, dict(n_fft=1100, hop_length=275), "fft", None),
    ("radix-11 headline", SR, 960, dict(n_fft=1100, hop_length=275), "fft", "radix11"),
    # 30 ms at 44.1 kHz, 1323 = 3^3 x 7^2: odd, two frames a transform
    ("odd geometry", 44100, 60, dict(n_fft=1323, hop_length=441), "fft", "odd"),
    # 25 ms at 44.1 kHz, 1102 / 2 = 551 = 19 x 29: the FFT route's large
    # radices (fft_smem.cuh::stage_large), the chirp-z route before them
    ("large radix geometry", 44100, 60, dict(n_fft=1102, hop_length=551), "fft",
     "large_radix"),
    # 1101 = 3 x 367 (a prime factor above 31): the chirp-z route
    ("chirp geometry", 44100, 60, dict(n_fft=1101, hop_length=367), "chirp", "chirp"),
)
# an n_fft below 64 (5 ms frames at 8 kHz): A and D take the FFT route's
# real-FFT kernels, a block's 204 frame slots a tile and a group (the DFT
# products before them)
SMALL_SR, SMALL_SECONDS, SMALL_KW = 8000, 60, dict(n_fft=40, hop_length=10)
# frames below 64 samples on the other kernels and routes they take, A and
# D alone on the same 60 s (its JSON entries' "routes"): (label, STFT and
# smoothing arguments, route). The real-FFT kernels with no stage (n_fft 2,
# 4,096 frames a tile) and at a power of two (16); the complex-frame
# kernels at odd 3 and 63 and with radix 17 and 31 (34, 62); the chirp-z
# route at odd prime 37 (L = 81). Bins 2-4 kHz apart (n_fft 2, 3) or 500
# Hz (16) need a frequency smoothing of at least two of them.
SMALL_ROUTE_CELLS = (
    ("n_fft 2", dict(n_fft=2, hop_length=1, freq_mask_smooth_hz=8000), "fft"),
    ("n_fft 16", dict(n_fft=16, hop_length=4, freq_mask_smooth_hz=1000), "fft"),
    ("n_fft 3", dict(n_fft=3, hop_length=1, freq_mask_smooth_hz=8000), "fft"),
    ("n_fft 63", dict(n_fft=63, hop_length=21), "fft"),
    ("n_fft 34", dict(n_fft=34, hop_length=17), "fft"),
    ("n_fft 62", dict(n_fft=62, hop_length=31), "fft"),
    ("n_fft 37", dict(n_fft=37, hop_length=1), "chirp"),
)
# The long frames, each a path through reduce_noise on the first `samples`
# of the headline signal, then A and D against their plain versions at its
# shapes beside torch.stft / torch.istft: (label, sr, samples,
# STFT and smoothing arguments, route, JSON entry of A and D). A hop past
# 50 ms needs a time smoothing of at least one hop: 500 ms.
LONG_CELLS = (
    # 8580 / 2 = 4290 = 2 3 5 11 13 (0.18 s at 48 kHz, no cluster shape):
    # the FFT route's big block (complex-frame kernels, one frame a block of
    # 1024 threads, persistent blocks walking the tiles; a 13-smooth n past
    # a block with a cluster shape, 12000 and 16384, takes the cluster
    # route, which ran kernels A and D together faster)
    ("long frames n_fft 8580", SR, 60 * SR,
     dict(n_fft=8580, hop_length=2145, time_mask_smooth_ms=500), "fft", "big"),
    # 40000 / 2 = 20000 = 2^5 5^4: the cluster route, 4 blocks, 100 x 200;
    # kernel C's lines of 20,001 bins in pieces (ROADMAP F8)
    ("long frames n_fft 40000", SR, 400_000, dict(n_fft=40000, time_mask_smooth_ms=500),
     "cluster", "cluster"),
    # 4803 = 3 x 1601 (a 100 ms window, odd, a prime factor above 13): the
    # cluster chirp route, a chirp length of 9720 = 2^3 3^5 5 on 2 blocks,
    # 90 x 108, two frames a slot
    ("long frames n_fft 4803", SR, 400_000, dict(n_fft=4803, hop_length=1601),
     "cluster_chirp", "cluster_chirp"),
    # 40005 = 3^2 5 7 127 (0.83 s frames, odd, a prime factor above 13,
    # past 32,768 points): the global chirp route, a chirp length of 81,000
    # = 270 x 300 through device memory, two frames a slot; then the same
    # geometry on all 960 s (GLOBAL_960: A and D alone, once)
    ("long frames n_fft 40005", SR, 400_000,
     dict(n_fft=40005, hop_length=8001, time_mask_smooth_ms=500), "global_chirp",
     "global_chirp"),
    # 65538 (1.37 s frames): n = 32,769 = 3^2 11 331, just past 32,768
    # points, even; L = 65,610 = 243 x 270
    ("long frames n_fft 65538", SR, 60 * SR,
     dict(n_fft=65538, hop_length=21846, time_mask_smooth_ms=500), "global_chirp",
     "global_chirp_65538"),
    # 192000 (4 s frames): n = 96,000 = 2^8 3 5^3, 5-smooth but past a
    # cluster's 65,536 points; L = 192,000 = 400 x 480 (a DFT product's
    # table alone would take 147 GB); 2 s of time smoothing (at least a hop)
    ("long frames n_fft 192000", SR, 60 * SR,
     dict(n_fft=192000, hop_length=48000, time_mask_smooth_ms=2000), "global_chirp",
     "global_chirp_192000"),
)
# the global chirp route's throughput cell: the first LONG_CELLS geometry
# of that route on all HEADLINE_SECONDS, A and D alone in reduce_noise's 77
# views (its JSON entry)
GLOBAL_960 = "global_chirp_960"
# kernel F at temperatures that are not normal floats (the exact division):
# 0 (a step) and 1e-40 (subnormal: read as a zero, as the JAX package
# divides by it)
F_TEMPS = (0.0, 1e-40)
# the card's published peaks (H100 SXM data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 agreement bounds, each with its reason
BOUNDS = {
    # an FP32 FFT in another order than cuFFT's (the bound the n_fft-term
    # FP32 sums of the earlier DFT products held): x max|ref|
    "spectra": 2e-5,
    # mask units (the mask is in [0, 1]); float64 IIR carry in both, float
    # vs double rounding of the stored floor, amplified by the sigmoid
    # slope of 10: absolute
    "nonstationary_mask": 1e-4,
    # 2n+1 = 11 FMAs of values <= 1: absolute
    "freq_smooth_blend": 1e-6,
    # an FP32 inverse FFT and 4-term overlap-add vs cuFFT's irfft + fold (the
    # bound the earlier DFT products' 4 * 2 * 513-term FP32 sums held): x
    # max|ref|
    "istft_ola": 2e-5,
    # mask units, over the cells whose binary decision agrees: a few FMAs of
    # the time taps in another order: absolute
    "stationary_mask": 1e-5,
    # mask units; float64 window sums in both, rounded once, through a
    # sigmoid of slope 1/temp = 10: absolute
    "torch_nonstationary_mask": 1e-5,
    # mask units, as kernel B for the same reason (the same recurrence and
    # sigmoid; no time smoothing): absolute
    "fm_nonstationary_mask": 1e-4,
}
# kernels A and D under torch conventions: the same FP32 sums as above,
# held tighter: x max|ref|
TORCH_TABLE_BOUND = 1e-5
RELATIVE = {"spectra", "istft_ola"}
# kernel E: the share of cells that may differ by more than its bound (a
# dB value within float32 resolution of the threshold decides either way;
# NOTES.md:638-639)
FLIP_SHARE = 1e-5
# a decision may differ only where |dB - threshold| is below the float32
# resolution of the threshold statistics (tests/test_fused_pipeline.py:265)
BORDER_DB = 2e-3
# end to end, as tests/test_fused_pipeline.py:55 holds the TPU kernel: x max|ref|
E2E_BOUND = 5e-5
# A and D at the headline: the FFT route's real-FFT kernels (an even n_fft
# whose half is 2^k 3^a 5^b 7^c)
SOURCES = {
    "spectra": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_fft.cu",
    "nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/nonstationary_mask.cu",
    "freq_smooth_blend": "noisereduce_tpu_torch/ops/cuda/csrc/freq_smooth_blend.cu",
    "istft_ola": "noisereduce_tpu_torch/ops/cuda/csrc/istft_fft.cu",
    "stationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/stationary_mask.cu",
    "torch_nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/torch_nonstationary_mask.cu",
    "fm_nonstationary_mask": "noisereduce_tpu_torch/ops/cuda/csrc/fm_nonstationary_mask.cu",
    # kernel H: the int16 headline's output narrowed on the card
    "output_cast": "noisereduce_tpu_torch/ops/cuda/csrc/output_cast.cu",
    # the FFT route at a mixed-radix n_fft (1536, the radix-3 stage)
    "spectra_mixed_radix": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_fft.cu",
    "istft_ola_mixed_radix": "noisereduce_tpu_torch/ops/cuda/csrc/istft_fft.cu",
    # the FFT route's complex-frame kernels: radix 11 (1100), odd (1323)
    "spectra_radix11": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cplx.cu",
    "istft_ola_radix11": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cplx.cu",
    "spectra_odd": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cplx.cu",
    "istft_ola_odd": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cplx.cu",
    # the FFT route's large radices (1102), in the complex-frame kernels
    "spectra_large_radix": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cplx.cu",
    "istft_ola_large_radix": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cplx.cu",
    # the chirp-z route (1101), in the complex-frame kernels
    "spectra_chirp": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cplx.cu",
    "istft_ola_chirp": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cplx.cu",
    # frames below 64 samples (n_fft 40 at 8 kHz): the real-FFT kernels, a
    # block's 204 slots a tile and a group (the DFT products before them)
    "spectra_small": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_fft.cu",
    "istft_ola_small": "noisereduce_tpu_torch/ops/cuda/csrc/istft_fft.cu",
    # past n_fft 8192: the FFT route's big block (8580) and the cluster route (40000)
    "spectra_big": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cplx.cu",
    "istft_ola_big": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cplx.cu",
    "spectra_cluster": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cluster.cu",
    "istft_ola_cluster": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cluster.cu",
    # the cluster chirp route (4803): the chirp builds of the cluster kernels
    "spectra_cluster_chirp": "noisereduce_tpu_torch/ops/cuda/csrc/spectra_cluster_chirp.cu",
    "istft_ola_cluster_chirp": "noisereduce_tpu_torch/ops/cuda/csrc/istft_cluster_chirp.cu",
    # the global chirp route (40005, 65538, 192000, and 40005 on 960 s)
    **{f"{k}_{e}": f"noisereduce_tpu_torch/ops/cuda/csrc/{src}_global.cu"
       for e in ("global_chirp", "global_chirp_65538", "global_chirp_192000", GLOBAL_960)
       for k, src in (("spectra", "spectra"), ("istft_ola", "istft"))},
}
# JSON entries of A and D: (the wrapper that launches them, the route)
ROUTED = {"spectra": ("spectra", "fft"), "istft_ola": ("istft_ola", "fft"),
          "spectra_small": ("spectra", "fft"),
          "istft_ola_small": ("istft_ola", "fft")}
for _label, _sr, _secs, _kw, _route, _entry in FFT_CELLS + LONG_CELLS:
    if _entry:
        ROUTED[f"spectra_{_entry}"] = ("spectra", _route)
        ROUTED[f"istft_ola_{_entry}"] = ("istft_ola", _route)
ROUTED[f"spectra_{GLOBAL_960}"] = ("spectra", "global_chirp")
ROUTED[f"istft_ola_{GLOBAL_960}"] = ("istft_ola", "global_chirp")
# the TPU kernel each replaces (file:line), and the rows of PERF.md's
# kernel table it serves
REPLACES = {
    "spectra": "noisereduce_tpu/ops/pallas/kernels.py:152 (rows 1, 1s, 2, 4, 5); "
               "noisereduce_tpu/ops/pallas/dispatch.py:556 (row 3, both callers)",
    "nonstationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:422 (rows 1, 2); "
                          "noisereduce_tpu/ops/pallas_mask.py:364 (row 7)",
    "freq_smooth_blend": "noisereduce_tpu/ops/pallas/kernels.py:906 (rows 1, 1s, 2, 4); "
                         "noisereduce_tpu/ops/pallas/torch_dispatch.py:537 (row 5)",
    "istft_ola": "noisereduce_tpu/ops/pallas/kernels.py:736 (rows 1, 1s, 2, 4); "
                 "noisereduce_tpu/ops/pallas/torch_dispatch.py:561 (row 5)",
    "stationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:533 (rows 1s, 2, 4; "
                       "self statistics :583); "
                       "noisereduce_tpu/ops/pallas/torch_dispatch.py:526 (row 5)",
    "torch_nonstationary_mask": "noisereduce_tpu/ops/pallas/kernels.py:635 (row 4, "
                                "torch_dispatch.py:382); "
                                "noisereduce_tpu/ops/pallas/torch_dispatch.py:485 (row 5)",
    "fm_nonstationary_mask": "noisereduce_tpu/ops/pallas_mask.py:229 (row 6)",
    "output_cast": "noisereduce_tpu/api.py:630 (no TPU kernel: numpy's astype of the "
                   "output, on the host)",
}
for _name in ROUTED:
    REPLACES[_name] = REPLACES[ROUTED[_name][0]]
# kernel F beside the torch headline's window (375 frames, time_constant_s
# 2): time_constant_s 10 (1,875 frames) and an even window (one more frame
# on the right)
F_WINDOWS = (1875, 374)
# kernel G's long column: this many seconds of the headline signal, one
# unchunked view (30,001 frames; the resident route holds 29,020)
FM_LONG_SECONDS = 160
# kernel G's short columns: the gradient phase's batch of 4 s clips at
# GRAD_SR, taken with n_fft 512 / hop 128 (501 frames, several columns a block)
FM_SHORT_N_FFT = 512
# the gradient phase: the training workload of benchmarks/bench_all.py:316-331
GRAD_SR, GRAD_SECONDS, GRAD_BATCHES = 16000, 4, (16, 256)
# the masks' backward on 8 views of the headline plane (rows 6 and 7)
GRAD_VIEWS = 8
# a float32 gradient against the float64 staged twin's, both on the card
# with TF32 off: float32 rounding of the spectra and of the floor, through
# a sigmoid of slope 10, as the forward is held end to end: x max|ref|
GRAD_BOUND = 5e-5
# the default (bf16) cotangent against the uncast one: ||dev|| / ||uncast||
# for every family, and max|dev| / max|uncast| for TPUGate, the check the
# JAX package asserts on its device (bench.py:424-462). The max of the
# scipy gates' is printed, not held: over 256 x 64,000 samples it reaches
# 6e-2, where the JAX package's own bf16 cotangent of the same twin lands
# as far (PERF.md section 6, PR 14)
COTANGENT_BOUND = 5e-2
FIR_TAPS, FIR_STEPS, FIR_LR = 31, 5, 3e-3
# kernel C beyond the headline, each on kernel B's mask of the headline
# signal's first samples read as `rows` rows of `n` samples at the
# configuration's rate, padded by `pad` zeros each side (reduce_noise pads a
# signal no longer than a chunk so): (label, GateConfig keywords, rows, n,
# pad). The batch path's plane; the split geometry's 129 taps; and 641 taps
# on 257 bins (20 kHz of smoothing at 16 kHz, n_fft 512), wider than a line,
# on the training batch's plane of kernel G's short columns.
C_SHAPES = (
    ("batch 32 x 10 s", dict(sr=SR), BATCH_CLIPS, BATCH_SECONDS * SR, PADDING),
    ("129 taps, split geometry", dict(sr=SPLIT_SR, **SPLIT_KW), 1, SPLIT_SECONDS * SPLIT_SR,
     PADDING),
    ("641 taps on 257 bins", dict(sr=GRAD_SR, n_fft=FM_SHORT_N_FFT, freq_mask_smooth_hz=20000),
     GRAD_BATCHES[-1], GRAD_SECONDS * GRAD_SR, 0),
    # lines past one block: n_fft 40000 at 48 kHz, 20,001 bins, 417 taps, in
    # pieces (A on the cluster route gives the spectra)
    ("20,001 bins in pieces", dict(sr=SR, **LONG_CELLS[1][3]), 1, LONG_CELLS[1][2], PADDING),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 3) -> float:
    """Minimum over ``reps`` runs after one warm-up, CUDA events, ms."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_ms(fn, reps: int = 3, tries: int = 3) -> dict:
    """Mean device time per call of ``fn``, ms, by kernel name: a
    ``torch.profiler`` trace of ``reps`` calls after a warm-up. A trace
    that lost kernels (none at all, or a kernel seen a number of times
    that is not a multiple of ``reps``; one run on the card lost one call
    of three in most of its traces) is taken again, up to ``tries``
    times; then {} (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(float)
        seen = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen[e.name] += 1
                m = regex.search(r"([\w:]+)(?:<[^>]*>)?\(", e.name)
                by_name[m.group(1).lstrip(":") if m else e.name] += e.time_range.elapsed_us() / reps / 1e3
        if seen and all(n % reps == 0 for n in seen.values()):
            return dict(by_name)
    return {}


# a spinning kernel of ~5 ms on an H100's ~2 GHz clock, longer than a
# call's host issue time (0.03-0.4 ms)
SPIN_CYCLES = 10_000_000


def queued_ms(fn, reps: int = 5):
    """The card's time for one call of ``fn``, ms, with the host's launch
    work hidden: a spinning kernel holds the stream while the host issues
    the call, so the start event fires just before the call's first
    kernel (CUDA events, min of ``reps`` after a warm-up). None when the
    host took longer to issue a call than the card to spin, as a call that
    waits for the card does (``torch.istft`` reads its window envelope
    back). Late in this script's run the profiler (``device_ms``) lost
    kernels of most traces on the card, so the route cells time their
    device work this way first."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    spin_ms = start.elapsed_time(end)
    best = None
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < spin_ms / 2:
            ms = start.elapsed_time(end)
            best = ms if best is None else min(best, ms)
    return best


def device_times(label, **fns) -> dict:
    """Each of ``fns``' device time of one call, ms, as
    ``<name>_device_ms``: ``queued_ms``, else the profiler's
    (``device_ms``), else None. A 0.1 ms call's events also hold the
    host's launch work, whose spread between runs may exceed the gap
    between a kernel and its library call."""
    out = {f"{k}_device_ms": queued_ms(fn) or sum(device_ms(fn).values()) or None
           for k, fn in fns.items()}
    print(f"kernel {label} device time: "
          + ", ".join(f"{k} {v:.4f} ms" if v else f"{k} not measured" for k, v in out.items()),
          flush=True)
    return out


def headline_signal(seconds: int, sr: int = SR, seed: int = SEED) -> np.ndarray:
    """Tones (one gated on and off) over noise whose level drifts: the case
    the non-stationary gate is for. float32, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = seconds * sr
    t = np.arange(n, dtype=np.float64) / sr
    gate = (np.floor(t / 2.0) % 2 == 0).astype(np.float64)
    tones = 0.3 * gate * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(
        2 * np.pi * 1250.0 * t
    )
    level = 0.05 + 0.04 * np.sin(2 * np.pi * t / 37.0)
    x = tones + level * rng.standard_normal(n)
    return x.astype(np.float32)


def noise_clip(seconds: int, sr: int = SR, seed: int = SEED + 1) -> np.ndarray:
    """A separate noise recording for the stationary statistics: white noise
    at the headline's mean noise level. float32."""
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal(seconds * sr)).astype(np.float32)


def max_dev(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max()), float(ref.abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: float):
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 rate, ms."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_ops(n_fft: int) -> float:
    """Operations of one real FFT of length n_fft (2.5 N log2 N)."""
    return 2.5 * n_fft * np.log2(n_fft)


def measure(label, lim, fn, ref_fn, got, ref, moved, ops, library_fn=None, scale_bound=False,
            wrapper=None):
    """One kernel against its plain version: max |dev| within ``lim``
    (times max|ref| with ``scale_bound``), the kernel's, the plain
    version's and the library call's times, and the card's bound; with
    ``wrapper`` (B, E), also the CUDA launches one call of it makes. Fails
    on a disagreement; returns the numbers of the kernels JSON line."""
    dev, scale = max_dev(got, ref)
    lim = lim * (scale if scale_bound else 1.0)
    finite = bool(torch.isfinite(got).all())
    ms = time_ms(fn)
    plain_ms = time_ms(ref_fn)
    library_ms = time_ms(library_fn) if library_fn is not None else None
    bound_ms, bound_by = bound(moved, ops)
    lib = f"{library_ms:.3f} ms" if library_ms is not None else "none"
    grid = f", {wrapper.cuda_launches} CUDA launches a call" if wrapper else ""
    print(
        f"kernel {label}: max|dev| {dev:.3e} bound {lim:.3e} "
        f"(max|ref| {scale:.4g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library {lib} card bound {bound_ms:.3f} ms ({bound_by}, "
        f"{moved / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP; kernel {ms / bound_ms:.2f}x "
        f"the bound{grid})",
        flush=True,
    )
    if not finite or not dev <= lim:
        fail(f"kernel {label} disagrees with its plain version")
    out = dict(max_abs_err=dev, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    if wrapper:
        out["cuda_launches"] = wrapper.cuda_launches
    return out


def c_ops(n_rows: int, n_bins: int, n_taps: int) -> float:
    """Kernel C's operations: an FMA for each product of a tap with a bin
    of the output's line (those past the line's ends meet zeros) and two
    for the blend, per output."""
    k = np.arange(n_bins)
    lo = np.maximum(0, k - n_taps // 2)
    hi = np.minimum(n_bins, k + n_taps // 2 + 1)
    return float(n_rows * (2.0 * (hi - lo).sum() + 2 * n_bins))


def c_planes(K, x_cuda: torch.Tensor) -> list:
    """Kernel C's inputs at ``C_SHAPES``: (label, mask, taps, prop) each."""
    from noisereduce_tpu_torch.config import GateConfig
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.dsp import tri_norm

    out = []
    for label, kw, rows, n, pad in C_SHAPES:
        c = GateConfig(**kw)
        y = F.pad(x_cuda[: rows * n].reshape(rows, n), (pad, pad))
        re, im = K.spectra(y, gate_geometry(c.stft, n + 2 * pad))
        ngf, ngt = c.smoothing
        m = K.nonstationary_mask(re, im, c.iir_b, c.thresh_n_mult_nonstationary,
                                 c.sigmoid_slope_nonstationary, tri_norm(ngt))
        out.append((label, m, tri_norm(ngf), c.prop_decrease))
    return out


def fm_route(K, record, label, route, fn, z, ref, mk):
    """Kernel G on one route: against its plain version (``record``, which
    prints its events and the bound), the route that one call took and its
    CUDA launches, its device time by kernel (``torch.profiler``; where the
    trace lost kernels, ``queued_ms``; where that gave nothing too, CUDA
    events around one call, the host's launch work included) and the
    bandwidth that reaches for the function's bytes (Z read once, the mask
    written once). Returns the numbers of the kernels JSON line."""
    K.reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    took = {r: getattr(K.fm_nonstationary_mask, f"{r}_launches") for r in K.FM_ROUTES}
    if took != {r: int(r == route) for r in K.FM_ROUTES}:
        fail(f"kernel {label}: routes {took}, expected {route}")
    moved = nbytes(z, got)
    out = record("fm_nonstationary_mask", fn, lambda: K.fm_nonstationary_mask_ref(z, *mk), got,
                 ref, moved, z.numel() * 30.0, label=label, wrapper=K.fm_nonstationary_mask)
    dev = device_ms(fn)
    dms, src = sum(dev.values()), "profiler"
    how = ", ".join(f"{k} {v:.4f}" for k, v in dev.items())
    if not dms:
        dms, src, how = queued_ms(fn), "queued_ms", "queued_ms: the trace lost kernels"
    if not dms:
        dms, src, how = time_ms(fn, 10), "events", "CUDA events, the host's launch work included"
    out.update(fm_route=route, device_ms=dms, device_ms_from=src, device_by_kernel=dev,
               achieved_gb_per_s=moved / dms / 1e6)
    print(f"kernel {label}: route {route}, {out['cuda_launches']} CUDA launches, device "
          f"{dms:.4f} ms ({how}), {moved / dms / 1e6:.0f} GB/s of the function's "
          f"{moved / 1e9:.3f} GB", flush=True)
    return out


def kernel_phase(x_cuda: torch.Tensor, noise_cuda: torch.Tensor, cfg, scfg):
    """Each kernel against its plain version at the main path's shapes.
    ``cfg`` is the non-stationary configuration, ``scfg`` the stationary
    one (the same STFT geometry and smoothing)."""
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.config import GateConfig
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import (
        fm_mask_plan, freq_smooth_plan, gate_geometry,
    )
    from noisereduce_tpu_torch.ops.dsp import tri_norm
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    ngf, ngt = cfg.smoothing
    tt, tf = tri_norm(ngt), tri_norm(ngf)
    window = torch.hann_window(geo.win, periodic=True, device=x_cuda.device)
    results = {}

    def record(name, fn, ref_fn, got, ref, moved, ops, library_fn=None, label=None,
               wrapper=None):
        r = measure(label or name, BOUNDS[name], fn, ref_fn, got, ref, moved, ops,
                    library_fn, scale_bound=name in RELATIVE, wrapper=wrapper)
        if label is None:
            results[name] = r
        return r

    # A: spectra of the 77 halo'd views, read straight from the signal
    a = (x_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    rre, rim = K.spectra_ref(*a)
    torch.cuda.synchronize()
    views = extract_chunks(x_cuda[None], CHUNK, PADDING).reshape(-1, geo.view_len)
    views = views.contiguous()
    record(
        "spectra", lambda: K.spectra(*a), lambda: K.spectra_ref(*a),
        torch.stack([re, im]), torch.stack([rre, rim]),
        nbytes(x_cuda, re, im), re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            views, geo.n_fft, geo.hop, geo.win, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
    )
    del rre, rim, views

    # A on the noise clip (TPU kernel row 3: the threshold's spectra)
    ngeo = gate_geometry(cfg.stft, noise_cuda.shape[-1])
    an = (noise_cuda[None], ngeo)
    nre, nim = K.spectra(*an)
    nrre, nrim = K.spectra_ref(*an)
    record(
        "spectra", lambda: K.spectra(*an), lambda: K.spectra_ref(*an),
        torch.stack([nre, nim]), torch.stack([nrre, nrim]),
        nbytes(noise_cuda, nre, nim), nre.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            noise_cuda, geo.n_fft, geo.hop, geo.win, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        label="spectra (10 s noise row)",
    )
    del nre, nim, nrre, nrim

    cells = re.numel()
    b = (re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
         cfg.sigmoid_slope_nonstationary, tt)
    m = K.nonstationary_mask(*b)
    rm = K.nonstationary_mask_ref(*b)
    record("nonstationary_mask", lambda: K.nonstationary_mask(*b),
           lambda: K.nonstationary_mask_ref(*b), m, rm,
           nbytes(re, im, m), cells * (30.0 + 2 * len(tt)), wrapper=K.nonstationary_mask)
    del rm

    # B with one unit tap (TPU kernel row 7: the staged path's mask)
    b1 = b[:-1] + ((1.0,),)
    m1 = K.nonstationary_mask(*b1)
    rm1 = K.nonstationary_mask_ref(*b1)
    results["nonstationary_mask"]["unit_tap"] = record(
        "nonstationary_mask", lambda: K.nonstationary_mask(*b1),
        lambda: K.nonstationary_mask_ref(*b1), m1, rm1,
        nbytes(re, im, m1), cells * 32.0, label="nonstationary_mask (unit tap)",
        wrapper=K.nonstationary_mask)
    del m1, rm1

    # B with a halo past its shared-memory tile (time taps of 2 x 400 + 1,
    # e.g. time_mask_smooth_ms=3200 at 16 kHz / hop 128): the raw mask to a
    # plane and the separate smoothing launch; on 8 of the views
    bw = (re[:8], im[:8]) + b[2:-1] + (tri_norm(400),)
    results["nonstationary_mask"]["smoothing_launch"] = record(
        "nonstationary_mask", lambda: K.nonstationary_mask(*bw),
        lambda: K.nonstationary_mask_ref(*bw), K.nonstationary_mask(*bw),
        K.nonstationary_mask_ref(*bw), nbytes(bw[0], bw[1], bw[0]),
        bw[0].numel() * (30.0 + 2 * 801), label="nonstationary_mask (801 taps)",
        wrapper=K.nonstationary_mask)
    if results["nonstationary_mask"]["smoothing_launch"]["cuda_launches"] != 4:
        fail("kernel nonstationary_mask: 801 taps did not take the smoothing launch")

    # G on the same spectra laid out frequency-major (TPU row 6): the plan's
    # route (resident), the tiled route forced at the same shapes, and the
    # tiled route reached by a column too long to hold: the first
    # FM_LONG_SECONDS of the signal unchunked
    mk = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    zf = torch.complex(re, im).transpose(1, 2).contiguous()
    rmg = K.fm_nonstationary_mask_ref(zf, *mk)
    results["fm_nonstationary_mask"] = fm_route(
        K, record, "fm_nonstationary_mask", "resident",
        lambda: K.fm_nonstationary_mask(zf, *mk), zf, rmg, mk)
    results["fm_nonstationary_mask"]["tiled_route"] = fm_route(
        K, record, "fm_nonstationary_mask (tiled route forced)", "tiled",
        lambda: K._fm_mask_on("tiled", zf, *mk), zf, rmg, mk)
    del zf, rmg
    n_long = FM_LONG_SECONDS * SR
    zl = torch.complex(*K.spectra(x_cuda[None, :n_long], gate_geometry(cfg.stft, n_long)))
    zl = zl.transpose(1, 2).contiguous()
    results["fm_nonstationary_mask"]["tiled_long"] = fm_route(
        K, record, f"fm_nonstationary_mask ({tuple(zl.shape)}: tiled)", "tiled",
        lambda: K.fm_nonstationary_mask(zl, *mk), zl, K.fm_nonstationary_mask_ref(zl, *mk), mk)
    del zl
    # short columns: the headline signal's first samples read as
    # GRAD_BATCHES[-1] clips of GRAD_SECONDS at GRAD_SR
    n16 = GRAD_SECONDS * GRAD_SR
    c16 = GateConfig(sr=GRAD_SR, n_fft=FM_SHORT_N_FFT)
    x16 = x_cuda[: GRAD_BATCHES[-1] * n16].reshape(GRAD_BATCHES[-1], n16)
    zs = torch.complex(*K.spectra(x16, gate_geometry(c16.stft, n16))).transpose(1, 2).contiguous()
    ms16 = (c16.iir_b, c16.thresh_n_mult_nonstationary, c16.sigmoid_slope_nonstationary)
    cols = fm_mask_plan(zs.numel() // zs.shape[-1], zs.shape[-1]).cols
    if cols < 2:
        fail(f"kernel G: {tuple(zs.shape)} takes {cols} column a block, not several")
    results["fm_nonstationary_mask"]["short_columns"] = fm_route(
        K, record, f"fm_nonstationary_mask ({tuple(zs.shape)}: {cols} columns a block)",
        "resident", lambda: K.fm_nonstationary_mask(zs, *ms16), zs,
        K.fm_nonstationary_mask_ref(zs, *ms16), ms16)
    del zs, x16

    # C at the headline, then at C_SHAPES (the batch path's plane, 129 taps,
    # 641 taps on 257 bins); every one with prop_decrease 1, where the blend
    # is the identity, so one convolution computes the same function
    def c_record(mc, taps, prop, label=None):
        fn = lambda: K.freq_smooth_blend(mc, taps, prop)
        ref_fn = lambda: K.freq_smooth_blend_ref(mc, taps, prop)
        got = fn()
        taps_t = torch.as_tensor(taps, dtype=torch.float32, device=mc.device).view(1, 1, -1)
        rows = mc.reshape(-1, 1, mc.shape[-1])
        r = record("freq_smooth_blend", fn, ref_fn, got, ref_fn(), nbytes(mc, got),
                   c_ops(mc.numel() // mc.shape[-1], mc.shape[-1], len(taps)),
                   library_fn=lambda: F.conv1d(rows, taps_t, padding=len(taps) // 2),
                   label=label)
        r.update(device_times(label or "freq_smooth_blend", kernel=fn))
        if not torch.equal(got, fn()):
            fail(f"kernel {label or 'freq_smooth_blend'}: two calls differ")
        return got, r

    mb, _ = c_record(m, tf, cfg.prop_decrease)
    # the headline's lines cut into pieces of 45 bins anyway: bitwise the
    # plan of whole lines (a line that fits takes that plan)
    pieces = K._freq_smooth_on(
        freq_smooth_plan(m.numel() // m.shape[-1], m.shape[-1], len(tf), 45), m, tf,
        cfg.prop_decrease)
    print(f"kernel freq_smooth_blend: the headline in pieces of 45 bins bitwise its plan "
          f"of whole lines: {torch.equal(pieces, mb)}", flush=True)
    if not torch.equal(pieces, mb):
        fail("kernel freq_smooth_blend: pieces differ from whole lines")
    del pieces
    results["freq_smooth_blend"]["shapes"] = {
        label: c_record(mc, taps, prop, f"freq_smooth_blend ({label}: {tuple(mc.shape)}, "
                                        f"{len(taps)} taps)")[1]
        for label, mc, taps, prop in c_planes(K, x_cuda)}

    d = (re, im, mb, geo, PADDING, CHUNK)
    y = K.istft_ola(*d)
    ry = K.istft_ola_ref(*d)
    zm = torch.complex(re * mb, im * mb).transpose(1, 2).contiguous()
    record("istft_ola", lambda: K.istft_ola(*d), lambda: K.istft_ola_ref(*d),
           y, ry, nbytes(re, im, mb, y),
           re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
           library_fn=lambda: torch.istft(
               zm, geo.n_fft, geo.hop, geo.win, window, center=True,
               length=geo.view_len))
    del zm, y, ry, m, mb

    # E against its plain version, the threshold from a 10 s noise clip
    thr = stationary_noise_threshold(noise_cuda, scfg)
    e = (re, im, thr, 1, scfg.prop_decrease, tt)
    got = K.stationary_mask(*e)
    ref = K.stationary_mask_ref(*e)
    diff = (got - ref).abs()
    off = diff > BOUNDS["stationary_mask"]
    n_off = int(off.sum())
    rest = float(diff[~off].max())
    dev = float(diff.max())
    ms, plain_ms = time_ms(lambda: K.stationary_mask(*e)), time_ms(lambda: K.stationary_mask_ref(*e))
    bound_ms, bound_by = bound(nbytes(re, im, thr, got), cells * (12.0 + 2 * len(tt)))
    print(
        f"kernel stationary_mask: {n_off} of {cells} cells off by more than "
        f"{BOUNDS['stationary_mask']:.0e} (bound {FLIP_SHARE * cells:.0f}, a "
        f"share of {FLIP_SHARE:.0e}); max|dev| over the rest {rest:.3e} bound "
        f"{BOUNDS['stationary_mask']:.0e}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"library none card bound {bound_ms:.3f} ms ({bound_by}; kernel "
        f"{ms / bound_ms:.2f}x the bound, {K.stationary_mask.cuda_launches} CUDA "
        f"launches a call)",
        flush=True,
    )
    if n_off > FLIP_SHARE * cells or not rest <= BOUNDS["stationary_mask"]:
        fail("kernel stationary_mask disagrees with its plain version")
    results["stationary_mask"] = dict(
        max_abs_err=dev, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, cells_flipped=n_off,
        max_abs_err_unflipped=rest, cuda_launches=K.stationary_mask.cuda_launches,
    )
    del got, ref, diff, off

    # E with a halo past its shared-memory tile (2 x 800 + 1 time taps): the
    # blend to a plane and the separate smoothing launch; on 8 of the views
    ew = (re[:8], im[:8]) + e[2:-1] + (tri_norm(800),)
    diff = (K.stationary_mask(*ew) - K.stationary_mask_ref(*ew)).abs()
    off = diff > BOUNDS["stationary_mask"]
    n_off, rest = int(off.sum()), float(diff[~off].max())
    print(f"kernel stationary_mask (1601 taps): {n_off} of {diff.numel()} cells off by "
          f"more than {BOUNDS['stationary_mask']:.0e}, max|dev| over the rest {rest:.3e}, "
          f"{K.stationary_mask.cuda_launches} CUDA launches a call", flush=True)
    if (n_off > FLIP_SHARE * diff.numel() or not rest <= BOUNDS["stationary_mask"]
            or K.stationary_mask.cuda_launches != 4):
        fail("kernel stationary_mask (1601 taps) disagrees with its plain version")
    results["stationary_mask"]["smoothing_launch"] = dict(
        max_abs_err_unflipped=rest, cells_flipped=n_off,
        cuda_launches=K.stationary_mask.cuda_launches)
    return results


def at_threshold_planes(views: int, frames: int, n_bins: int, device):
    """Planes whose every cell's ratio is exactly 0: |Z| constant along
    time in each bin (1 to 4, exact in every prefix sum; bin 0 silent)."""
    level = (torch.arange(n_bins, device=device) % 4 + 1).float()
    level[0] = 0.0
    re = level.expand(views, frames, n_bins).contiguous()
    return re, torch.zeros_like(re)


def f_at_threshold(K, re, im, taps) -> None:
    """Kernel F with a threshold of 0 on planes where every cell's ratio
    is exactly that threshold (``at_threshold_planes``): at each temp of
    F_TEMPS (a step) 0/0 under the sigmoid, NaN in the same cells as the
    plain version's, the rest within the bound."""
    for temp in F_TEMPS:
        args = (re, im, 375, 0.0, temp, 1.0, taps)
        got, ref = K.torch_nonstationary_mask(*args), K.torch_nonstationary_mask_ref(*args)
        nan_got, nan_ref = torch.isnan(got), torch.isnan(ref)
        keep = ~nan_ref
        dev = float((got[keep] - ref[keep]).abs().max()) if keep.any() else 0.0
        same = torch.equal(nan_got, nan_ref)
        print(f"kernel torch_nonstationary_mask (temp {temp:g}, every cell at the threshold): "
              f"NaN in {int(nan_got.sum())} of {got.numel()} cells, the plain version's "
              f"{int(nan_ref.sum())}, the same cells: {same}; max|dev| over the rest "
              f"{dev:.3e}", flush=True)
        if not same or not nan_ref.any() or not dev <= BOUNDS["torch_nonstationary_mask"]:
            fail(f"kernel torch_nonstationary_mask (temp {temp:g}, at the threshold) "
                 "disagrees with its plain version")


def torch_kernel_phase(x_cuda: torch.Tensor, noise_cuda: torch.Tensor, gate, results) -> None:
    """Kernels A (torch table; on the views and on the 10 s noise row, TPU
    row 3's torch caller), F, E (each view's own statistics) and D (torch
    tail) against their plain versions at the shapes the torch headline
    gives them; ``gate`` is the one ``reduce_noise(use_torch=True)`` builds.
    Adds F's entry to ``results`` and the others' torch numbers to
    theirs."""
    from noisereduce_tpu_torch.ops import dsp
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    geo = gate_geometry(gate.stft_config, CHUNK + 2 * PADDING)
    ft, tt = _rank1_taps(gate.smoothing)
    window = torch.hann_window(gate.win_length, dtype=torch.float32, device=x_cuda.device)

    a = (x_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    rre, rim = K.spectra_ref(*a)
    views = extract_chunks(x_cuda[None], CHUNK, PADDING).reshape(-1, geo.view_len)
    views = views.contiguous()
    results["spectra"]["torch_table"] = measure(
        "spectra (torch table)", TORCH_TABLE_BOUND, lambda: K.spectra(*a),
        lambda: K.spectra_ref(*a), torch.stack([re, im]), torch.stack([rre, rim]),
        nbytes(x_cuda, re, im), re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            views, geo.n_fft, geo.hop, gate.win_length, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        scale_bound=True,
    )
    del rre, rim, views

    ngeo = gate_geometry(gate.stft_config, noise_cuda.shape[-1])
    an = (noise_cuda[None], ngeo)
    nre, nim = K.spectra(*an)
    nrre, nrim = K.spectra_ref(*an)
    results["spectra"]["torch_table_noise_row"] = measure(
        "spectra (torch table, 10 s noise row)", TORCH_TABLE_BOUND,
        lambda: K.spectra(*an), lambda: K.spectra_ref(*an),
        torch.stack([nre, nim]), torch.stack([nrre, nrim]),
        nbytes(noise_cuda, nre, nim), nre.shape[1] * (fft_ops(geo.n_fft) + geo.win),
        library_fn=lambda: torch.stft(
            noise_cuda, geo.n_fft, geo.hop, gate.win_length, window, center=True,
            pad_mode="constant", return_complex=True,
        ),
        scale_bound=True,
    )
    del nre, nim, nrre, nrim

    cells = re.numel()
    f = (re, im, gate.n_movemean_nonstationary, gate.n_thresh_nonstationary,
         gate.temp_coeff_nonstationary, gate.prop_decrease, tt)
    m = K.torch_nonstationary_mask(*f)
    rm = K.torch_nonstationary_mask_ref(*f)
    results["torch_nonstationary_mask"] = measure(
        "torch_nonstationary_mask", BOUNDS["torch_nonstationary_mask"],
        lambda: K.torch_nonstationary_mask(*f), lambda: K.torch_nonstationary_mask_ref(*f),
        m, rm, nbytes(re, im, m), cells * (40.0 + 2 * len(tt)),
        wrapper=K.torch_nonstationary_mask)
    del rm
    by_launch = device_ms(lambda: K.torch_nonstationary_mask(*f))
    print("kernel torch_nonstationary_mask: device ms by launch "
          + ", ".join(f"{k} {v:.3f}" for k, v in by_launch.items())
          + f" (sum {sum(by_launch.values()):.3f})", flush=True)
    results["torch_nonstationary_mask"]["device_ms_by_launch"] = by_launch
    for n in F_WINDOWS:  # other windows on the same spectra
        fw = (re, im, n) + f[3:]
        results["torch_nonstationary_mask"][f"n_movemean_{n}"] = r = measure(
            f"torch_nonstationary_mask (n_movemean {n})", BOUNDS["torch_nonstationary_mask"],
            lambda: K.torch_nonstationary_mask(*fw),
            lambda: K.torch_nonstationary_mask_ref(*fw), K.torch_nonstationary_mask(*fw),
            K.torch_nonstationary_mask_ref(*fw), nbytes(re, im, m),
            cells * (40.0 + 2 * len(tt)), wrapper=K.torch_nonstationary_mask)
        if r["cuda_launches"] != 3:
            fail(f"kernel torch_nonstationary_mask (n_movemean {n}) made "
                 f"{r['cuda_launches']} CUDA launches, not 3")
    for temp in F_TEMPS:  # the exact division's final pass, on the same spectra
        ft_ = f[:4] + (temp,) + f[5:]
        got, ref = K.torch_nonstationary_mask(*ft_), K.torch_nonstationary_mask_ref(*ft_)
        # a cell whose ratio is exactly the threshold is NaN (0/0) in both
        if not torch.equal(torch.isnan(got), torch.isnan(ref)):
            fail(f"kernel torch_nonstationary_mask (temp {temp:g}): NaN in other cells")
        results["torch_nonstationary_mask"][f"temp_{temp:g}"] = measure(
            f"torch_nonstationary_mask (temp {temp:g}: exact division)",
            BOUNDS["torch_nonstationary_mask"], lambda: K.torch_nonstationary_mask(*ft_),
            lambda: K.torch_nonstationary_mask_ref(*ft_), got.nan_to_num(), ref.nan_to_num(),
            nbytes(re, im, m), cells * (40.0 + 2 * len(tt)), wrapper=K.torch_nonstationary_mask)
        del got, ref
    f_at_threshold(K, *at_threshold_planes(2, re.shape[1], re.shape[2], re.device), tt)

    mb = K.freq_smooth_blend(m, ft, 1.0)
    d = (re, im, mb, geo, PADDING, CHUNK)
    y = K.istft_ola(*d)
    ry = K.istft_ola_ref(*d)
    zm = torch.complex(re * mb, im * mb).transpose(1, 2).contiguous()
    results["istft_ola"]["torch_tail"] = measure(
        "istft_ola (torch tail)", TORCH_TABLE_BOUND, lambda: K.istft_ola(*d),
        lambda: K.istft_ola_ref(*d), y, ry, nbytes(re, im, mb, y),
        re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
        library_fn=lambda: torch.istft(
            zm, geo.n_fft, geo.hop, gate.win_length, window, center=True,
            length=geo.view_len),
        scale_bound=True,
    )
    del zm, y, ry, m, mb

    # E with each view's own statistics: the decisions against the plain
    # version's float64 margins, then the output with the plain version
    # taking E's decisions within BORDER_DB of the threshold
    e = (re, im, None, 1, gate.prop_decrease, tt)
    ekw = dict(top_db=40.0, n_std=gate.n_std_thresh_stationary)
    got = K.stationary_mask(*e, **ekw)
    dec_k = K.stationary_mask(re, im, None, 1, 1.0, (1.0,), **ekw)
    db = torch.log(torch.sqrt(re * re + im * im) + dsp.EPS_F64) * K._DB_PER_NEPER
    mx = db.amax(dim=-2, keepdim=True)
    db = torch.maximum(db, mx - 40.0)
    margin = db.double() - K._self_threshold(db, mx, gate.n_std_thresh_stationary)[:, None, :]
    del db, mx
    dec_p = (margin > 0).to(re.dtype)
    flips = dec_k != dec_p
    n_flips = int(flips.sum())
    worst = float(margin.abs()[flips].max()) if n_flips else 0.0
    dec = torch.where(margin.abs() <= BORDER_DB, dec_k, dec_p)
    del margin, dec_k, dec_p, flips
    ref = dsp.conv_same(dec * gate.prop_decrease + (1.0 - gate.prop_decrease), tt, -2)
    del dec
    diff = (got - ref).abs()
    n_off = int((diff > BOUNDS["stationary_mask"]).sum())
    dev = float(diff.max())
    del diff, ref
    ms = time_ms(lambda: K.stationary_mask(*e, **ekw))
    plain_ms = time_ms(lambda: K.stationary_mask_ref(*e, **ekw))
    bound_ms, bound_by = bound(nbytes(re, im, got), cells * (20.0 + 2 * len(tt)))
    print(
        f"kernel stationary_mask (self statistics, top_db 40): decisions that "
        f"differ from the plain version's {n_flips} of {cells} cells, largest "
        f"|dB - thr| among them {worst:.3e} dB (bound {BORDER_DB:.0e}); with the "
        f"plain version taking E's decisions there: {n_off} cells off by more "
        f"than {BOUNDS['stationary_mask']:.0e}, max|dev| {dev:.3e}; kernel "
        f"{ms:.3f} ms plain {plain_ms:.3f} ms library none card bound "
        f"{bound_ms:.3f} ms ({bound_by}; kernel {ms / bound_ms:.2f}x the bound, "
        f"{K.stationary_mask.cuda_launches} CUDA launches a call)",
        flush=True,
    )
    if worst > BORDER_DB or n_off:
        fail("kernel stationary_mask (self statistics) disagrees with its plain version")
    results["stationary_mask"]["self_statistics"] = dict(
        max_abs_err=dev, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, decisions_differing=n_flips,
        largest_margin_db=worst, cuda_launches=K.stationary_mask.cuda_launches,
    )


def route_kernel_phase(xc: torch.Tensor, cfg, gate, label) -> dict:
    """Kernels A and D on the route of ``cfg``'s geometry against their
    plain versions at the shapes ``reduce_noise`` gives them on the signal
    ``xc`` (chunked as the API chunks it, or one padded view), each beside
    ``torch.stft`` / ``torch.istft``, each timed also in device time; then,
    with ``gate`` (the TorchGate of ``reduce_noise(use_torch=True)`` at
    this geometry), the same under torch conventions, held at 1e-5 x.
    Returns {"spectra": ..., "istft_ola": ...} of the kernels JSON line."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _mask
    from noisereduce_tpu_torch.ops.dsp import tri_norm
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    out = {}
    n = xc.numel()
    if n > CHUNK:  # the views reduce_noise cuts, read straight from the signal
        cs, core, view_len = CHUNK, CHUNK, CHUNK + 2 * PADDING
        views = extract_chunks(xc[None], cs, PADDING).reshape(-1, view_len).contiguous()
        src = (xc[None], cs, PADDING)
    else:  # one view, the signal padded on both sides
        core, view_len = n, n + 2 * PADDING
        views = F.pad(xc[None], (PADDING, PADDING)).contiguous()
        src = (views, 0, 0)
    convs = [("scipy", cfg.stft, BOUNDS["spectra"])]
    if gate is not None:
        convs.append(("torch", gate.stft_config, TORCH_TABLE_BOUND))
    for conv, scfg, lim in convs:
        geo = gate_geometry(scfg, view_len)
        window = torch.hann_window(geo.win, periodic=True, device=xc.device)
        tag = f"{label}, {conv} convention" if conv == "torch" else label
        tag = f"{tag}, {geo.route} route"
        a = (src[0], geo, *src[1:])
        re, im = K.spectra(*a)
        rre, rim = K.spectra_ref(*a)
        ops_a = re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win)

        def lib_a():
            return torch.stft(views, geo.n_fft, geo.hop, geo.win, window, center=True,
                              pad_mode="constant", return_complex=True)

        ra = measure(
            f"spectra ({tag})", lim, lambda: K.spectra(*a), lambda: K.spectra_ref(*a),
            torch.stack([re, im]), torch.stack([rre, rim]), nbytes(src[0], re, im), ops_a,
            library_fn=lib_a, scale_bound=True)
        ra.update(device_times(f"spectra ({tag})", kernel=lambda: K.spectra(*a),
                               library=lib_a))
        del rre, rim
        if conv == "scipy":
            ngf, ngt = cfg.smoothing
            m = K.freq_smooth_blend(
                K.nonstationary_mask(re, im, cfg.iir_b, cfg.thresh_n_mult_nonstationary,
                                     cfg.sigmoid_slope_nonstationary, tri_norm(ngt)),
                tri_norm(ngf), cfg.prop_decrease)
        else:
            m = _mask(re, im, gate)
        d = (re, im, m, geo, PADDING, core)
        y, ry = K.istft_ola(*d), K.istft_ola_ref(*d)
        zm = torch.complex(re * m, im * m).transpose(1, 2).contiguous()

        def lib_d():
            return torch.istft(zm, geo.n_fft, geo.hop, geo.win, window, center=True,
                               length=geo.view_len)

        rd = measure(
            f"istft_ola ({tag})", lim, lambda: K.istft_ola(*d), lambda: K.istft_ola_ref(*d),
            y, ry, nbytes(re, im, m, y),
            re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
            library_fn=lib_d, scale_bound=True)
        rd.update(device_times(f"istft_ola ({tag})", kernel=lambda: K.istft_ola(*d),
                               library=lib_d))
        del re, im, m, y, ry, zm
        torch.cuda.empty_cache()
        if conv == "scipy":
            out = {"spectra": ra, "istft_ola": rd}
        else:
            out["spectra"]["torch_table"], out["istft_ola"]["torch_tail"] = ra, rd
    return out


def long_frame_engines(nr, K, launches, xq, cell) -> None:
    """A long-frame geometry (``cell``: ROADMAP F8's n_fft 40000 with 500
    ms of time smoothing, or n_fft 4803 / hop 1601, at 48 kHz) through
    ``reduce_noise`` on the stationary and torch engines (the
    non-stationary one is its route cell), each path's launches counted,
    A and D on the cell's route only (cluster, cluster chirp); every engine held
    to the CPU path (the kernels' plain versions): the non-stationary and
    torch engines within E2E_BOUND x max|ref|, the stationary one printed
    and held to the staged plain path on the card under the border rule."""
    label, sr, samples, kw, route, _ = cell
    ck = dict(chunk_size=CHUNK, padding=PADDING)
    paths = {
        "nonstationary": ({}, None),
        "stationary": (dict(stationary=True),
                       dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
        "use_torch": (dict(use_torch=True),
                      dict(spectra=1, torch_nonstationary_mask=1, freq_smooth_blend=1,
                           istft_ola=1)),
    }
    for engine, (extra, expected) in paths.items():
        call = dict(kw, **extra, **ck)
        tag = f"{label}, {engine}"
        if expected is None:
            out = nr.reduce_noise(xq, sr, **call)
        else:
            out, launches[tag] = run_path(K, tag, lambda: nr.reduce_noise(xq, sr, **call),
                                          expected, route=route)
        check_output(tag, out, xq)
        ref = nr.reduce_noise(xq, sr, device="cpu", **call)
        dev = float(np.abs(out.astype(np.float64) - ref).max())
        lim = E2E_BOUND * float(np.abs(ref).max())
        print(f"{tag} ({call}, {samples} samples at {sr} Hz) vs the CPU path: max|dev| "
              f"{dev:.3e} bound {lim:.3e}", flush=True)
        if engine == "stationary":
            y2d = torch.as_tensor(xq[None]).cuda()
            stationary_vs_plain(tag, out[None], y2d, y2d[0, :CHUNK],
                                nr.GateConfig(sr=sr, stationary=True, **kw), CHUNK, PADDING)
        elif not dev <= lim:
            fail(f"{tag} disagrees with the CPU path")


def torch_staged(y2d, gate, chunk_size, padding, xn=None):
    """The torch convention's staged plain path over (rows, n), chunked as
    ``reduce_noise(use_torch=True)`` chunks: each view through
    ``TPUGate._call_staged``, its natural-length deficit zero filled, the
    cores assembled."""
    from noisereduce_tpu_torch.parallel.chunking import process_chunked

    def call(c):
        v = c.reshape(-1, c.shape[-1])
        out = gate._call_staged(v, xn)
        return F.pad(out, (0, v.shape[-1] - out.shape[-1])).reshape(c.shape)

    with torch.no_grad():
        return process_chunked(call, y2d, chunk_size, padding)


def torch_stationary_vs_plain(label, out, y2d, yn, gate, chunk_size, padding):
    """``stationary_vs_plain`` for the torch convention: a stationary
    TorchGate output from the card against the staged plain path on the
    card, as it is and with the plain path taking the kernels' decisions
    within ``BORDER_DB`` of the threshold. ``yn``: (1, n_clip) noise rows,
    or None for each view's own statistics."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _torch_threshold_stats
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, smooth_mask_2d_torchgate
    from noisereduce_tpu_torch.ops.stft import istft, stft
    from noisereduce_tpu_torch.parallel.chunking import assemble_chunks

    rows, n = y2d.shape
    scfg = gate.stft_config
    n_std = gate.n_std_thresh_stationary
    with torch.no_grad():
        plain = torch_staged(y2d, gate, chunk_size, padding, yn)
        views, k = gate_views(y2d, chunk_size, padding)
        re, im = K.spectra(views, gate_geometry(scfg, views.shape[-1]))
        if yn is None:
            dec_k = K.stationary_mask(re, im, None, 1, 1.0, (1.0,), top_db=40.0, n_std=n_std)
        else:
            thr = _torch_threshold_stats(yn, gate).contiguous()
            dec_k = K.stationary_mask(re, im, thr, re.shape[0], 1.0, (1.0,), top_db=40.0)
        del re, im
        re, im = stft(views, scfg)
        db = amp_to_db(torch.sqrt(re * re + im * im), top_db=40.0, axis=-2)
        if yn is None:
            ref_db = db
        else:
            rn, imn = stft(yn, scfg)
            ref_db = amp_to_db(torch.sqrt(rn * rn + imn * imn), top_db=40.0, axis=-2)
        thr_s = ref_db.mean(dim=-2) + ref_db.std(dim=-2, correction=1) * n_std
        margin = db - thr_s[:, None, :]
        del db, ref_db
        dec_s = (margin > 0).to(re.dtype)
        flips = dec_s != dec_k
        n_flips = int(flips.sum())
        worst = float(margin.abs()[flips].max()) if n_flips else 0.0
        mask = torch.where(margin.abs() <= BORDER_DB, dec_k, dec_s)
        del margin, dec_k, dec_s, flips
        mask = gate.prop_decrease * (mask - 1.0) + 1.0
        mask = smooth_mask_2d_torchgate(mask, *gate.smoothing, time_major=True)
        y = istft((re * mask, im * mask), scfg)
        y = F.pad(y, (0, views.shape[-1] - y.shape[-1]))
        if k > 1:
            aligned = assemble_chunks(y.reshape(rows, k, -1), chunk_size, padding, n)
        else:
            aligned = y[:, padding : padding + n]
    out_t = torch.as_tensor(np.asarray(out, np.float64)).reshape(rows, n)
    dev, _ = max_dev(out_t, plain.cpu())
    dev_al, scale_al = max_dev(out_t, aligned.cpu())
    lim = E2E_BOUND * scale_al
    print(
        f"{label} vs staged plain path: max|dev| {dev:.3e}; decisions that "
        f"differ {n_flips} of {views.shape[0] * scfg.n_frames(views.shape[-1]) * scfg.n_bins} "
        f"cells, largest |dB - thr| among them {worst:.3e} dB (bound "
        f"{BORDER_DB:.0e}); with the plain path taking the kernels' decisions "
        f"there: max|dev| {dev_al:.3e} bound {lim:.3e} (max|ref| {scale_al:.4g})",
        flush=True,
    )
    if worst > BORDER_DB or not dev_al <= lim:
        fail(f"{label} disagrees with the staged plain path")


def gate_views(y2d: torch.Tensor, chunk_size: int, padding: int):
    """The views the gate sees (``parallel.chunking.process_chunked``):
    (rows * n_chunks, view) and n_chunks."""
    from noisereduce_tpu_torch.parallel.chunking import extract_chunks

    if y2d.shape[-1] <= chunk_size:
        return F.pad(y2d, (padding, padding)), 1
    v = extract_chunks(y2d, chunk_size, padding)
    return v.reshape(-1, v.shape[-1]).contiguous(), v.shape[1]


def kernel_decisions(views, k, yn, cfg):
    """The kernels' binary decisions on (rows * k, view) views: kernel A's
    spectra, the kernel-route threshold of the noise rows ``yn``, E with
    prop 1 and one unit tap."""
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry

    re, im = K.spectra(views, gate_geometry(cfg.stft, views.shape[-1]))
    return K.stationary_mask(re, im, stationary_noise_threshold(yn, cfg), k, 1.0, (1.0,))


def staged_margin(views, k, yn, cfg):
    """The staged path's spectra of the views and their dB - threshold."""
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, noise_db_threshold
    from noisereduce_tpu_torch.ops.stft import stft

    re, im = stft(views, cfg.stft)
    thr = noise_db_threshold(*stft(yn, cfg.stft), cfg.n_std_thresh_stationary)
    if thr.ndim == 2:
        thr = thr.repeat_interleave(k, 0)[:, None, :]
    return re, im, amp_to_db(torch.sqrt(re * re + im * im), top_db=80.0, axis=-2) - thr


def stationary_vs_plain(label, out, y2d, yn, cfg, chunk_size, padding):
    """Hold a stationary gate's output from the card against the staged
    plain path on the card, as it is and with the plain path taking the
    kernels' decisions within ``BORDER_DB`` of the threshold (see the
    module note). y2d: (rows, n) and yn: noise rows, on the card."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _apply_mask_and_invert, _gate_stationary_staged,
    )
    from noisereduce_tpu_torch.ops.dsp import noise_db_threshold, smooth_mask
    from noisereduce_tpu_torch.ops.stft import stft
    from noisereduce_tpu_torch.parallel.chunking import assemble_chunks, process_chunked

    rows, n = y2d.shape
    with torch.no_grad():
        thr_s = noise_db_threshold(*stft(yn, cfg.stft), cfg.n_std_thresh_stationary)
        plain = process_chunked(
            lambda c: _gate_stationary_staged(c, thr_s, cfg), y2d, chunk_size, padding
        )
        views, k = gate_views(y2d, chunk_size, padding)
        dec_k = kernel_decisions(views, k, yn, cfg)
        re, im, margin = staged_margin(views, k, yn, cfg)
        dec_s = (margin > 0).to(re.dtype)
        flips = dec_s != dec_k
        n_flips = int(flips.sum())
        worst = float(margin.abs()[flips].max()) if n_flips else 0.0
        mask = torch.where(margin.abs() <= BORDER_DB, dec_k, dec_s)
        del margin, dec_k, dec_s, flips
        mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
        if cfg.smoothing is not None:
            mask = smooth_mask(mask, *cfg.smoothing, time_major=True)
        y = _apply_mask_and_invert((re, im), mask, cfg, views.shape[-1])
        if k > 1:
            aligned = assemble_chunks(y.reshape(rows, k, -1), chunk_size, padding, n)
        else:
            aligned = y[:, padding : padding + n]
    out_t = torch.as_tensor(np.asarray(out, np.float64)).reshape(rows, n)
    dev, _ = max_dev(out_t, plain.cpu())
    dev_al, scale_al = max_dev(out_t, aligned.cpu())
    lim = E2E_BOUND * scale_al
    print(
        f"{label} vs staged plain path: max|dev| {dev:.3e}; decisions that "
        f"differ {n_flips} of {re.numel()} cells, largest |dB - thr| among them "
        f"{worst:.3e} dB (bound {BORDER_DB:.0e}); with the plain path taking "
        f"the kernels' decisions there: max|dev| {dev_al:.3e} bound {lim:.3e} "
        f"(max|ref| {scale_al:.4g})",
        flush=True,
    )
    if worst > BORDER_DB or not dev_al <= lim:
        fail(f"{label} disagrees with the staged plain path")


def grad_check(label, g, ref, lim):
    """A gradient from the card against its float64 reference: finite and
    within ``lim`` x max|ref| (a complex one as its real pairs)."""
    if g.is_complex():
        g, ref = torch.view_as_real(g), torch.view_as_real(ref)
    dev, scale = max_dev(g, ref)
    finite = bool(torch.isfinite(g).all())
    print(f"{label}: gradient vs float64 twin max|dev| {dev:.3e} bound {lim * scale:.3e} "
          f"(max|ref| {scale:.4g}, {lim:.0e} x), finite {finite}", flush=True)
    if not finite or not dev <= lim * scale:
        fail(f"{label}: the gradient disagrees with the float64 twin")


def under_grad(K, label, fn, args, cot, expected, launches):
    """``fn(*args)`` under grad with its value against the ``torch.no_grad()``
    value (bitwise) and the serving launches, then the backward pass of the
    cotangent ``cot``, which must launch nothing. Returns the gradients.
    The path is counted from the forward pass to the end of the backward."""
    with torch.no_grad():
        serving = fn(*args)
    args = [a.detach().requires_grad_() for a in args]
    holder = {}

    def path():
        out = fn(*args)
        torch.cuda.synchronize()
        holder["forward"] = K.launch_counts()
        holder["bitwise"] = out.grad_fn is not None and torch.equal(out, serving)
        return torch.autograd.grad(out, args, cot)

    grads, launches[label] = run_path(K, label, path, expected)
    print(f"{label}: value under grad bitwise the no-grad value: {holder['bitwise']}; "
          f"forward launches {holder['forward']}", flush=True)
    if not holder["bitwise"] or holder["forward"] != launches[label]:
        fail(f"{label}: the value under grad or the backward's launches")
    return grads


def one_copy_headline(x: np.ndarray, cfg, dtype=torch.float32) -> np.ndarray:
    """The headline's output by the one-copy path: the whole signal copied
    to the card first in its own dtype and cast there to ``dtype``, then
    the same chunked gate in one launch of each kernel
    (``api._run_nonstationary`` on a card tensor), returned in the
    signal's dtype as ``reduce_noise`` returns it."""
    from noisereduce_tpu_torch.api import _run_nonstationary

    with torch.no_grad():
        y = torch.as_tensor(x[None]).cuda().to(dtype)
        out = _run_nonstationary(y, cfg, CHUNK, PADDING)[0].float().cpu().numpy()
    return out.astype(x.dtype, copy=False)


def float64_signal(x: np.ndarray) -> np.ndarray:
    """The headline as a float64 caller sends it: ``x`` plus noise of its
    own (1e-3 x N(0, 1), from a seed), so that its cast to float32 rounds."""
    return x + 1e-3 * np.random.default_rng(SEED + 5).standard_normal(len(x))


def int16_signal(x: np.ndarray) -> np.ndarray:
    """The headline as an int16 caller sends it: ``x`` scaled to a peak of
    8000 and rounded."""
    return np.round(x * (8000 / np.abs(x).max())).astype(np.int16)


def float16_signal(x: np.ndarray) -> np.ndarray:
    """The headline as a float16 caller sends it: ``x`` rounded to float16."""
    return x.astype(np.float16)


def uint8_signal(x: np.ndarray) -> np.ndarray:
    """The headline as an 8-bit PCM caller sends it: ``x`` scaled to a peak
    of 100 around 128 and rounded."""
    return np.round(128 + x * (100 / np.abs(x).max())).astype(np.uint8)


def staged_callers_phase(nr, K, x, x64, cfg, launches) -> None:
    """The headline from float64 (``x64``), int16, float16, uint8 and
    bfloat16 callers through the staged path (float64 cast to float32 by
    the host's native copy, bitwise the card's cast; int16, float16 and
    uint8 sent in their dtype; bfloat16 cast on the card), each bitwise the
    one-copy path of the same caller (numpy's cast of its float32 output),
    each kernel once a piece in its dtype's build. The float64 caller's
    output is float64, widened on the card, and the int16, float16 and
    uint8 callers' are in their own dtype, narrowed on the card by kernel H
    (``output_cast``, once a piece): each array is the call's pinned output
    itself, not a host copy."""
    P = HEADLINE_PIECES
    ck = dict(chunk_size=CHUNK, padding=PADDING)
    want = dict(spectra=P, nonstationary_mask=P, freq_smooth_blend=P, istft_ola=P)
    narrowed = dict(want, output_cast=P)
    callers = {
        "float64 headline": (x64, {}, torch.float32, "float32", want),
        "int16 headline": (int16_signal(x), {}, torch.float32, "float32", narrowed),
        "float16 headline": (float16_signal(x), {}, torch.float32, "float32", narrowed),
        "uint8 headline": (uint8_signal(x), {}, torch.float32, "float32", narrowed),
        "bf16 headline, staged": (x, dict(compute_dtype=BF16), BF16, "bfloat16", want),
    }
    for label, (y, kw, dtype, build, expected) in callers.items():
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="compute_dtype=bfloat16")
            out, launches[label] = run_path(K, label, lambda: nr.reduce_noise(y, SR, **kw, **ck),
                                            expected, dtype=build)
        one = one_copy_headline(y, cfg, dtype)
        bitwise = out.dtype == y.dtype and np.array_equal(out, one)
        print(f"{label} ({y.dtype}, {y.nbytes / 1e6:.1f} MB, crossing as "
              f"{'float32' if y.dtype == np.float64 else y.dtype}) bitwise the one-copy path "
              f"(the signal on the card whole, cast there; numpy's cast of its float32 "
              f"output): {bitwise}", flush=True)
        if not bitwise:
            fail(f"{label} differs from the one-copy path")
        if y.dtype != np.float32:
            pinned = torch.from_numpy(out).is_pinned()
            how = ("widened on the card" if y.dtype == np.float64 else
                   f"narrowed on the card by kernel H ({launches[label]['output_cast']} "
                   f"launches, one a piece)")
            print(f"{label}: output {out.dtype}, {out.nbytes / 1e6:.1f} MB, {how} and sent "
                  f"into the call's pinned output (the array is that pinned memory): {pinned}",
                  flush=True)
            if out.dtype != y.dtype or not pinned:
                fail(f"{label}: the output is not the call's pinned {y.dtype} output")


# kernel H at the int16 headline, and each dtype it writes: numpy's cast on
# the host that runs it and the plain version, bitwise (NaN bits included)
CAST_DTYPES = ("int16", "int8", "uint8", "uint16", "int32", "float16")


def cast_edge_values() -> np.ndarray:
    """float32 values where a cast to an integer or float16 goes wrong
    first (each type's bounds +-0.5 and +-1, 2^15, 2^16, 2^31, 1e10,
    float16's overflow and ties, +-inf, NaNs with payloads, subnormals),
    with their float32 neighbours."""
    base = [0.0, 0.5, 0.9, 1.5, 2.5, 2.0**15, 2.0**16, 2.0**31, 3e9, 1e10, 2147483520.0,
            40000.5, 65535.5, 65504.0, 65519.0, 65520.0, 1 + 2.0**-11, 2.0**-24, 2.0**-25]
    for dt in (np.int8, np.uint8, np.int16, np.uint16, np.int32):
        for b in (float(np.iinfo(dt).min), float(np.iinfo(dt).max)):
            base += [b - 1, b - 0.5, b, b + 0.5, b + 1]
    f = np.array(base, dtype=np.float32)
    f = np.concatenate([f, -f])
    f = np.concatenate([f, np.nextafter(f, np.float32(np.inf)),
                        np.nextafter(f, np.float32(-np.inf))])
    special = np.array([0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                        0x7FC0DD1D, 0x7F800001, 0xFF802000, 0x7F801FFF, 0x00000001,
                        0x807FFFFF], dtype=np.uint32).view(np.float32)
    return np.concatenate([f, special])


def piece_views(y: torch.Tensor) -> list:
    """A (1, n) output as the headline's pieces hand it to kernel H
    (``transfer.PinnedCores.put``): buffers of k chunks
    (``transfer.piece_chunks``), the last cut to n."""
    from noisereduce_tpu_torch.parallel.transfer import piece_chunks

    n = y.shape[1]
    n_chunks = (n - 1) // CHUNK + 1
    per = piece_chunks(n_chunks, CHUNK, 1)
    out = []
    for c in range(0, n_chunks, per):
        a, k = c * CHUNK, min(per, n_chunks - c)
        buf = torch.empty((1, k * CHUNK), device=y.device)
        b = min(n, a + k * CHUNK)
        buf[:, : b - a] = y[:, a:b]
        out.append(buf[:, : b - a])
    return out


def output_cast_phase(K, x16: np.ndarray, cfg, card: str, results) -> None:
    """Kernel H on the int16 headline's cores as the main path gives them
    (the float32 gated output of the int16 signal in its 4 pieces' buffers
    of k chunks, the last cut to the signal's length; the edge values
    written over the first piece's head): against its plain version on the
    card and numpy's ``astype`` on the same host, bitwise, for every dtype
    it writes; the 4 launches timed beside their plain versions,
    ``tensor.to(torch.int16)`` (the library call of the same bytes, which
    clamps through CUDA's cvt: its values at the edges printed beside H's
    and numpy's for int16, int32 and uint16), the bytes bound and the 4
    launches' device time (``queued_ms``; the profiler where that fails)."""
    from noisereduce_tpu_torch.api import _run_nonstationary

    with torch.no_grad():
        y = _run_nonstationary(torch.as_tensor(x16[None]).cuda().float(), cfg, CHUNK, PADDING)
    pieces = piece_views(y)
    del y
    edge = torch.as_tensor(cast_edge_values()).cuda()
    pieces[0][0, 1 : 1 + len(edge)] = edge
    host = [p.cpu().numpy() for p in pieces]
    by_dtype = {}
    for name in CAST_DTYPES:
        dt = getattr(torch, name)
        got = [K.output_cast(p, dt) for p in pieces]
        torch.cuda.synchronize()
        ref = [K.output_cast_ref(p, dt) for p in pieces]
        plain = all(torch.equal(g.view(torch.uint8), r.view(torch.uint8))
                    for g, r in zip(got, ref))
        with np.errstate(invalid="ignore", over="ignore"):
            numpy = all(np.array_equal(g.cpu().view(torch.uint8).numpy(),
                                       h.astype(getattr(np, name)).view(np.uint8))
                        for g, h in zip(got, host))
        by_dtype[name] = dict(plain_bitwise=plain, numpy_bitwise=numpy)
        print(f"kernel output_cast to {name}: {sum(p.numel() for p in pieces)} outputs in "
              f"{len(pieces)} launches (the int16 headline's pieces, edge values in the first), "
              f"bitwise its plain version on the card: {plain}; bitwise numpy's astype "
              f"(numpy {np.__version__}) on this host: {numpy}", flush=True)
        if not (plain and numpy):
            fail(f"kernel output_cast to {name} disagrees with numpy's cast")
        del got, ref
    dt = torch.int16

    def launches():
        return [K.output_cast(p, dt) for p in pieces]

    def plain():
        return [K.output_cast_ref(p, dt) for p in pieces]

    def library():
        return [p.to(dt) for p in pieces]

    moved = sum(p.numel() for p in pieces) * (4 + 2)
    out = measure("output_cast (int16 headline, 4 launches)", 0.0, launches,
                  plain, torch.cat(launches(), 1).float(), torch.cat(plain(), 1).float(),
                  moved, 4.0 * sum(p.numel() for p in pieces), library_fn=library)
    # the card's time for the 4 launches, the host's launch work hidden
    # (late in this script the profiler loses kernels: it is the fallback)
    dms, src = queued_ms(launches), "queued_ms"
    if dms is None:
        dms = sum(v for k, v in device_ms(launches).items() if "output_cast" in k) or None
        src = "torch.profiler"
    if dms:
        print(f"kernel output_cast (int16 headline, 4 launches): device {dms:.4f} ms ({src}), "
              f"{moved / dms / 1e6:.0f} GB/s of the function's {moved / 1e9:.3f} GB, "
              f"{dms / out['bound_ms']:.2f}x the bound; on {card}", flush=True)
    else:
        print("kernel output_cast (int16 headline, 4 launches): device time not measured (the "
              "host outran the spin and the profiler lost the kernels)", flush=True)
    edges = [40000.5, -40000.7, 3e9, float("inf"), float("nan")]
    probe = torch.tensor([edges], device="cuda")
    seen = {}
    for name in ("int16", "int32", "uint16"):
        t, n_dt = getattr(torch, name), getattr(np, name)
        with np.errstate(invalid="ignore", over="ignore"):
            numpy = probe.cpu().numpy().astype(n_dt)[0].tolist()
        seen[name] = {way: got.cpu().view(torch.uint8).numpy().view(n_dt)[0].tolist()
                      for way, got in (("kernel", K.output_cast(probe, t)),
                                       ("tensor.to", probe.to(t)))}
        seen[name]["numpy"] = numpy
        print(f"output_cast against tensor.to(torch.{name}) at {edges}: kernel H "
              f"{seen[name]['kernel']}, tensor.to {seen[name]['tensor.to']}, numpy {numpy}; "
              f"on {card}", flush=True)
        if seen[name]["kernel"] != numpy:
            fail(f"kernel output_cast to {name} is not numpy's cast at the edges")
    out.update(by_dtype=by_dtype, library_call="tensor.to(torch.int16)", edges=edges,
               edge_values=seen, device_ms=dms, device_ms_from=src)
    results["output_cast"] = out


def call_split(label: str, call, K, transfer, card: str, reps: int = 3) -> dict:
    """Where a call's time goes: the host wall (min of ``reps`` after a
    warm-up, each ending in a synchronize), the host's copy into pinned
    memory (the time spent in ``transfer.HostSignal.copy_into``; 0 for None,
    a tree without the staged path), the pieces (kernel D's launches), and
    from one ``torch.profiler`` trace the H2D, the kernels and the D2H
    (device time by kind, and the copies' count), how long kernels ran
    during an H2D and a D2H during a kernel, the device busy share of the
    profiled wall, and the device ms by operation name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall = wall_s(call, reps) * 1e3
    spent, copied = [0.0], [0]
    if transfer is not None:
        copy_into = transfer.HostSignal.copy_into

        def timed(self, dst, *a, **k):
            t0 = time.perf_counter()
            copy_into(self, dst, *a, **k)
            spent[0] += time.perf_counter() - t0
            copied[0] += dst.numel() * dst.element_size()

        transfer.HostSignal.copy_into = timed
    try:
        K.reset_launch_counts()
        call()
        torch.cuda.synchronize()
    finally:
        if transfer is not None:
            transfer.HostSignal.copy_into = copy_into
    pieces = K.launch_counts()["istft_ola"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    spans = collections.defaultdict(list)
    by_name = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = ("h2d" if e.name.startswith("Memcpy HtoD") else "d2h"
                    if e.name.startswith("Memcpy DtoH") else "other"
                    if e.name.startswith(("Memcpy", "Memset")) else "kernels")
            spans[kind].append((e.time_range.start / 1e3, e.time_range.end / 1e3))
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3

    def merged(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def overlap(xs, ys):
        return sum(max(0.0, min(b, d) - max(a, c)) for a, b in merged(xs) for c, d in merged(ys))

    busy = sum(b - a for a, b in merged([iv for v in spans.values() for iv in v]))
    split = dict(
        wall_ms=wall, host_copy_ms=spent[0] * 1e3, host_copy_bytes=copied[0], pieces=pieces,
        h2d_ms=sum(b - a for a, b in spans["h2d"]), h2d_copies=len(spans["h2d"]),
        kernels_ms=sum(b - a for a, b in spans["kernels"]),
        d2h_ms=sum(b - a for a, b in spans["d2h"]), d2h_copies=len(spans["d2h"]),
        kernels_during_h2d_ms=overlap(spans["kernels"], spans["h2d"]),
        d2h_during_kernels_ms=overlap(spans["d2h"], spans["kernels"]),
        profiled_ms=traced, busy_ms=busy, busy_share=busy / traced, by_name=dict(by_name))
    rate = copied[0] / spent[0] / 1e9 if spent[0] else 0.0
    print(f"{label}: host wall {wall:.2f} ms (min of {reps}), host copy into pinned memory "
          f"{split['host_copy_ms']:.2f} ms ({copied[0] / 1e6:.1f} MB written, {rate:.2f} GB/s), "
          f"H2D {split['h2d_ms']:.3f} ms in "
          f"{split['h2d_copies']} copies, kernels {split['kernels_ms']:.3f} ms, D2H "
          f"{split['d2h_ms']:.3f} ms in {split['d2h_copies']} copies, {pieces} pieces; kernels "
          f"during an H2D {split['kernels_during_h2d_ms']:.3f} ms, a D2H during kernels "
          f"{split['d2h_during_kernels_ms']:.3f} ms; device busy {busy:.2f} of {traced:.2f} ms "
          f"profiled ({100 * busy / traced:.0f}%); on {card}", flush=True)
    return split


def pieces_of(n_samples: int, rows: int = 1) -> int:
    """The pieces a staged chunked call of ``n_samples`` samples a row
    runs in, each launching each kernel once (``transfer.piece_chunks``);
    one for a signal of at most one chunk."""
    from noisereduce_tpu_torch.parallel.transfer import piece_chunks

    n_chunks = (n_samples - 1) // CHUNK + 1
    return -(-n_chunks // piece_chunks(n_chunks, CHUNK, rows))


ROUTES = {}  # path label -> kernels A and D's launches by route
DTYPES = {}  # path label -> every kernel's launches by the dtype of its planes


def run_path(K, label, fn, expected, route="fft", dtype="float32"):
    """Run one path with the launch counts set to 0 just before it and read
    just after; every kernel in ``expected`` must have launched exactly
    that often (the others not at all), A and D all on ``route``, and A, B,
    D, E and F all in their ``dtype`` build (C and G in float32)."""
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    ROUTES[label] = routes = K.route_counts()
    DTYPES[label] = dtypes = K.dtype_counts()
    by_dtype = {k: {d: n for d, n in v.items() if n} for k, v in dtypes.items() if counts[k]}
    print(f"{label} launches: {counts}; A and D by route: {routes}; by dtype: {by_dtype}",
          flush=True)
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    if any(r[route] != counts[name] for name, r in routes.items()):
        fail(f"{label}: A or D launched off the {route} route: {routes}")
    if any(dtypes[k][dtype if k in PLANE_KERNELS else "float32"] != n
           for k, n in counts.items()):
        fail(f"{label}: a kernel launched off its {dtype} build: {by_dtype}")
    return out, counts


def check_output(label, out, like) -> None:
    if out.shape != like.shape or out.dtype != like.dtype:
        fail(f"{label} output shape/dtype")
    if not np.isfinite(out).all():
        fail(f"{label} output not finite")


def golden_phase(nr) -> None:
    data = np.load(os.path.join(HERE, "tests", "golden", "golden_v1.npz"))
    with open(os.path.join(HERE, "tests", "golden", "golden_v1.json")) as f:
        meta = json.load(f)
    sr = meta["sr"]
    # the torch configurations name device="cpu" (the reference's CPU run):
    # here they run on the card, in float32 like the others
    for name in ("nonstationary", "nonstationary_chunked", "stationary_self",
                 "stationary_noise_clip", "stationary_multichannel",
                 "stationary_recorded_noise_nfft2048", "torch_nonstationary_chunked",
                 "torch_stationary_chunked"):
        cfg = meta["configs"][name]
        kw = dict(cfg["kwargs"], device="cuda")
        if cfg["use_noise"]:
            kw["y_noise"] = data["noise"][: sr // 4]
        if cfg.get("use_recorded_noise"):
            kw["y_noise"] = data["cafe_clip"]
        y = data[cfg["input"]]
        out = nr.reduce_noise(y, sr, **kw)
        ref = data[f"out_{name}"]
        dev = float(np.abs(out.astype(np.float64) - ref).max())
        scale = float(np.abs(ref).max())
        bound_ = E2E_BOUND * scale
        print(f"golden {name}: max|dev| {dev:.3e} bound {bound_:.3e} "
              f"({dev / scale:.2e} x max|ref|)", flush=True)
        if out.shape != ref.shape or out.dtype != ref.dtype or not dev <= bound_:
            if kw.get("stationary") and not kw.get("use_torch"):
                golden_flip_report(nr, y, sr, kw)
            fail(f"golden {name}")


def golden_flip_report(nr, y, sr, kw) -> None:
    """Print the cells where the card's stationary decisions differ from a
    float64 staged run on the CPU, with their dB margins."""
    cfg = nr.GateConfig(sr=sr, stationary=True, **{
        k: v for k, v in kw.items() if k not in ("stationary", "y_noise", "device")})
    y2d = np.atleast_2d(y)
    yn = np.atleast_2d(kw.get("y_noise", y)).mean(axis=0)[:CHUNK]

    def on(dev, dt):
        views, k = gate_views(torch.as_tensor(y2d, dtype=dt, device=dev), CHUNK, PADDING)
        return views, k, torch.as_tensor(yn, dtype=dt, device=dev)

    dec = kernel_decisions(*on("cuda", torch.float32), cfg).cpu() > 0
    margin = staged_margin(*on("cpu", torch.float64), cfg)[2]
    flips = dec != (margin > 0)
    print(f"  {int(flips.sum())} cells decide otherwise than float64; their "
          f"|dB - thr|: {margin.abs()[flips][:10].tolist()}", flush=True)


def stationary_reference(x, thr, cfg):
    """The float64 reference of the stationary gate's gradient: the staged
    twin in float64 taking the float32 twin's decisions (the ones the
    backward pass differentiates) at the cells within ``BORDER_DB`` of the
    threshold; every decision that differs must lie there. Returns the
    float64 function of x64, the number of such cells and the largest
    |dB - thr| among them."""
    from noisereduce_tpu_torch.models.spectral_gate import _apply_mask_and_invert
    from noisereduce_tpu_torch.ops.dsp import amp_to_db, smooth_mask
    from noisereduce_tpu_torch.ops.stft import stft

    def margin(a, t):
        re, im = stft(a, cfg.stft)
        return amp_to_db(torch.sqrt(re * re + im * im), top_db=80.0, axis=-2) - t

    with torch.no_grad():
        dec32 = margin(x, thr.float()) > 0
        m64 = margin(x.double(), thr.double())
        dec64 = m64 > 0
        flips = dec32 != dec64
        n_flips = int(flips.sum())
        worst = float(m64.abs()[flips].max()) if n_flips else 0.0
        mask = torch.where(m64.abs() <= BORDER_DB, dec32, dec64).double()
        mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
        mask = smooth_mask(mask, *cfg.smoothing, time_major=True)

    def twin(x64):  # _gate_stationary_staged after the compare
        return _apply_mask_and_invert(stft(x64, cfg.stft), mask, cfg, x64.shape[-1])

    return twin, n_flips, worst


def gradient_phase(nr, K, card, launches, dev="cuda") -> None:
    """Phase 17: rows 6 and 7 under grad, the training step of the three
    gate families at batch 16 and 256 (float64 checks under
    ``NRTPU_COTANGENT_PRECISION=highest``, then the default bf16
    cotangent), and the notebook-3.0 loop."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        _gate_nonstationary_staged, gate_nonstationary, gate_stationary,
        stationary_noise_threshold,
    )
    from noisereduce_tpu_torch.ops.cuda_mask import (
        _mask_impl, _mask_impl_tm, fused_nonstationary_mask, fused_nonstationary_mask_tm,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    os.environ.pop("NRTPU_COTANGENT_PRECISION", None)  # the default mode: bf16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # rows 6 and 7: the masks of 8 views of the headline's frame count
    cfg = nr.GateConfig(sr=SR)
    mk = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    n_frames = cfg.stft.n_frames(CHUNK + 2 * PADDING)
    z = randn(GRAD_VIEWS, cfg.stft.n_bins, n_frames, dtype=torch.complex64)
    cot = randn(*z.shape)
    (gz,) = under_grad(K, "row 6 mask under grad", lambda a: fused_nonstationary_mask(a, *mk),
                       [z], cot, dict(fm_nonstationary_mask=1), launches)
    z64 = z.to(torch.complex128).requires_grad_()
    (rz,) = torch.autograd.grad(_mask_impl(z64, *mk), z64, cot.double())
    grad_check(f"row 6 mask ({tuple(z.shape)} complex64)", gz, rz, GRAD_BOUND)
    if K.fm_nonstationary_mask.resident_launches != 1:
        fail("row 6 mask under grad: kernel G did not take its resident route")
    del z, z64, gz, rz
    re, im = randn(GRAD_VIEWS, n_frames, cfg.stft.n_bins), randn(GRAD_VIEWS, n_frames, cfg.stft.n_bins)
    grads = under_grad(K, "row 7 mask under grad",
                       lambda r, i: fused_nonstationary_mask_tm(r, i, *mk), [re, im], cot.transpose(1, 2),
                       dict(nonstationary_mask=1), launches)
    r64, i64 = (t.double().requires_grad_() for t in (re, im))
    refs = torch.autograd.grad(_mask_impl_tm(r64, i64, *mk), (r64, i64), cot.transpose(1, 2).double())
    for name, g, r in zip(("re", "im"), grads, refs):
        grad_check(f"row 7 mask ({tuple(re.shape)}, d/d{name})", g, r, GRAD_BOUND)
    del re, im, r64, i64, grads, refs, cot
    torch.cuda.empty_cache()

    # the training step of the three gate families
    n = GRAD_SR * GRAD_SECONDS
    gate = nr.TPUGate(sr=GRAD_SR, nonstationary=True)
    ncfg = nr.GateConfig(sr=GRAD_SR)
    scfg = nr.GateConfig(sr=GRAD_SR, stationary=True)
    thr = stationary_noise_threshold(0.8 * randn(NOISE_SECONDS * GRAD_SR), scfg)
    families = (
        ("TPUGate", gate, gate._call_staged,
         dict(spectra=1, torch_nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
        ("gate_nonstationary", lambda a: gate_nonstationary(a, ncfg),
         lambda a: _gate_nonstationary_staged(a, ncfg),
         dict(spectra=1, nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
        ("gate_stationary", lambda a: gate_stationary(a, thr, scfg), None,
         dict(spectra=1, stationary_mask=1, freq_smooth_blend=1, istft_ola=1)),
    )
    for batch in GRAD_BATCHES:
        x = randn(batch, n)
        for name, fn, twin, expected in families:
            label = f"training step {name} (batch {batch} x {GRAD_SECONDS} s)"
            with torch.no_grad():
                cot = randn(*fn(x).shape)
            # the uncast cotangent, held to the float64 twin
            os.environ["NRTPU_COTANGENT_PRECISION"] = "highest"
            (g,) = under_grad(K, label, fn, [x], cot, expected, launches)
            flips = ""
            if twin is None:
                twin, n_flips, worst = stationary_reference(x, thr, scfg)
                flips = (f"; {n_flips} decisions differ between the float32 and float64 "
                         f"twins, largest |dB - thr| among them {worst:.3e} dB (bound "
                         f"{BORDER_DB:.0e})")
                if worst > BORDER_DB:
                    fail(f"{label}: a decision differs away from the threshold")
            x64 = x.double().requires_grad_()
            (r,) = torch.autograd.grad(twin(x64), x64, cot.double())
            grad_check(label + ", highest" + flips, g, r, GRAD_BOUND)
            del x64, r

            # the default mode: float32 primals and the cotangent cast to bf16
            del os.environ["NRTPU_COTANGENT_PRECISION"]
            (gb,) = under_grad(K, label + ", default cotangent", fn, [x], cot, expected,
                               launches)
            gdev, scale = max_dev(gb, g)
            rms = float((gb.double() - g.double()).norm() / g.double().norm())
            same = torch.equal(gb, g)
            held = rms <= COTANGENT_BOUND and (name != "TPUGate" or gdev <= COTANGENT_BOUND * scale)
            print(f"{label}, default cotangent (bf16) vs highest: max|dev| {gdev:.3e} "
                  f"({gdev / scale:.3e} x max|ref| {scale:.4g}), ||dev|| / ||ref|| {rms:.3e}, "
                  f"bound {COTANGENT_BOUND:.0e} (the max held for TPUGate only), bitwise: {same}",
                  flush=True)
            if same or not held or not bool(torch.isfinite(gb).all()):
                fail(f"{label}: the default cotangent is not the cast one within its bound")
            del g, gb, cot

            xg = x.clone().requires_grad_()

            def step():
                xg.grad = None
                (fn(xg) ** 2).mean().backward()

            for mode in ("highest", "bf16") if name == "TPUGate" else ("highest",):
                os.environ["NRTPU_COTANGENT_PRECISION"] = mode
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                fwd_ms = time_ms(lambda: fn(xg))
                step_ms = time_ms(step)
                print(
                    f"{label}, cotangent {mode}: forward + backward {step_ms:.3f} ms "
                    f"({batch * GRAD_SECONDS / (step_ms / 1e3):.0f} audio s per wall s), "
                    f"forward under grad {fwd_ms:.3f} ms, backward share "
                    f"{1 - fwd_ms / step_ms:.1%}, peak memory of the timed steps "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, on {card}",
                    flush=True,
                )
            del os.environ["NRTPU_COTANGENT_PRECISION"]
            del xg

    # the notebook-3.0 loop: a learnable FIR in front of the gate
    batch = GRAD_BATCHES[-1]
    t = torch.arange(n, device=dev, dtype=torch.float32) / GRAD_SR
    clean = torch.sin(2 * np.pi * 440 * t) + 0.5 * torch.sin(2 * np.pi * 220 * t)
    noisy = clean + 0.4 * randn(batch, n)
    fir = torch.zeros(FIR_TAPS, device=dev)
    fir[FIR_TAPS // 2] = 1.0
    fir.requires_grad_()
    adam = torch.optim.Adam([fir], lr=FIR_LR)
    losses = []

    def loop():
        for _ in range(FIR_STEPS):
            adam.zero_grad()
            pre = F.conv1d(noisy[:, None], fir.view(1, 1, -1), padding=FIR_TAPS // 2)[:, 0]
            est = gate(pre)
            loss = ((est - clean[: est.shape[-1]]) ** 2).mean()
            loss.backward()
            adam.step()
            losses.append(loss.item())

    expected = dict(spectra=FIR_STEPS, torch_nonstationary_mask=FIR_STEPS,
                    freq_smooth_blend=FIR_STEPS, istft_ola=FIR_STEPS)
    _, launches["notebook loop"] = run_path(K, "notebook loop", loop, expected)
    print(f"notebook loop ({FIR_TAPS}-tap FIR + TPUGate, Adam lr {FIR_LR}, batch {batch} x "
          f"{GRAD_SECONDS} s): losses {[f'{v:.6f}' for v in losses]}", flush=True)
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("notebook loop: the loss did not fall")


def hold(label, got, ref, what="its in-memory call") -> bool:
    """Hold a streamed float output to ``what`` (by default its in-memory
    call): finite, the same shape, within ``E2E_BOUND`` x max|ref|; print
    whether it is bitwise."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"{label}: shape {got.shape} against {ref.shape}, or not finite")
    dev = float(np.abs(got.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    bitwise = np.array_equal(got, ref)
    print(f"{label} vs {what}: max|dev| {dev:.3e} bound {lim:.3e}; "
          f"bitwise: {bitwise}", flush=True)
    if not dev <= lim:
        fail(f"{label} disagrees with {what}")
    return bitwise


def peak_mib(fn) -> float:
    """The peak device memory that ``fn()`` adds to what was allocated
    before it, MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def wall_s(fn, reps: int = 3) -> float:
    """Minimum host wall seconds over ``reps`` runs after one warm-up, each
    ending in a synchronize."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def file_split(in_path: str, out_path: str, cfg) -> dict:
    """The file headline's work stage by stage, each alone over all chunks
    (no overlap): the native reads of the int16 chunks (host wall, each
    chunk dropped as the pipeline drops it), their H2D from pinned buffers,
    the gate with the core slice and the PCM16 quantize (``_chunk_core``;
    CUDA events around the loop, the host's launch work included, and
    ``device_only``: one chunk's device time with the host's work hidden,
    ``queued_ms``, times the chunks), the D2H of the cores into pinned
    buffers (events), and the WAV writes (host wall). Seconds."""
    from noisereduce_tpu_torch import streaming as st
    from noisereduce_tpu_torch.utils import io as nrio

    def events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3

    t0 = time.perf_counter()
    for _ in nrio.stream_chunks(in_path, CHUNK, PADDING, dtype="int16"):
        pass
    read = time.perf_counter() - t0
    pinned = [torch.from_numpy(c).pin_memory()
              for _, c in nrio.stream_chunks(in_path, CHUNK, PADDING, dtype="int16")]
    run = st._view_gate(cfg)
    on_card, h2d = events(lambda: [p.to("cuda", non_blocking=True) for p in pinned])
    cores, device = events(lambda: [st._chunk_core(x, run, PADDING, CHUNK, True)
                                    for x in on_card])
    one = queued_ms(lambda: st._chunk_core(on_card[1], run, PADDING, CHUNK, True))
    device_only = None if one is None else one * len(on_card) / 1e3
    host = [torch.empty(c.shape, dtype=c.dtype, pin_memory=True) for c in cores]
    _, d2h = events(lambda: [h.copy_(c, non_blocking=True) for h, c in zip(host, cores)])
    _, channels, n = nrio.wav_info(in_path)
    t0 = time.perf_counter()
    with nrio.WavWriter(out_path, SR, channels, n) as w:
        for h in host:
            w.write(h.numpy().T)
    write = time.perf_counter() - t0
    return dict(read=read, h2d=h2d, device=device, device_only=device_only, d2h=d2h,
                write=write)


def streaming_phase(nr, K, card, launches, x) -> None:
    """reduce_noise_file on the 960 s headline as a PCM16 WAV, the other file
    engines, StreamingGate and the CLI, each held to its in-memory call, and
    the file engines and StreamingGate also to the staged plain path at
    their own geometry (the in-memory call runs the same kernels)."""
    import tempfile

    from noisereduce_tpu_torch import streaming as st
    from noisereduce_tpu_torch.models.spectral_gate import (
        _gate_nonstationary_staged, stationary_noise_threshold,
    )
    from noisereduce_tpu_torch.parallel.chunking import process_chunked
    from noisereduce_tpu_torch.ops.cuda.dispatch import fused_gate_chunked
    from noisereduce_tpu_torch.utils import io as nrio

    if not nrio.native_available():
        fail("the native IO runtime (libnrio.so) is not available")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "headline.wav"), os.path.join(tmp, "out.wav")
        nrio.write_wav(src, x, SR)  # PCM16, as recordings are
        _, xf = nrio.read_wav(src, dtype="float32")
        n_chunks = (len(xf) - 1) // CHUNK + 1
        per_chunk = dict(spectra=n_chunks, nonstationary_mask=n_chunks,
                         freq_smooth_blend=n_chunks, istft_ola=n_chunks)
        _, launches["file headline"] = run_path(
            K, "file headline", lambda: nr.reduce_noise_file(src, out, as_float=True),
            per_chunk)
        got = nrio.read_wav(out, dtype="float32")[1]
        hold("file headline", got, nr.reduce_noise(xf, SR))
        nr.reduce_noise_file(src, out)
        q = nrio.read_wav(out, dtype="int16")[1]
        if not np.array_equal(q, np.clip(got * 32767.0, -32768, 32767).astype(np.int16)):
            fail("file headline: the PCM16 output is not the host quantize of the float output")
        print("file headline: PCM16 output equals the host quantize of the float output",
              flush=True)
        del got, q
        secs = wall_s(lambda: nr.reduce_noise_file(src, out))
        print(f"file headline {HEADLINE_SECONDS} s @ {SR} Hz, PCM16 in and out "
              f"({os.path.getsize(src) / 1e6:.1f} MB, {n_chunks} chunks): reduce_noise_file "
              f"{secs:.4f} s wall ({HEADLINE_SECONDS / secs:.0f} audio s per wall s), "
              f"native runtime: {nrio.native_available()}, on {card}", flush=True)
        split = file_split(src, out, nr.GateConfig(sr=SR))
        only = split.pop("device_only")
        print("file headline split, each stage alone over all chunks (s): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; sum {sum(split.values()):.4f} against the pipelined wall {secs:.4f}; "
              + ("device work with the host's launch work hidden: not measured" if only is None
                 else f"device work, estimated as one chunk's device time with the host's "
                      f"launch work hidden ({only / n_chunks * 1e3:.3f} ms) x {n_chunks} "
                      f"chunks, {only:.4f} (the pipelined run itself is not traced): idle "
                      f"share of the pipelined wall estimated at {1 - only / secs:.3f}"),
              flush=True)
        os.remove(src)

        # the other engines on the first STREAM_SECONDS
        src = os.path.join(tmp, "short.wav")
        nrio.write_wav(src, x[: STREAM_SECONDS * SR], SR)
        _, xs = nrio.read_wav(src, dtype="float32")
        ys = torch.as_tensor(xs[None]).cuda()
        k = (len(xs) - 1) // CHUNK + 1
        stat = dict(stationary_mask=k, freq_smooth_blend=k, istft_ola=k)
        engines = (
            ("file stationary, first chunk", dict(stationary=True), dict(stat, spectra=k + 1)),
            ("file stationary, whole file", dict(stationary=True, clip_noise_stationary=False),
             dict(stat, spectra=k)),
            ("file use_torch", dict(use_torch=True),
             dict(spectra=k, torch_nonstationary_mask=k, freq_smooth_blend=k, istft_ola=k)),
        )
        for label, kw, want in engines:
            _, launches[label] = run_path(
                K, label, lambda: nr.reduce_noise_file(src, out, as_float=True, **kw), want)
            got = nrio.read_wav(out, dtype="float32")[1]
            if kw.get("clip_noise_stationary") is False:
                # the threshold comes from two streamed passes (torch.fft
                # slabs, float64 sums): held to the in-memory threshold at the
                # JAX package's tolerance, the gate to the in-memory gate
                # given that threshold
                cfg = nr.GateConfig(sr=SR, stationary=True)
                thr = st._streaming_noise_threshold(src, cfg, torch.device("cuda"))
                mem = stationary_noise_threshold(ys[0], cfg)
                tdev = float((thr - mem).abs().max())
                print(f"{label}: streamed threshold vs in-memory max|dev| {tdev:.3e} dB "
                      f"(atol 1e-4, rtol 1e-5)", flush=True)
                if not torch.allclose(thr, mem, atol=1e-4, rtol=1e-5):
                    fail(f"{label}: streamed threshold")
                with torch.no_grad():
                    ref = fused_gate_chunked(ys, cfg, CHUNK, PADDING, thr)[0].cpu().numpy()
                direct = nr.reduce_noise(xs, SR, **kw)
                print(f"{label}: vs reduce_noise(clip_noise_stationary=False) max|dev| "
                      f"{float(np.abs(got - direct).max()):.3e}, bitwise "
                      f"{np.array_equal(got, direct)}", flush=True)
            else:
                ref = nr.reduce_noise(xs, SR, **kw)
                if kw.get("use_torch"):
                    ref_p = torch_staged(ys, nr.api.torch_gate_for(SR), CHUNK, PADDING)
                    hold(label, got, ref_p[0].cpu().numpy(), "the staged plain path")
                else:
                    stationary_vs_plain(label, got, ys, ys[0, :CHUNK],
                                        nr.GateConfig(sr=SR, stationary=True), CHUNK, PADDING)
            hold(label, got, ref)
            secs = wall_s(lambda: nr.reduce_noise_file(src, out, **kw))
            print(f"{label} {STREAM_SECONDS} s @ {SR} Hz: reduce_noise_file {secs:.4f} s wall "
                  f"({STREAM_SECONDS / secs:.0f} audio s per wall s), on {card}", flush=True)

        # StreamingGate: blocks of BLOCK with BLOCK_PAD of lookahead, fed in
        # irregular pieces, each emitted block timed by events and wall
        gate = nr.StreamingGate(SR, BLOCK, BLOCK_PAD).warmup()
        emit, ev_ms, wall_ms = gate._emit, [], []

        def timed_emit(i):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            core = emit(i)  # returns host samples: the device work is done
            end.record()
            end.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(end))
            return core

        gate._emit = timed_emit

        def stream(g):
            parts, s, j = [], 0, 0
            while s < len(xs):
                step = FEEDS[j % len(FEEDS)]
                parts.append(g.process(xs[s : s + step]))
                s, j = s + step, j + 1
            parts.append(g.flush())
            return np.concatenate(parts)

        blocks = (len(xs) - 1) // BLOCK + 1
        got, launches["StreamingGate"] = run_path(
            K, "StreamingGate", lambda: stream(gate),
            dict(spectra=blocks, nonstationary_mask=blocks, freq_smooth_blend=blocks,
                 istft_ola=blocks))
        hold("StreamingGate", got,
             nr.reduce_noise(xs, SR, chunk_size=BLOCK, padding=BLOCK_PAD))
        # the gate's own views (BLOCK + 2 BLOCK_PAD samples, a few dozen
        # frames) against the staged plain path, which shares no kernel
        with torch.no_grad():
            plain = process_chunked(
                lambda v: _gate_nonstationary_staged(v, nr.GateConfig(sr=SR)), ys, BLOCK,
                BLOCK_PAD)
        hold("StreamingGate", got, plain[0].cpu().numpy(), "the staged plain path")
        del plain
        period = BLOCK / SR * 1e3

        def stats(v):
            v = np.sort(np.asarray(v))
            return (f"min {v[0]:.3f} median {np.median(v):.3f} "
                    f"p99 {v[int(0.99 * (len(v) - 1))]:.3f}")

        print(f"StreamingGate {STREAM_SECONDS} s @ {SR} Hz, blocks of {BLOCK} + {BLOCK_PAD} "
              f"lookahead ({len(ev_ms)} blocks, latency {gate.latency_s * 1e3:.1f} ms): ms per "
              f"block, events {stats(ev_ms)}; host wall {stats(wall_ms)}; block period "
              f"{period:.0f} ms; launches per block "
              f"{ {n: c / blocks for n, c in launches['StreamingGate'].items() if c} }, "
              f"on {card}", flush=True)
        if len(ev_ms) != blocks:
            fail("StreamingGate: blocks emitted")

        # stationary StreamingGate: the threshold of the first block, then the
        # stationary kernels on the same views
        sgate = nr.StreamingGate(SR, BLOCK, BLOCK_PAD, stationary=True).warmup()
        got, launches["StreamingGate stationary"] = run_path(
            K, "StreamingGate stationary", lambda: stream(sgate),
            dict(spectra=blocks + 1, stationary_mask=blocks, freq_smooth_blend=blocks,
                 istft_ola=blocks))
        hold("StreamingGate stationary", got,
             nr.reduce_noise(xs, SR, stationary=True, chunk_size=BLOCK, padding=BLOCK_PAD))
        stationary_vs_plain("StreamingGate stationary", got, ys, ys[0, :BLOCK],
                            nr.GateConfig(sr=SR, stationary=True), BLOCK, BLOCK_PAD)
        del got, ys

        # the CLI, as a user runs it, on the same file
        cli_out = os.path.join(tmp, "cli.wav")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "noisereduce_tpu_torch", src, cli_out],
            capture_output=True, text=True, timeout=600, cwd=HERE,
            env={**os.environ, "PYTHONPATH": HERE},
        )
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
        nr.reduce_noise_file(src, out)
        same = np.array_equal(nrio.read_wav(cli_out, dtype="int16")[1],
                              nrio.read_wav(out, dtype="int16")[1])
        print(f"CLI: python -m noisereduce_tpu_torch exit 0 in {secs:.1f} s (process start "
              f"included); output equals reduce_noise_file's: {same}; its summary: "
              f"{proc.stderr.strip().splitlines()[-1]}", flush=True)
        if not same:
            fail("CLI output differs from reduce_noise_file's")


# ---------------------------------------------------------------------------
# the bf16 mode (compute_dtype=torch.bfloat16)
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16
# the kernels with a bfloat16 build (their re/im planes, A's signal, D's
# output); C and G take float32 only
MESH_SHARDS = 4  # the repeated-device mesh, (cuda:0,) * MESH_SHARDS
MESH_PATHS = (  # label, reduce_noise keywords, its kernels, A's launches before the shards
    ("headline", dict(), ("spectra", "nonstationary_mask", "freq_smooth_blend", "istft_ola"), 0),
    ("stationary headline", dict(stationary=True),
     ("spectra", "stationary_mask", "freq_smooth_blend", "istft_ola"), 1),
    ("torch headline", dict(use_torch=True),
     ("spectra", "torch_nonstationary_mask", "freq_smooth_blend", "istft_ola"), 0),
)


def mesh_phase(nr, K, card, launches, x, noise) -> None:
    """Phase 16: chunk sharding over a ``ChunkMesh``. The headline, the
    stationary headline (its threshold on the first device, copied to each)
    and the torch headline with ``mesh=chunk_mesh()`` (the machine's cards)
    and with ``(cuda:0,) * 4`` (four shards one after another on one card:
    the partition, the broadcast and the assembly, not the scaling); the
    headline on the second mesh also with ``max_parallel_chunks=8``; the
    960 s file through ``reduce_noise_file(mesh=(cuda:0,) * 4)``. Each
    output bitwise its ``mesh=None`` call, each kernel of the path launched
    once a piece of a shard (once a group; per-device counts; the file once
    a chunk), and its time (CUDA
    events, min of 3; the file: host wall, min of 2) and peak device memory
    beside the ``mesh=None`` call's."""
    import tempfile

    from noisereduce_tpu_torch.parallel.chunking import mesh_ranges
    from noisereduce_tpu_torch.parallel.mesh import ChunkMesh, chunk_mesh
    from noisereduce_tpu_torch.utils import io as nrio

    ck = dict(chunk_size=CHUNK, padding=PADDING)
    n_chunks = (len(x) - 1) // CHUNK + 1
    repeated = ChunkMesh((torch.device("cuda", 0),) * MESH_SHARDS)
    meshes = {"chunk_mesh()": chunk_mesh(), f"(cuda:0,) * {MESH_SHARDS}": repeated}

    def by_device(mesh, kernels, group=0, before=0):
        """Each kernel of the path once a piece of a shard (a group of
        ``group`` chunks; else ``transfer.piece_chunks`` of the shard's k
        chunks), by device; A ``before`` more on the first device."""
        from noisereduce_tpu_torch.parallel.transfer import piece_chunks

        shard = {}
        for dev, _, k in mesh_ranges(n_chunks, mesh):
            shard[str(dev)] = shard.get(str(dev), 0) + -(-k // (group or piece_chunks(k, CHUNK, 1)))
        want = {name: dict(shard) for name in kernels}
        first = str(mesh.devices[0])
        want["spectra"][first] = want["spectra"].get(first, 0) + before
        return want

    def sharded(label, call, base, base_time, want, unit="ms"):
        out, launches[label] = run_path(K, label, call,
                                        {k: sum(v.values()) for k, v in want.items()})
        got = {k: v for k, v in K.device_counts().items() if v}
        bitwise = np.array_equal(out, base) if unit == "ms" else out == base
        t = time_ms(call) if unit == "ms" else wall_s(call, reps=2)
        mib = peak_mib(call)
        print(f"{label}: bitwise the mesh=None output: {bitwise}; launches by device {got}; "
              f"{t:.4f} {unit} against {base_time[0]:.4f} {unit} with mesh=None; peak device "
              f"memory {mib:.1f} MiB against {base_time[1]:.1f} MiB, on {card}", flush=True)
        if not bitwise:
            fail(f"{label}: differs from the mesh=None output")
        if got != want:
            fail(f"{label}: launches by device {got}, expected {want}")

    t0 = time.perf_counter()
    for name, kw, kernels, before in MESH_PATHS:
        kw = dict(kw, **ck, **({"y_noise": noise} if kw.get("stationary") else {}))
        base = nr.reduce_noise(x, SR, **kw)
        base_time = (time_ms(lambda kw=kw: nr.reduce_noise(x, SR, **kw)),
                     peak_mib(lambda kw=kw: nr.reduce_noise(x, SR, **kw)))
        for mesh_label, mesh in meshes.items():
            sharded(f"{name}, mesh {mesh_label}",
                    lambda kw=kw, mesh=mesh: nr.reduce_noise(x, SR, mesh=mesh, **kw),
                    base, base_time, by_device(mesh, kernels, before=before))
        if name == "headline":
            sharded(f"{name}, mesh (cuda:0,) * {MESH_SHARDS}, max_parallel_chunks {GROUP_CHUNKS}",
                    lambda kw=kw: nr.reduce_noise(x, SR, mesh=repeated,
                                                  max_parallel_chunks=GROUP_CHUNKS, **kw),
                    base, base_time, by_device(repeated, kernels, GROUP_CHUNKS))
        del base
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "headline.wav")
        nrio.write_wav(src, x, SR)  # PCM16
        base_path, mesh_path = os.path.join(tmp, "base.wav"), os.path.join(tmp, "mesh.wav")
        nr.reduce_noise_file(src, base_path)

        def file_call(path, mesh=None):
            nr.reduce_noise_file(src, path, mesh=mesh)
            with open(path, "rb") as f:
                return f.read()

        with open(base_path, "rb") as f:
            base = f.read()
        base_time = (wall_s(lambda: file_call(base_path), reps=2),
                     peak_mib(lambda: file_call(base_path)))
        sharded(f"file headline, mesh (cuda:0,) * {MESH_SHARDS} (PCM16 bytes)",
                lambda: file_call(mesh_path, repeated), base, base_time,
                {k: {"cuda:0": n_chunks} for k in MESH_PATHS[0][2]}, unit="s")
    print(f"mesh phase in {time.perf_counter() - t0:.1f} s", flush=True)


PLANE_KERNELS = ("spectra", "nonstationary_mask", "istft_ola", "stationary_mask",
                 "torch_nonstationary_mask", "output_cast")
# the bf16 output against float32: rel max, rel rms (None: not pinned), the
# envelopes of tests/test_bfloat16_mode.py
BF16_ENVELOPES = {"non-stationary": (2.5e-2, 1.2e-2), "stationary": (1.5e-1, 1.0e-1),
                  "use_torch": (5e-2, None)}
# the bf16 paths' kernels JSON entries: entry -> (kernel, the path it runs on)
BF16_ENTRIES = {
    "spectra_bf16": ("spectra", "bf16 headline"),
    "nonstationary_mask_bf16": ("nonstationary_mask", "bf16 headline"),
    "istft_ola_bf16": ("istft_ola", "bf16 headline"),
    "stationary_mask_bf16": ("stationary_mask", "bf16 stationary headline"),
    "torch_nonstationary_mask_bf16": ("torch_nonstationary_mask", "bf16 torch headline"),
}


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |t|: 2^(e - 8) for |t| in [2^(e-1), 2^e); 0 at 0."""
    a = t.float().abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8), torch.zeros_like(a))


def bf16_hold(label, got, ref, f32_lim):
    """A bf16 kernel's planes or output against its plain version's on the
    same bf16 inputs: each element equal, or one bf16 ulp (of the larger of
    the two) apart, plus ``f32_lim`` (the float32 bound, absolute): the two
    compute float32 values within that bound and each rounds once. Prints
    the shares equal and within one ulp. Returns (max |dev|, share equal,
    share within one ulp)."""
    if got.dtype != BF16 or ref.dtype != BF16 or got.shape != ref.shape:
        fail(f"kernel {label}: {got.dtype} {tuple(got.shape)} against {ref.dtype} "
             f"{tuple(ref.shape)}, not two bf16 tensors of one shape")
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), r.abs()))
    n = d.numel()
    equal, within = int((d == 0).sum()) / n, int((d <= ulp).sum()) / n
    beyond = float((d - ulp).clamp(min=0).max())
    ok = bool(torch.isfinite(g).all()) and beyond <= f32_lim
    print(f"kernel {label}: bf16 {equal:.6f} of the elements equal, {within:.6f} within one "
          f"bf16 ulp; largest |dev| past one ulp {beyond:.3e} (float32 bound {f32_lim:.3e})",
          flush=True)
    if not ok:
        fail(f"kernel {label} disagrees with its plain version")
    return float(d.max()), equal, within


def ptxas_usage(stem: str, kernel: str) -> str:
    """Registers and spill bytes of ``kernel``'s bfloat16 and float32 builds,
    from the ``ptxas -v`` report of ``csrc/<stem>.cu`` that the build keeps
    beside the kernel library (``build.py``)."""
    from noisereduce_tpu_torch.ops.cuda import build

    path = build.library_path().parent / f"{stem}.ptxas.txt"
    if not path.exists():
        return f"{kernel}: no ptxas report at {path}"
    entries = path.read_text().split("Compiling entry function")
    found = []
    for dtype, tag in (("bf16", "I13__nv_bfloat16E"), ("float32", "IfE")):
        e = next((e for e in entries if f"{len(kernel)}{kernel}{tag}" in e), "")
        spill = regex.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        regs = regex.search(r"Used (\d+) registers", e)
        found.append(f"{dtype} {regs.group(1)} registers, {spill.group(1)} / {spill.group(2)} "
                     f"B spill stores / loads" if spill and regs else f"{dtype} not in the report")
    return f"{kernel} (ptxas -v): " + "; ".join(found)


def cluster_ptxas(stem: str) -> dict:
    """Registers and spill bytes of every build of the cluster routes'
    kernels in ``csrc/<stem>.cu`` (A: ``spectra_cluster_kernel``; D:
    ``istft_cluster_kernel`` and ``istft_cluster_ola_kernel``; the
    ``_chirp`` stems the cluster chirp route's builds), by kernel, frames
    a slot, odd radices (``fft_cluster.cuh::cluster_build``) and plane
    type, from the ``ptxas -v`` report the build keeps beside the kernel
    library."""
    from noisereduce_tpu_torch.ops.cuda import build

    path = build.library_path().parent / f"{stem}.ptxas.txt"
    if not path.exists():
        return {"error": f"no ptxas report at {path}"}
    out = {}
    for e in path.read_text().split("Compiling entry function")[1:]:
        name = regex.search(r"\d+((?:spectra|istft)_cluster(?:_ola)?_kernel)I", e)
        spill = regex.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        regs = regex.search(r"Used (\d+) registers", e)
        if not (name and spill and regs):
            continue
        paired = regex.search(r"ILb([01])E", e)
        odd = regex.search(r"ELi(\d+)E", e)
        key = " ".join([name.group(1)]
                       + ([("paired" if paired.group(1) == "1" else "single")] if paired else [])
                       + ([f"odd {odd.group(1)}"] if odd else [])
                       + ["bf16" if "bfloat16" in e.split("\n")[0] else "float32"])
        out[key] = dict(registers=int(regs.group(1)), spill_stores=int(spill.group(1)),
                        spill_loads=int(spill.group(2)))
    return out


def global_ptxas(stem: str) -> dict:
    """Registers and spill bytes of every build of the global chirp route's
    kernels in ``csrc/<stem>.cu`` (the column passes, the row pass, A's
    unpack, D's overlap-add), keyed by the kernel and its template
    arguments as mangled, from the ``ptxas -v`` report the build keeps
    beside the kernel library."""
    from noisereduce_tpu_torch.ops.cuda import build

    path = build.library_path().parent / f"{stem}.ptxas.txt"
    if not path.exists():
        return {"error": f"no ptxas report at {path}"}
    out = {}
    for e in path.read_text().split("Compiling entry function")[1:]:
        m = regex.search(r"\d+((?:spectra|istft)_global_\w+?|global_rows_kernel|"
                         r"istft_cluster_ola_kernel)(I\w*?E)Ev", e)
        spill = regex.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        regs = regex.search(r"Used (\d+) registers", e)
        if m and spill and regs:
            out[m.group(1) + m.group(2)] = dict(
                registers=int(regs.group(1)), spill_stores=int(spill.group(1)),
                spill_loads=int(spill.group(2)))
    return out


def cplx_ptxas(stem: str) -> dict:
    """Registers and spill bytes of every build of the complex-frame kernels
    in ``csrc/<stem>.cu`` (``spectra_cplx_kernel``, ``istft_cplx_kernel``),
    by odd radices (``fft_smem.cuh::build_primes`` / ``large_build``),
    frames a slot, chirp, big block, the large radices and plane type, from
    the ``ptxas -v`` report the build keeps beside the kernel library."""
    from noisereduce_tpu_torch.ops.cuda import build

    path = build.library_path().parent / f"{stem}.ptxas.txt"
    if not path.exists():
        return {"error": f"no ptxas report at {path}"}
    out = {}
    for e in path.read_text().split("Compiling entry function")[1:]:
        m = regex.search(r"\d+((?:spectra|istft)_cplx_kernel)ILi(\d+)E((?:Lb[01]E)+)", e)
        spill = regex.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        regs = regex.search(r"Used (\d+) registers", e)
        if not (m and spill and regs):
            continue
        bools = regex.findall(r"Lb([01])E", m.group(3))  # PAIRED, CHIRP, BIG (, LARGE)
        flags = [w for w, on in zip(("paired", "chirp", "big", "large"), bools) if on == "1"]
        key = " ".join([m.group(1), f"odd {m.group(2)}", *flags,
                        "bf16" if "bfloat16" in e.split("\n")[0] else "float32"])
        stack = regex.search(r"(\d+) bytes stack frame", e)
        out[key] = dict(registers=int(regs.group(1)), spill_stores=int(spill.group(1)),
                        spill_loads=int(spill.group(2)),
                        stack_frame=int(stack.group(1)) if stack else None)
    return out


def real_ptxas(stem: str) -> dict:
    """Registers and spill bytes of every build of the real-FFT kernels in
    ``csrc/<stem>.cu`` (``spectra_pow2_kernel``, ``spectra_fft_kernel``,
    ``istft_fft_kernel``), by odd radices (``fft_smem.cuh::odd_primes``)
    and plane type, from the ``ptxas -v`` report the build keeps beside
    the kernel library."""
    from noisereduce_tpu_torch.ops.cuda import build

    path = build.library_path().parent / f"{stem}.ptxas.txt"
    if not path.exists():
        return {"error": f"no ptxas report at {path}"}
    out = {}
    for e in path.read_text().split("Compiling entry function")[1:]:
        m = regex.search(r"\d+((?:spectra_pow2|spectra_fft|istft_fft)_kernel)I(?:Li(\d+)E)?", e)
        spill = regex.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        regs = regex.search(r"Used (\d+) registers", e)
        if not (m and spill and regs):
            continue
        key = " ".join([m.group(1), f"odd {m.group(2) or 1}",
                        "bf16" if "bfloat16" in e.split("\n")[0] else "float32"])
        out[key] = dict(registers=int(regs.group(1)), spill_stores=int(spill.group(1)),
                        spill_loads=int(spill.group(2)))
    return out


def bf16_measure(label, fn, ref_fn, twin_fn, moved, ops, check, ptxas=None):
    """One bf16 kernel: ``check()`` holds it to its plain version and
    returns its max |dev|; then its time, its float32 twin's (``twin_fn``,
    the float32 build on the float32 inputs), its plain version's, and the
    bound of the bytes it moves (bf16 planes); with ``ptxas`` = (source
    stem, kernel), that kernel's registers and spills in both builds. No
    PyTorch call takes bf16 spectra (``torch.stft`` / ``torch.istft`` run
    float32 and float64): library_ms is null. Returns the numbers of the
    kernels JSON line."""
    extra = check()
    ms, f32_ms, plain_ms = time_ms(fn), time_ms(twin_fn), time_ms(ref_fn)
    bound_ms, bound_by = bound(moved, ops)
    print(f"kernel {label}: bf16 {ms:.3f} ms, its float32 twin {f32_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library none, card bound {bound_ms:.3f} ms ({bound_by}, "
          f"{moved / 1e9:.3f} GB; kernel {ms / bound_ms:.2f}x the bound)"
          + (f"; final pass {ptxas_usage(*ptxas)}" if ptxas else ""), flush=True)
    return dict(extra, ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def e_rule(label, got, ref):
    """Kernel E's rule: at most FLIP_SHARE of the cells off by more than its
    bound (a decision at the threshold), the rest within it."""
    diff = (got - ref).abs()
    off = diff > BOUNDS["stationary_mask"]
    n_off, rest = int(off.sum()), float(diff[~off].max())
    print(f"kernel {label}: {n_off} of {diff.numel()} cells off by more than "
          f"{BOUNDS['stationary_mask']:.0e}; max|dev| over the rest {rest:.3e}", flush=True)
    if n_off > FLIP_SHARE * diff.numel() or not rest <= BOUNDS["stationary_mask"]:
        fail(f"kernel {label} disagrees with its plain version")
    return dict(max_abs_err=float(diff.max()), cells_flipped=n_off, max_abs_err_unflipped=rest)


def mask_abs(label, lim, got, ref):
    dev = float((got - ref).abs().max())
    print(f"kernel {label}: max|dev| {dev:.3e} bound {lim:.0e} (the float32 bound, on the "
          f"same bf16 planes)", flush=True)
    if not (bool(torch.isfinite(got).all()) and dev <= lim):
        fail(f"kernel {label} disagrees with its plain version")
    return dict(max_abs_err=dev)


def bf16_kernel_phase(x_cuda, noise_cuda, cfg, scfg, tgate) -> dict:
    """The bfloat16 builds of A, B, E, D (scipy convention) and A, F, D
    (torch convention) against their plain versions on the same bf16
    inputs at the headline shapes, each timed beside its float32 twin."""
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps
    from noisereduce_tpu_torch.ops.dsp import tri_norm

    out = {}
    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    ngf, ngt = cfg.smoothing
    tt, tf = tri_norm(ngt), tri_norm(ngf)
    xb = x_cuda.to(BF16)
    a, a32 = (xb[None], geo, CHUNK, PADDING), (x_cuda[None], geo, CHUNK, PADDING)
    re, im = K.spectra(*a)
    re32, im32 = K.spectra(*a32)
    ops_a = re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win)

    def check_a(a=a, re=re, im=im, label="spectra (bf16)"):
        rre, rim = K.spectra_ref(*a)
        scale = max(float(rre.float().abs().max()), float(rim.float().abs().max()))
        dev, eq, within = bf16_hold(label, torch.stack([re, im]), torch.stack([rre, rim]),
                                    BOUNDS["spectra"] * scale)
        return dict(max_abs_err=dev, share_equal=eq, share_within_one_ulp=within)

    out["spectra_bf16"] = bf16_measure(
        "spectra (bf16)", lambda: K.spectra(*a), lambda: K.spectra_ref(*a),
        lambda: K.spectra(*a32), nbytes(xb, re, im), ops_a, check_a)

    cells = re.numel()
    bk = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary, tt)
    m = K.nonstationary_mask(re, im, *bk)
    out["nonstationary_mask_bf16"] = bf16_measure(
        "nonstationary_mask (bf16)", lambda: K.nonstationary_mask(re, im, *bk),
        lambda: K.nonstationary_mask_ref(re, im, *bk),
        lambda: K.nonstationary_mask(re32, im32, *bk), nbytes(re, im, m),
        cells * (30.0 + 2 * len(tt)),
        lambda: mask_abs("nonstationary_mask (bf16)", BOUNDS["nonstationary_mask"], m,
                         K.nonstationary_mask_ref(re, im, *bk)),
        ptxas=("nonstationary_mask", "nonstationary_final_kernel"))
    mb = K.freq_smooth_blend(m, tf, cfg.prop_decrease)
    mb32 = K.freq_smooth_blend(K.nonstationary_mask(re32, im32, *bk), tf, cfg.prop_decrease)
    del m

    d, d32 = (re, im, mb, geo, PADDING, CHUNK), (re32, im32, mb32, geo, PADDING, CHUNK)
    y = K.istft_ola(*d)
    ops_d = re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win)

    def check_d(d=d, y=y, label="istft_ola (bf16)"):
        ry = K.istft_ola_ref(*d)
        dev, eq, within = bf16_hold(label, y, ry,
                                    BOUNDS["istft_ola"] * float(ry.float().abs().max()))
        return dict(max_abs_err=dev, share_equal=eq, share_within_one_ulp=within)

    out["istft_ola_bf16"] = bf16_measure(
        "istft_ola (bf16)", lambda: K.istft_ola(*d), lambda: K.istft_ola_ref(*d),
        lambda: K.istft_ola(*d32), nbytes(re, im, mb, y), ops_d, check_d)
    del y, mb, mb32

    thr = stationary_noise_threshold(noise_cuda.to(BF16), scfg)
    if thr.dtype != torch.float32:
        fail(f"the bf16 noise clip's threshold is {thr.dtype}, not float32")
    e = (re, im, thr, 1, scfg.prop_decrease, tt)
    got = K.stationary_mask(*e)
    out["stationary_mask_bf16"] = bf16_measure(
        "stationary_mask (bf16)", lambda: K.stationary_mask(*e),
        lambda: K.stationary_mask_ref(*e),
        lambda: K.stationary_mask(re32, im32, *e[2:]), nbytes(re, im, thr, got),
        cells * (12.0 + 2 * len(tt)),
        lambda: e_rule("stationary_mask (bf16)", got, K.stationary_mask_ref(*e)),
        ptxas=("stationary_mask", "stationary_final_kernel"))
    del got, re, im, re32, im32

    # the torch convention: A's torch table, F, D's torch tail
    tgeo = gate_geometry(tgate.stft_config, CHUNK + 2 * PADDING)
    ta, ta32 = (xb[None], tgeo, CHUNK, PADDING), (x_cuda[None], tgeo, CHUNK, PADDING)
    tre, tim = K.spectra(*ta)
    tre32, tim32 = K.spectra(*ta32)
    out["spectra_bf16"]["torch_table"] = bf16_measure(
        "spectra (bf16, torch table)", lambda: K.spectra(*ta), lambda: K.spectra_ref(*ta),
        lambda: K.spectra(*ta32), nbytes(xb, tre, tim), ops_a,
        lambda: check_a(ta, tre, tim, "spectra (bf16, torch table)"))
    ft, ftt = _rank1_taps(tgate.smoothing)
    fk = (tgate.n_movemean_nonstationary, tgate.n_thresh_nonstationary,
          tgate.temp_coeff_nonstationary, tgate.prop_decrease, ftt)
    fm = K.torch_nonstationary_mask(tre, tim, *fk)
    out["torch_nonstationary_mask_bf16"] = bf16_measure(
        "torch_nonstationary_mask (bf16)", lambda: K.torch_nonstationary_mask(tre, tim, *fk),
        lambda: K.torch_nonstationary_mask_ref(tre, tim, *fk),
        lambda: K.torch_nonstationary_mask(tre32, tim32, *fk), nbytes(tre, tim, fm),
        cells * (40.0 + 2 * len(ftt)),
        lambda: mask_abs("torch_nonstationary_mask (bf16)", BOUNDS["torch_nonstationary_mask"],
                         fm, K.torch_nonstationary_mask_ref(tre, tim, *fk)))
    fb = K.freq_smooth_blend(fm, np.asarray(ft), 1.0)
    fb32 = K.freq_smooth_blend(K.torch_nonstationary_mask(tre32, tim32, *fk), np.asarray(ft), 1.0)
    td, td32 = (tre, tim, fb, tgeo, PADDING, CHUNK), (tre32, tim32, fb32, tgeo, PADDING, CHUNK)
    ty = K.istft_ola(*td)
    out["istft_ola_bf16"]["torch_tail"] = bf16_measure(
        "istft_ola (bf16, torch tail)", lambda: K.istft_ola(*td), lambda: K.istft_ola_ref(*td),
        lambda: K.istft_ola(*td32), nbytes(tre, tim, fb, ty), ops_d,
        lambda: check_d(td, ty, "istft_ola (bf16, torch tail)"))
    del tre, tim, tre32, tim32, fm, fb, fb32, ty, xb
    torch.cuda.empty_cache()
    return out


def bf16_route_phase(x, cfg_for, out) -> None:
    """A and D's bfloat16 builds on every route, at the FFT_CELLS geometries
    (60 s each: n_fft 1536 and 1100 at 48 kHz, 1323, 1102 and 1101 at 44.1
    kHz),
    the cluster chirp route's (n_fft 4803 / hop 1601, 60 s) and the 5 ms
    frames' (n_fft 40 at 8 kHz, the FFT route): one padded view, as
    ``reduce_noise`` takes a signal no longer than a chunk; against their
    plain versions on the same bf16 inputs and beside their float32
    twins. Adds ``routes`` to A's and D's bf16 entries."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry

    cells = [(label, sr, kw, route) for label, sr, secs, kw, route, _ in FFT_CELLS
             if secs == STREAM_SECONDS]
    chirp_cell = next(c for c in LONG_CELLS if c[4] == "cluster_chirp")
    cells.append((chirp_cell[0], chirp_cell[1], chirp_cell[3], chirp_cell[4]))
    cells.append(("small frames geometry", SMALL_SR, SMALL_KW, "fft"))
    out["spectra_bf16"]["routes"], out["istft_ola_bf16"]["routes"] = {}, {}
    for label, sr, kw, route in cells:
        xq = x[: STREAM_SECONDS * SR] if sr == SR else headline_signal(STREAM_SECONDS, sr)
        c = cfg_for(sr, kw)
        v32 = F.pad(torch.as_tensor(xq).cuda()[None], (PADDING, PADDING)).contiguous()
        v = v32.to(BF16)
        geo = gate_geometry(c.stft, v.shape[-1])
        mask = torch.rand((v.shape[0], geo.n_frames, geo.n_bins), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(SEED))
        K.reset_launch_counts()
        re, im = K.spectra(v, geo)
        y = K.istft_ola(re, im, mask, geo, PADDING, len(xq))
        routes, dt = K.route_counts(), K.dtype_counts()
        if any(r[route] != 1 for r in routes.values()) or any(
                dt[k] != {"float32": 0, "bfloat16": 1} for k in ("spectra", "istft_ola")):
            fail(f"bf16 {label}: A and D took {routes}, {dt}, not one bf16 launch each on "
                 f"the {route} route")
        re32, im32 = K.spectra(v32, geo)
        tag = f"bf16, {label}, n_fft {kw['n_fft']}, {route} route"
        ops_a = re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + geo.win)

        def check_a():
            rre, rim = K.spectra_ref(v, geo)
            scale = max(float(rre.float().abs().max()), float(rim.float().abs().max()))
            dev, eq, within = bf16_hold(f"spectra ({tag})", torch.stack([re, im]),
                                        torch.stack([rre, rim]), BOUNDS["spectra"] * scale)
            return dict(max_abs_err=dev, share_equal=eq, share_within_one_ulp=within)

        def check_d():
            ry = K.istft_ola_ref(re, im, mask, geo, PADDING, len(xq))
            dev, eq, within = bf16_hold(f"istft_ola ({tag})", y, ry,
                                        BOUNDS["istft_ola"] * float(ry.float().abs().max()))
            return dict(max_abs_err=dev, share_equal=eq, share_within_one_ulp=within)

        out["spectra_bf16"]["routes"][label] = dict(bf16_measure(
            f"spectra ({tag})", lambda: K.spectra(v, geo), lambda: K.spectra_ref(v, geo),
            lambda: K.spectra(v32, geo), nbytes(v, re, im), ops_a, check_a),
            n_fft=kw["n_fft"], fft_route=route)
        dd = (re, im, mask, geo, PADDING, len(xq))
        out["istft_ola_bf16"]["routes"][label] = dict(bf16_measure(
            f"istft_ola ({tag})", lambda: K.istft_ola(*dd), lambda: K.istft_ola_ref(*dd),
            lambda: K.istft_ola(re32, im32, mask, geo, PADDING, len(xq)),
            nbytes(re, im, mask, y),
            re.shape[0] * re.shape[1] * (fft_ops(geo.n_fft) + 3 * geo.n_bins + 2 * geo.win),
            check_d), n_fft=kw["n_fft"], fft_route=route)
        del re, im, re32, im32, mask, y, v, v32
        torch.cuda.empty_cache()


def rel_devs(ref: np.ndarray, got: np.ndarray):
    """rel max and rel rms of ``got`` against ``ref`` (tests/test_bfloat16_mode.py)."""
    r, d = ref.astype(np.float64), got.astype(np.float64) - ref
    return float(np.abs(d).max() / np.abs(r).max()), float(np.sqrt((d**2).mean() / (r**2).mean()))


def bf16_path(K, card, launches, label, fn32, fn16, expected, envelope, like, dev32, dev16):
    """A path in the bf16 mode as a user calls it: launches counted from 0
    (the bfloat16 builds only, ``run_path``), the output (the input's
    dtype) within ``envelope`` of the float32 call's, and both timed: wall
    (numpy in and out, min of 3, CUDA events) and device time, the path's
    kernels on a signal already on the card (``dev32`` / ``dev16``) with
    the host's launch work hidden (``queued_ms``)."""
    out32 = fn32()
    warned = []

    def quiet16():
        import warnings

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = fn16()
        warned[:] = [str(x.message) for x in w]
        return res

    out16, launches[label] = run_path(K, label, quiet16, expected, dtype="bfloat16")
    check_output(label, out16, like)
    rmax, rrms = rel_devs(out32, out16)
    lim_max, lim_rms = BF16_ENVELOPES[envelope]
    ms32, ms16 = time_ms(fn32), time_ms(quiet16)
    with torch.no_grad():
        d32, d16 = queued_ms(dev32), queued_ms(dev16)

    def fmt(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    print(f"{label}: against the float32 call rel max {rmax:.3e} (envelope {lim_max:.1e}), "
          f"rel rms {rrms:.3e} (envelope {lim_rms}); warned: {bool(warned)}; wall bf16 "
          f"{ms16:.1f} ms, float32 {ms32:.1f} ms; device (the kernels on a card-resident "
          f"signal) bf16 {fmt(d16)}, float32 {fmt(d32)}; on {card}", flush=True)
    if rmax > lim_max or (lim_rms is not None and rrms > lim_rms):
        fail(f"{label}: outside the bf16 envelope of the float32 output")
    return out16, dict(rel_max=rmax, rel_rms=rrms, wall_ms=ms16, f32_wall_ms=ms32,
                       device_ms=d16, f32_device_ms=d32)


def bf16_h2d_ms(x: np.ndarray, rounds: int = 7) -> dict:
    """Host wall ms to bring the float32 array ``x`` to the card as bf16
    through the staged copy (``parallel.transfer``: pinned slabs, the copy
    stream), cast on the host before the copy (its bf16 bits staged as
    int16, then viewed as bf16 on the card) or on the card after it (what
    ``reduce_noise`` does), and of the host cast alone, in interleaved
    rounds after a warm-up: (min, median) of each."""
    from noisereduce_tpu_torch.parallel.transfer import HostSignal

    dev = torch.device("cuda")

    def host_cast():
        bits = torch.as_tensor(x).to(BF16).view(torch.int16).numpy()
        return HostSignal(bits[None], torch.int16).stage(dev).tensor().view(BF16)

    ways = {
        "host_cast": host_cast,
        "card_cast": lambda: HostSignal(x[None], BF16).stage(dev).tensor(),
        "cast_alone": lambda: torch.as_tensor(x).to(BF16),
    }
    if not torch.equal(ways["host_cast"](), ways["card_cast"]()):
        fail("bf16 H2D: the host's cast and the card's differ")
    times = {k: [] for k in ways}
    for r in range(rounds + 1):
        for k, fn in ways.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if r:  # the first round warms up
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (min(v), float(np.median(v))) for k, v in times.items()}


def bf16_phase(nr, K, card, launches, x, noise, results) -> None:
    """The bf16 mode end to end: the H2D of a bf16 signal cast on the host
    and on the card, the headline, the stationary headline and the torch
    headline with ``compute_dtype=torch.bfloat16`` (only bfloat16 builds
    of A, B or E or F and D launched, C float32; within the envelopes of
    the float32 output; timed beside it), the grouped headline bitwise the
    ungrouped one, and ``TPUGate`` at batch 256 of 4 s in bf16."""
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.ops.cuda.dispatch import fused_gate_chunked

    ck = dict(chunk_size=CHUNK, padding=PADDING)
    b16 = dict(ck, compute_dtype=BF16)
    P = HEADLINE_PIECES
    h2d = bf16_h2d_ms(x)
    print(f"bf16 H2D of the {HEADLINE_SECONDS} s signal ({x.nbytes / 1e6:.1f} MB float32) "
          f"through pinned slabs, host wall ms, min / median of 7 interleaved rounds: cast on "
          f"the host (bits equal to the card's cast) then staged "
          f"{h2d['host_cast'][0]:.2f} / {h2d['host_cast'][1]:.2f}, staged then cast on the "
          f"card {h2d['card_cast'][0]:.2f} / {h2d['card_cast'][1]:.2f}, the host cast alone "
          f"{h2d['cast_alone'][0]:.2f} / {h2d['cast_alone'][1]:.2f}; reduce_noise casts on "
          f"the card; on {card}", flush=True)
    cfg, scfg = nr.GateConfig(sr=SR), nr.GateConfig(sr=SR, stationary=True)
    tgate = nr.api.torch_gate_for(SR)
    y32, n32 = torch.as_tensor(x[None]).cuda(), torch.as_tensor(noise).cuda()
    y16, n16 = y32.to(BF16), n32.to(BF16)

    def stationary_on_card(y, n):
        return fused_gate_chunked(y, scfg, CHUNK, PADDING, stationary_noise_threshold(n, scfg))

    paths = {}
    head16, paths["bf16 headline"] = bf16_path(
        K, card, launches, "bf16 headline", lambda: nr.reduce_noise(x, SR, **ck),
        lambda: nr.reduce_noise(x, SR, **b16),
        dict(spectra=P, nonstationary_mask=P, freq_smooth_blend=P, istft_ola=P),
        "non-stationary", x, lambda: fused_gate_chunked(y32, cfg, CHUNK, PADDING),
        lambda: fused_gate_chunked(y16, cfg, CHUNK, PADDING))
    paths["bf16 headline"]["h2d_ms"] = h2d
    _, paths["bf16 stationary headline"] = bf16_path(
        K, card, launches, "bf16 stationary headline",
        lambda: nr.reduce_noise(x, SR, stationary=True, y_noise=noise, **ck),
        lambda: nr.reduce_noise(x, SR, stationary=True, y_noise=noise, **b16),
        dict(spectra=1 + P, stationary_mask=P, freq_smooth_blend=P, istft_ola=P), "stationary", x,
        lambda: stationary_on_card(y32, n32), lambda: stationary_on_card(y16, n16))
    _, paths["bf16 torch headline"] = bf16_path(
        K, card, launches, "bf16 torch headline",
        lambda: nr.reduce_noise(x, SR, use_torch=True, **ck),
        lambda: nr.reduce_noise(x, SR, use_torch=True, **b16),
        dict(spectra=P, torch_nonstationary_mask=P, freq_smooth_blend=P, istft_ola=P),
        "use_torch", x, lambda: tgate.chunked(y32, CHUNK, PADDING),
        lambda: tgate.chunked(y16, CHUNK, PADDING))
    del y32, n32, y16, n16
    torch.cuda.empty_cache()

    n_groups = -(-((len(x) - 1) // CHUNK + 1) // GROUP_CHUNKS)
    grouped, launches["bf16 headline, grouped"] = run_path(
        K, "bf16 headline, grouped",
        lambda: nr.reduce_noise(x, SR, max_parallel_chunks=GROUP_CHUNKS, **b16),
        dict(spectra=n_groups, nonstationary_mask=n_groups, freq_smooth_blend=n_groups,
             istft_ola=n_groups), dtype="bfloat16")
    bitwise = np.array_equal(grouped, head16)
    print(f"bf16 headline grouped, max_parallel_chunks {GROUP_CHUNKS} ({n_groups} groups): "
          f"bitwise the one-launch bf16 output: {bitwise}", flush=True)
    if not bitwise:
        fail("bf16 headline grouped differs from the one-launch output")
    del grouped, head16

    # TPUGate at batch 256 of 4 s (the training batch), bf16 in and out
    gate = nr.TPUGate(sr=GRAD_SR, nonstationary=True)
    n = GRAD_SR * GRAD_SECONDS
    xg = torch.as_tensor(x[: GRAD_BATCHES[-1] * n].reshape(GRAD_BATCHES[-1], n)).cuda()
    xg16 = xg.to(BF16)
    label = f"bf16 TPUGate (batch {GRAD_BATCHES[-1]} x {GRAD_SECONDS} s)"
    with torch.no_grad():
        out, launches[label] = run_path(
            K, label, lambda: gate(xg16),
            dict(spectra=1, torch_nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1),
            dtype="bfloat16")
        ref = gate(xg)
        if out.dtype != BF16 or not bool(torch.isfinite(out.float()).all()):
            fail(f"{label}: output {out.dtype}, or not finite")
        rmax, rrms = rel_devs(ref.cpu().numpy(), out.float().cpu().numpy())
        ms16, ms32 = time_ms(lambda: gate(xg16)), time_ms(lambda: gate(xg))
    print(f"{label}: bf16 out, against the float32 call rel max {rmax:.3e} (envelope "
          f"{BF16_ENVELOPES['use_torch'][0]:.0e}); bf16 {ms16:.3f} ms, float32 {ms32:.3f} ms, "
          f"on {card}", flush=True)
    if rmax > BF16_ENVELOPES["use_torch"][0]:
        fail(f"{label}: outside the use_torch envelope of the float32 output")
    paths[label] = dict(rel_max=rmax, rel_rms=rrms, ms=ms16, f32_ms=ms32)
    del xg, xg16, out, ref
    torch.cuda.empty_cache()
    results["bf16_paths"] = paths


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    import noisereduce_tpu_torch as nr
    from noisereduce_tpu_torch.api import _as_2d
    from noisereduce_tpu_torch.models.spectral_gate import _gate_nonstationary_staged
    from noisereduce_tpu_torch.ops.cuda import build
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry, real_kernel
    from noisereduce_tpu_torch.parallel.chunking import process_chunked

    from noisereduce_tpu_torch.utils import io as nrio

    t_start = time.perf_counter()
    build.load()
    print(
        f"build: {build.library_path().relative_to(HERE)} in "
        f"{time.perf_counter() - t_start:.1f} s (nvcc {build.build_seconds})",
        flush=True,
    )
    t0 = time.perf_counter()
    print(f"build: {nrio.build_library().relative_to(HERE)} (g++) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    from noisereduce_tpu_torch.parallel import host_copy

    t0 = time.perf_counter()
    print(f"build: {os.path.relpath(host_copy.library()._name, HERE)} (g++, the host's "
          f"slab copy) in {time.perf_counter() - t0:.1f} s", flush=True)

    x = headline_signal(HEADLINE_SECONDS)
    noise = noise_clip(NOISE_SECONDS)
    cfg = nr.GateConfig(sr=SR)
    scfg = nr.GateConfig(sr=SR, stationary=True)
    x_cuda = torch.as_tensor(x).cuda()
    noise_cuda = torch.as_tensor(noise).cuda()
    results = kernel_phase(x_cuda, noise_cuda, cfg, scfg)
    tgate = nr.api.torch_gate_for(SR)  # the gate of reduce_noise(x, SR, use_torch=True)
    tsgate = nr.api.torch_gate_for(SR, stationary=True)
    torch_kernel_phase(x_cuda, noise_cuda, tgate, results)
    results.update(bf16_kernel_phase(x_cuda, noise_cuda, cfg, scfg, tgate))
    del x_cuda
    torch.cuda.empty_cache()

    golden_phase(nr)

    def nonstationary_plain(y2d_np, c, cs=CHUNK, pad=PADDING):
        y2d = torch.as_tensor(y2d_np).cuda()
        with torch.no_grad():
            return process_chunked(
                lambda v: _gate_nonstationary_staged(v, c), y2d, cs, pad)

    launches = {}
    ck = dict(chunk_size=CHUNK, padding=PADDING)  # the API's defaults
    P = HEADLINE_PIECES
    if pieces_of(len(x)) != P:
        fail(f"the headline runs in {pieces_of(len(x))} pieces, not {P}")

    # headline: the main path as a user calls it, numpy in and out
    out, launches["headline"] = run_path(
        K, "headline", lambda: nr.reduce_noise(x, SR, **ck),
        dict(spectra=P, nonstationary_mask=P, freq_smooth_blend=P, istft_ola=P))
    check_output("headline", out, x)
    ref = nonstationary_plain(_as_2d(x)[0], cfg)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"headline vs staged plain path: max|dev| {dev:.3e} bound {lim:.3e}",
          flush=True)
    if not dev <= lim:
        fail("headline disagrees with the staged plain path")
    one_copy = one_copy_headline(x, cfg)
    bitwise = np.array_equal(out, one_copy)
    print(f"headline ({P} pieces, the signal through pinned slabs) bitwise the one-copy "
          f"path (the signal on the card whole, then the same gate): {bitwise}", flush=True)
    if not bitwise:
        fail("headline differs from the one-copy path")
    del one_copy
    from noisereduce_tpu_torch.parallel import transfer

    x64 = float64_signal(x)
    staged_callers_phase(nr, K, x, x64, cfg, launches)
    ring = transfer._ring(torch.device("cuda"))
    facts = host_copy.host_facts(torch.device("cuda"), {
        "ring": [(s.ptr, s.nbytes) for s in ring], "signal": [(x.ctypes.data, x.nbytes)]})
    print(f"host: {json.dumps(facts)}; copy threads {transfer.COPY_THREADS}, bound to CPUs "
          f"{facts['copy_cpus'] or 'none (the card has no node)'}", flush=True)
    call_split("headline split", lambda: nr.reduce_noise(x, SR, **ck), K, transfer, card)
    call_split("float64 headline split", lambda: nr.reduce_noise(x64, SR, **ck), K, transfer,
               card)
    del x64
    x16 = int16_signal(x)
    call_split("int16 headline split", lambda: nr.reduce_noise(x16, SR, **ck), K, transfer, card)
    output_cast_phase(K, x16, cfg, card, results)
    del x16
    ms = time_ms(lambda: nr.reduce_noise(x, SR, **ck))
    plain_ms = time_ms(lambda: nonstationary_plain(_as_2d(x)[0], cfg).cpu())
    print(
        f"headline {HEADLINE_SECONDS} s @ {SR} Hz: reduce_noise {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), staged "
        f"plain path {plain_ms:.1f} ms, on {card}",
        flush=True,
    )

    # grouping: the headline in host-driven groups of GROUP_CHUNKS chunks
    # (max_parallel_chunks), bitwise the default call's output, and the peak
    # device memory that each call adds to what was allocated before it: a
    # group holds fewer chunks than the default call's pieces
    n_groups = -(-((len(x) - 1) // CHUNK + 1) // GROUP_CHUNKS)
    per_piece = -(-((len(x) - 1) // CHUNK + 1) // P)
    if not GROUP_CHUNKS < per_piece:
        fail(f"a group of {GROUP_CHUNKS} chunks is no smaller than a piece of {per_piece}")
    grouped, launches["headline, grouped"] = run_path(
        K, "headline, grouped",
        lambda: nr.reduce_noise(x, SR, max_parallel_chunks=GROUP_CHUNKS, **ck),
        dict(spectra=n_groups, nonstationary_mask=n_groups, freq_smooth_blend=n_groups,
             istft_ola=n_groups))
    one_mib = peak_mib(lambda: nr.reduce_noise(x, SR, **ck))
    grouped_mib = peak_mib(lambda: nr.reduce_noise(x, SR, max_parallel_chunks=GROUP_CHUNKS, **ck))
    ms_grouped = time_ms(lambda: nr.reduce_noise(x, SR, max_parallel_chunks=GROUP_CHUNKS, **ck))
    bitwise = np.array_equal(grouped, out)
    print(f"headline grouped, max_parallel_chunks {GROUP_CHUNKS} ({n_groups} groups): "
          f"bitwise the default call's output: {bitwise}; peak device memory "
          f"{grouped_mib:.1f} MiB against {one_mib:.1f} MiB in the default call's {P} pieces "
          f"of up to {per_piece} chunks; reduce_noise {ms_grouped:.1f} ms against {ms:.1f} "
          f"ms, on {card}", flush=True)
    if not bitwise:
        fail("headline grouped differs from the default call's output")
    if not grouped_mib < one_mib:
        fail("headline grouped does not hold less device memory than the default pieces")
    del grouped

    # stationary headline: a separate noise clip
    out, launches["stationary headline"] = run_path(
        K, "stationary headline",
        lambda: nr.reduce_noise(x, SR, stationary=True, y_noise=noise, **ck),
        dict(spectra=1 + P, stationary_mask=P, freq_smooth_blend=P, istft_ola=P))
    check_output("stationary headline", out, x)
    y2d = torch.as_tensor(x[None]).cuda()
    yn = torch.as_tensor(noise).cuda()
    stationary_vs_plain("stationary headline", out, y2d, yn, scfg, CHUNK, PADDING)
    ms = time_ms(lambda: nr.reduce_noise(x, SR, stationary=True, y_noise=noise, **ck))
    print(
        f"stationary headline {HEADLINE_SECONDS} s @ {SR} Hz with a "
        f"{NOISE_SECONDS} s noise clip: reduce_noise {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), on {card}",
        flush=True,
    )
    del y2d, out
    torch.cuda.empty_cache()

    # batch: 32 clips of 10 s, stationary, each its own noise
    clips = [x[i * BATCH_SECONDS * SR : (i + 1) * BATCH_SECONDS * SR]
             for i in range(BATCH_CLIPS)]
    outs, launches["batch"] = run_path(
        K, "batch", lambda: nr.reduce_noise_batch(clips, SR, stationary=True, **ck),
        dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    n_bitwise, dev, scale = 0, 0.0, 0.0
    for clip, o in zip(clips, outs):
        check_output("batch", o, clip)
        want = nr.reduce_noise(clip, SR, stationary=True, **ck)
        n_bitwise += int(np.array_equal(o, want))
        dev = max(dev, float(np.abs(o.astype(np.float64) - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    from noisereduce_tpu_torch.api import _run_stationary

    with torch.no_grad():
        card_clips = torch.as_tensor(np.stack(clips)).cuda()
        one = _run_stationary(card_clips, card_clips[..., :CHUNK], scfg, CHUNK, PADDING)
        one = one.cpu().numpy()
    one_copy = all(np.array_equal(o, w) for o, w in zip(outs, one))
    del card_clips, one
    ms = time_ms(lambda: nr.reduce_noise_batch(clips, SR, stationary=True, **ck))
    print(
        f"batch {BATCH_CLIPS} x {BATCH_SECONDS} s @ {SR} Hz stationary, "
        f"self-noise: {n_bitwise} of {BATCH_CLIPS} outputs bitwise the "
        f"per-signal calls', max|dev| {dev:.3e} bound {E2E_BOUND * scale:.3e}; "
        f"bitwise the one-copy path (the clips stacked on the card first): {one_copy}; "
        f"reduce_noise_batch {ms:.1f} ms on {card}",
        flush=True,
    )
    if not dev <= E2E_BOUND * scale:
        fail("batch disagrees with the per-signal calls")
    if not one_copy:
        fail("batch differs from the one-copy path")

    # staged geometry: a hop that does not divide the window (row 7)
    xs = headline_signal(STAGED_SECONDS, STAGED_SR, SEED + 2)
    out, launches["staged geometry"] = run_path(
        K, "staged geometry", lambda: nr.reduce_noise(xs, STAGED_SR, **STAGED_KW, **ck),
        dict(nonstationary_mask=1))
    check_output("staged geometry", out, xs)
    c = nr.GateConfig(sr=STAGED_SR, **STAGED_KW)
    ref = nonstationary_plain(_as_2d(xs)[0], c)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"staged geometry (n_fft 1024, hop 300) vs staged plain path: max|dev| "
          f"{dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("staged geometry disagrees with the staged plain path")

    # split geometry (row 2), both engines
    xp = headline_signal(SPLIT_SECONDS, SPLIT_SR, SEED + 3)
    out, launches["split geometry"] = run_path(
        K, "split geometry", lambda: nr.reduce_noise(xp, SPLIT_SR, **SPLIT_KW, **ck),
        dict(spectra=1, nonstationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("split geometry", out, xp)
    c = nr.GateConfig(sr=SPLIT_SR, **SPLIT_KW)
    ref = nonstationary_plain(_as_2d(xp)[0], c)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"split geometry (freq_mask_smooth_hz 2000 @ 16 kHz) vs staged plain "
          f"path: max|dev| {dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("split geometry disagrees with the staged plain path")
    out, launches["split geometry, stationary"] = run_path(
        K, "split geometry, stationary",
        lambda: nr.reduce_noise(xp, SPLIT_SR, stationary=True, **SPLIT_KW, **ck),
        dict(spectra=2, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    check_output("split geometry, stationary", out, xp)
    yp = torch.as_tensor(xp[None]).cuda()
    stationary_vs_plain("split geometry, stationary", out, yp, yp[0],
                        nr.GateConfig(sr=SPLIT_SR, stationary=True, **SPLIT_KW),
                        CHUNK, PADDING)

    # torch headline: reduce_noise(use_torch=True), kernels A, F, C, D
    xt = torch.as_tensor(x[None]).cuda()
    out, launches["torch headline"] = run_path(
        K, "torch headline", lambda: nr.reduce_noise(x, SR, use_torch=True, **ck),
        dict(spectra=P, torch_nonstationary_mask=P, freq_smooth_blend=P, istft_ola=P))
    check_output("torch headline", out, x)
    ref = torch_staged(xt, tgate, CHUNK, PADDING)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"torch headline vs staged plain path: max|dev| {dev:.3e} bound {lim:.3e}",
          flush=True)
    if not dev <= lim:
        fail("torch headline disagrees with the staged plain path")
    ms = time_ms(lambda: nr.reduce_noise(x, SR, use_torch=True, **ck))
    plain_ms = time_ms(lambda: torch_staged(torch.as_tensor(x[None]).cuda(), tgate, CHUNK,
                                            PADDING).cpu())
    print(
        f"torch headline {HEADLINE_SECONDS} s @ {SR} Hz: reduce_noise(use_torch=True) "
        f"{ms:.1f} ms ({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), staged "
        f"plain path {plain_ms:.1f} ms, on {card}",
        flush=True,
    )
    del out, ref
    torch.cuda.empty_cache()

    # torch stationary headline: the 10 s noise clip
    out, launches["torch stationary headline"] = run_path(
        K, "torch stationary headline",
        lambda: nr.reduce_noise(x, SR, stationary=True, use_torch=True, y_noise=noise, **ck),
        dict(spectra=1 + P, stationary_mask=P, freq_smooth_blend=P, istft_ola=P))
    check_output("torch stationary headline", out, x)
    torch_stationary_vs_plain("torch stationary headline", out, xt,
                              torch.as_tensor(noise[None]).cuda(), tsgate, CHUNK, PADDING)
    ms = time_ms(lambda: nr.reduce_noise(x, SR, stationary=True, use_torch=True,
                                         y_noise=noise, **ck))
    print(
        f"torch stationary headline {HEADLINE_SECONDS} s @ {SR} Hz with a "
        f"{NOISE_SECONDS} s noise clip: reduce_noise(use_torch=True) {ms:.1f} ms "
        f"({HEADLINE_SECONDS / (ms / 1e3):.0f} audio s per wall s), on {card}",
        flush=True,
    )
    del xt, out
    torch.cuda.empty_cache()

    # torch batch: 32 clips of 10 s, stationary, each view its own statistics
    tk = dict(stationary=True, use_torch=True, **ck)
    outs, launches["torch batch"] = run_path(
        K, "torch batch", lambda: nr.reduce_noise_batch(clips, SR, **tk),
        dict(spectra=1, stationary_mask=1, freq_smooth_blend=1, istft_ola=1))
    n_bitwise = 0
    for clip, o in zip(clips, outs):
        check_output("torch batch", o, clip)
        n_bitwise += int(np.array_equal(o, nr.reduce_noise(clip, SR, **tk)))
    torch_stationary_vs_plain("torch batch", np.stack(outs), torch.as_tensor(np.stack(clips)).cuda(),
                              None, tsgate, CHUNK, PADDING)
    ms = time_ms(lambda: nr.reduce_noise_batch(clips, SR, **tk))
    print(
        f"torch batch {BATCH_CLIPS} x {BATCH_SECONDS} s @ {SR} Hz stationary, "
        f"self statistics: {n_bitwise} of {BATCH_CLIPS} outputs bitwise the "
        f"per-signal calls'; reduce_noise_batch(use_torch=True) {ms:.1f} ms on {card}",
        flush=True,
    )
    if n_bitwise != BATCH_CLIPS:
        fail("torch batch differs from the per-signal calls")

    # torch staged geometry: the plain STFT and iSTFT around F and C
    out, launches["torch staged geometry"] = run_path(
        K, "torch staged geometry",
        lambda: nr.reduce_noise(xs, STAGED_SR, use_torch=True, **STAGED_KW, **ck),
        dict(torch_nonstationary_mask=1, freq_smooth_blend=1))
    check_output("torch staged geometry", out, xs)
    ref = torch_staged(torch.as_tensor(xs[None]).cuda(),
                       nr.api.torch_gate_for(STAGED_SR, **STAGED_KW), CHUNK,
                       PADDING)[0].cpu().numpy()
    dev = float(np.abs(out.astype(np.float64) - ref).max())
    lim = E2E_BOUND * float(np.abs(ref).max())
    print(f"torch staged geometry (n_fft 1024, hop 300) vs staged plain path: "
          f"max|dev| {dev:.3e} bound {lim:.3e}", flush=True)
    if not dev <= lim:
        fail("torch staged geometry disagrees with the staged plain path")

    # A's and D's other routes: each cell's path as a user calls it, against
    # the staged plain path, then A and D at its shapes
    def route_cell(label, xq, sr, kw, route, conv_gate=True):
        c = nr.GateConfig(sr=sr, **kw)
        p = pieces_of(len(xq))
        out, launches[label] = run_path(
            K, label, lambda: nr.reduce_noise(xq, sr, **kw, **ck),
            dict(spectra=p, nonstationary_mask=p, freq_smooth_blend=p, istft_ola=p),
            route=route)
        check_output(label, out, xq)
        ref = nonstationary_plain(_as_2d(xq)[0], c)[0].cpu().numpy()
        dev = float(np.abs(out.astype(np.float64) - ref).max())
        lim = E2E_BOUND * float(np.abs(ref).max())
        secs = len(xq) / sr
        print(f"{label} ({kw}, {secs:g} s at {sr} Hz, {route} route) vs staged plain path: "
              f"max|dev| {dev:.3e} bound {lim:.3e}", flush=True)
        if not dev <= lim:
            fail(f"{label} disagrees with the staged plain path")
        del out, ref
        gate = nr.api.torch_gate_for(sr, **kw) if conv_gate else None
        got = route_kernel_phase(torch.as_tensor(xq).cuda(), c, gate,
                                 f"{label}, n_fft {kw['n_fft']}, {secs:g} s")
        if secs == HEADLINE_SECONDS:
            ms = time_ms(lambda: nr.reduce_noise(xq, sr, **kw, **ck))
            plain_ms = time_ms(lambda: nonstationary_plain(_as_2d(xq)[0], c).cpu())
            print(f"{label} {secs:g} s @ {sr} Hz: reduce_noise({kw}) {ms:.1f} ms "
                  f"({secs / (ms / 1e3):.0f} audio s per wall s), staged plain path "
                  f"{plain_ms:.1f} ms, on {card}", flush=True)
        torch.cuda.empty_cache()
        return got

    before = None
    for label, sr, secs, kw, route, entry in FFT_CELLS:
        xq = x[: secs * SR] if sr == SR else headline_signal(secs, sr)
        got = route_cell(label, xq, sr, kw, route)
        if entry:
            # the route counts name the route, not the source: the real-FFT
            # kernels take exactly the n_fft of real_kernel, the
            # complex-frame kernels the rest of the FFT and chirp routes
            cplx = not real_kernel(kw["n_fft"])
            for name in ("spectra", "istft_ola"):
                if SOURCES[f"{name}_{entry}"].endswith("_cplx.cu") != cplx:
                    fail(f"{name}_{entry}: n_fft {kw['n_fft']} does not launch "
                         f"{SOURCES[f'{name}_{entry}']}")
                results[f"{name}_{entry}"] = dict(
                    got[name], fft_route=route,
                    **({"cell_60s": before[name]} if secs == HEADLINE_SECONDS else {}))
        before = got
    # the complex-frame builds: registers and spills (ptxas -v): each build
    # that spills, and the most spill bytes of a block's and a big block's
    for name, stem in (("spectra_large_radix", "spectra_cplx"),
                       ("istft_ola_large_radix", "istft_cplx")):
        usage = cplx_ptxas(stem)
        builds = {k: u for k, u in usage.items() if isinstance(u, dict)}
        worst = {k: max((u["spill_stores"] + u["spill_loads"] for key, u in builds.items()
                         if ("big" in key.split()) == (k == "big")), default=None)
                 for k in ("block", "big")}
        print(f"complex-frame builds of {stem}.cu (ptxas -v), {len(builds)} builds; "
              + "; ".join([f"{k} {u['registers']} registers, {u['spill_stores']} / "
                           f"{u['spill_loads']} B spill stores / loads, {u['stack_frame']} B "
                           "stack frame" for k, u in builds.items()
                           if u["spill_stores"] + u["spill_loads"]]
                          + [f"{k}: {u}" for k, u in usage.items() if k not in builds])
              + f"; most spill bytes of a block's build {worst['block']}, of a big block's "
              f"{worst['big']}", flush=True)
        results[name]["ptxas"] = usage

    # the real-FFT kernels' builds: registers and spills (ptxas -v), and
    # their persistent grids at the headline
    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    usage = {stem: real_ptxas(stem) for stem in ("spectra_fft", "istft_fft")}
    grids = {f"{name} {str(dtype)[6:]}": K.real_capacity(geo, name, dtype)
             for name in ("spectra", "istft_ola") for dtype in (torch.float32, torch.bfloat16)}
    print("real-FFT builds (ptxas -v): " + "; ".join(
        f"{k} {u['registers']} registers, {u['spill_stores']} / {u['spill_loads']} B spill "
        f"stores / loads" if isinstance(u, dict) else f"{k}: {u}"
        for builds in usage.values() for k, u in builds.items())
        + f"; persistent grids at the headline (blocks): {grids}", flush=True)
    for name, stem in (("spectra", "spectra_fft"), ("istft_ola", "istft_fft")):
        results[name]["ptxas"] = usage[stem]
        results[name]["persistent_grid"] = {k: v for k, v in grids.items() if k.startswith(name)}

    # frames below 64 samples: n_fft 40 on the real-FFT kernels
    xp = headline_signal(SMALL_SECONDS, SMALL_SR)
    got = route_cell("small frames geometry", xp, SMALL_SR, SMALL_KW, "fft")
    if not real_kernel(SMALL_KW["n_fft"]):
        fail(f"n_fft {SMALL_KW['n_fft']} does not launch the real-FFT kernels")
    for name in ("spectra", "istft_ola"):
        results[f"{name}_small"] = dict(got[name], fft_route="fft", routes={})
    xpc = torch.as_tensor(xp).cuda()
    for label, kw, route in SMALL_ROUTE_CELLS:
        K.reset_launch_counts()
        got = route_kernel_phase(xpc, nr.GateConfig(sr=SMALL_SR, **kw),
                                 nr.api.torch_gate_for(SMALL_SR, **kw),
                                 f"small frames, {label}, {SMALL_SECONDS} s")
        took = K.route_counts()
        if any(not v[route] or sum(v.values()) != v[route] for v in took.values()):
            fail(f"small frames, {label}: A and D took {took}, not the {route} route only")
        for name in ("spectra", "istft_ola"):
            results[f"{name}_small"]["routes"][label] = dict(
                got[name], n_fft=kw["n_fft"], fft_route=route,
                real_fft_kernels=real_kernel(kw["n_fft"]))
    del xp, xpc

    # the long frames: the big block, the cluster route and the cluster
    # chirp route; then F8's geometry and the chirp's on every engine
    # against the CPU path
    for label, sr, samples, kw, route, entry in LONG_CELLS:
        got = route_cell(label, x[:samples], sr, kw, route)
        for name in ("spectra", "istft_ola"):
            results[f"{name}_{entry}"] = dict(got[name], fft_route=route)
        if entry == "big":  # A's persistent big blocks: the grid that walks the tiles
            geo = gate_geometry(nr.GateConfig(sr=sr, **kw).stft,
                                (CHUNK if samples > CHUNK else samples) + 2 * PADDING)
            grid = K.cplx_capacity(geo)
            tiles = -(-geo.n_frames // geo.fft_tile_frames) * -(-samples // CHUNK)
            print(f"{label}: kernel A's persistent big blocks: grid {grid} blocks "
                  f"(the card holds {grid} at once) over {tiles} tiles of "
                  f"{geo.fft_tile_frames} frame(s), {tiles / min(grid, tiles):.2f} a block",
                  flush=True)
            results["spectra_big"]["persistent_grid"] = dict(blocks=grid, tiles=tiles)
    # the global chirp route's throughput: its first cell's geometry on all
    # 960 s in reduce_noise's 77 views, A and D alone (counted as a path)
    cell = next(c for c in LONG_CELLS if c[4] == "global_chirp")
    label960 = f"{cell[0]}, {HEADLINE_SECONDS} s, A and D"
    c960 = nr.GateConfig(sr=SR, **cell[3])
    x960 = torch.as_tensor(x).cuda()
    geo960 = gate_geometry(c960.stft, CHUNK + 2 * PADDING)

    def a_and_d():
        re, im = K.spectra(x960[None], geo960, CHUNK, PADDING)
        return K.istft_ola(re, im, torch.ones_like(re), geo960, PADDING, CHUNK)

    _, launches[label960] = run_path(K, label960, a_and_d, dict(spectra=1, istft_ola=1),
                                     route="global_chirp")
    got = route_kernel_phase(x960, c960, None,
                             f"{label960}, n_fft {cell[3]['n_fft']}")
    for name in ("spectra", "istft_ola"):
        results[f"{name}_{GLOBAL_960}"] = dict(got[name], fft_route="global_chirp")
    del x960
    torch.cuda.empty_cache()
    # the global chirp route's builds: registers and spills (ptxas -v)
    for name, stem in (("spectra_global_chirp", "spectra_global"),
                       ("istft_ola_global_chirp", "istft_global")):
        usage = global_ptxas(stem)
        worst = max((u["spill_stores"] + u["spill_loads"] for u in usage.values()
                     if isinstance(u, dict)), default=None)
        print(f"global chirp builds of {stem}.cu (ptxas -v): " + "; ".join(
            f"{k} {u['registers']} registers, {u['spill_stores']} / {u['spill_loads']} B "
            f"spill stores / loads" if isinstance(u, dict) else f"{k}: {u}"
            for k, u in usage.items()) + f"; most spill bytes of a build {worst}", flush=True)
        results[name]["ptxas"] = usage
    # the cluster routes' builds: registers and spills (ptxas -v)
    for name, stem in (("spectra_cluster", "spectra_cluster"),
                       ("istft_ola_cluster", "istft_cluster"),
                       ("spectra_cluster_chirp", "spectra_cluster_chirp"),
                       ("istft_ola_cluster_chirp", "istft_cluster_chirp")):
        usage = cluster_ptxas(stem)
        worst = max((u["spill_stores"] + u["spill_loads"] for u in usage.values()
                     if isinstance(u, dict)), default=None)
        print(f"cluster builds of {stem}.cu (ptxas -v): " + "; ".join(
            f"{k} {u['registers']} registers, {u['spill_stores']} / {u['spill_loads']} B "
            f"spill stores / loads" if isinstance(u, dict) else f"{k}: {u}"
            for k, u in usage.items()) + f"; most spill bytes of a build {worst}", flush=True)
        results[name]["ptxas"] = usage
    for cell in LONG_CELLS[1:]:
        if cell[4] in ("cluster", "cluster_chirp"):
            long_frame_engines(nr, K, launches, x[: cell[2]], cell)

    bf16_route_phase(x, lambda sr, kw: nr.GateConfig(sr=sr, **kw), results)
    bf16_phase(nr, K, card, launches, x, noise, results)

    streaming_phase(nr, K, card, launches, x)
    mesh_phase(nr, K, card, launches, x, noise)
    gradient_phase(nr, K, card, launches)

    main_path = {name: "headline" for name in SOURCES}
    main_path.update(stationary_mask="stationary headline",
                     torch_nonstationary_mask="torch headline",
                     fm_nonstationary_mask="row 6 mask under grad",
                     output_cast="int16 headline",
                     spectra_small="small frames geometry",
                     istft_ola_small="small frames geometry")
    for label, _, secs, _, _, entry in FFT_CELLS + LONG_CELLS:
        if entry:
            main_path[f"spectra_{entry}"] = main_path[f"istft_ola_{entry}"] = label
    main_path[f"spectra_{GLOBAL_960}"] = main_path[f"istft_ola_{GLOBAL_960}"] = label960
    for name in ("spectra", "istft_ola"):
        results[name]["fft_route"] = "fft"
    for name, (kernel, path) in BF16_ENTRIES.items():
        main_path[name] = path
    bf16_paths = results.pop("bf16_paths")

    def count(name, path):
        if name in BF16_ENTRIES:  # the bfloat16 build's launches
            return DTYPES[path][BF16_ENTRIES[name][0]]["bfloat16"]
        if name in ROUTED:
            kernel, route = ROUTED[name]
            return ROUTES[path][kernel][route]
        return DTYPES[path][name]["float32"]

    def entry(name):
        base = BF16_ENTRIES[name][0] if name in BF16_ENTRIES else name
        extra = dict(plane_dtype="bfloat16", path=bf16_paths[main_path[name]]) if (
            name in BF16_ENTRIES) else {}
        return dict(
            name=name, route="cuda", source=SOURCES[base], replaces=REPLACES[base],
            launches=count(name, main_path[name]),
            launches_by_path={p: count(name, p) for p in launches},
            **results[name], **extra,
        )

    kernels = [entry(name) for name in (*SOURCES, *BF16_ENTRIES)]
    print(f"all phases in {time.perf_counter() - t_start:.0f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
