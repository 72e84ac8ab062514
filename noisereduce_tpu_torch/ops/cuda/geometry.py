"""Hopper geometry of the fused gates, both STFT conventions (counterpart
of ``noisereduce_tpu/ops/pallas/geometry.py::_geometry``, ``:372``).

The TPU kernel keeps a chunk's whole time axis resident in VMEM per
128-lane frequency tile, and its geometry is shaped by that: lane tiles with
halo bins, 8/16-row alignment, VMEM budgets and the n_grad_time <= 16 halo.
None of that exists here. The kernels work on exact (rows, n_frames,
n_bins) planes in device memory, and both time and bins are tiled by the
launch shapes below:

- A ``spectra`` and D ``istft_ola`` take one of five routes
  (``kernels.py::ROUTES``), chosen by the geometry alone (``fft_route``,
  the same rules as ``csrc/fft_route.cuh``). A frame's transform has n
  complex points, n_fft/2 for an even n_fft (even samples real, odd
  imaginary) and n_fft for an odd one (two frames a transform). For any
  n_fft: the FFT route when n has no prime factor above 13, or, within a
  block of ``FFT_ELEMS`` points, none above 31 (``LARGE_RADICES``),
  shared-memory mixed-radix FFTs (``csrc/fft_smem.cuh``; an even n_fft
  whose half is 2^k 3^a 5^b 7^c in the real-FFT kernels
  ``csrc/spectra_fft.cu`` / ``csrc/istft_fft.cu``, the rest in the
  complex-frame kernels ``csrc/spectra_cplx.cu`` /
  ``csrc/istft_cplx.cu``);
  the chirp-z route for any other n whose chirp length ``chirp_length``
  (the smallest 2^a 3^b >= 2n - 1, or 8192) fits a big block, in the
  complex-frame kernels. Each kernel takes frame slots of n points (the
  chirp's L), A in tiles of ``fft_tile_frames`` frames, D in runs of
  ``fft_run`` output hop blocks, each block's threads in segments of
  ``fft_seg_warps`` warps; a frame of fewer than ``SMALL_NFFT`` samples
  (n of 1 to 63 points, up to 4,096 slots a block) takes D runs that grow
  with the group, so that a block inverts about as many frames as it
  holds slots. Past a block (4096 points): the cluster route
  for a 13-smooth n with a cluster shape (``cluster_shape``: a four-step
  FFT over a thread block cluster, ``csrc/fft_cluster.cuh``; a big block
  for one below 8192 points without), from 8192 points the cluster chirp
  route for any other n to ``CHIRP_MAX_N`` points (a
  chirp length from ``cluster_chirp_lengths`` over the same four-step
  FFT); past it the global chirp route for any n to 8,388,608 points (a
  chirp length from ``global_chirp_lengths``, L = L1 L2 each within a
  block, ``global_split``: a four-step FFT in passes of ordinary blocks
  through a scratch in device memory, ``csrc/fft_global.cuh``). An n past
  8,388,608 points has no route (``kernels_supported``: the staged twins
  take it).
- B ``nonstationary_mask``, E ``stationary_mask`` and F
  ``torch_nonstationary_mask`` cut each (row, bin) column's time axis into
  segments of ``SEG_B`` / ``SEG_E`` / ``SEG_F`` frames (``TimeTilePlan``,
  ``csrc/time_tiles.cuh``): one thread per (row, segment, bin),
  neighbouring threads on neighbouring bins, so every warp load is one
  coalesced row segment and the whole plane is in flight at once.
  Per-segment partials (B: the IIR's segment ends, E: the dB maxima and
  the statistics' sums, F: the float64 sums of |Z| and their values at the
  window starts' offsets) go to a small (rows, segments, bins) buffer, a
  column kernel combines them in order, and a final pass re-reads
  ``TILE_SEGS`` segments with a halo of n_taps // 2 frames on each side of
  the run, stages them in one shared-memory tile and smooths them there.
  A halo whose tile does not fit in shared memory takes a raw-mask plane
  and a separate smoothing launch. F's moving-average window has no cap:
  it runs on float64 prefix sums, its far ends read from a |Z| plane.
- C ``freq_smooth_blend`` cuts the plane into spans of whole (row,
  frame) lines, about 16 KB each (``freq_smooth_plan``; a line too long
  for a block into pieces with their taps' halo), which persistent
  blocks walk, each loading its next span with 16-byte ``cp.async``
  copies (from the tensor's own alignment) while it smooths this one;
  each thread smooths runs of ``FS_RUN`` outputs of one line from a
  register window, the taps in groups of ``FS_GROUP``.
- G ``fm_nonstationary_mask`` works on frequency-major planes, each
  column contiguous in time (``fm_mask_plan``): a block stages whole
  columns of |Z| in shared memory (8, 4, 2 or 1 a block) and each thread
  walks an odd region of one column, the regions' float64 carries
  combined by warp-shuffle scans; a column past 29,020 frames takes tiles
  of ``FM_THREADS`` x ``FM_TILE_LANE`` frames, their carries combined by a
  column pass in between.

The only structural requirement is that the hop divides the analysis frame
(the window for scipy, n_fft for torch), so an output hop block is the sum
of exactly r = frame_length/hop frame segments. The TPU predicate of the
torch convention (``torch_dispatch.py::fused_tpugate_supported``, ``:55``:
win == n_fft, a 128-aligned hop, r in {2, 4}, n_movemean <= 512, VMEM) has
no counterpart here.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import math

from noisereduce_tpu_torch.config import Convention, StftConfig

# the FFT route (csrc/fft_smem.cuh, must match its constants): complex
# values a block holds, its threads, and the output samples one run of
# kernel D sums
FFT_ELEMS = 4096
FFT_THREADS = 512
FFT_WARPS = FFT_THREADS // 32
FFT_WARP_POINTS = FFT_ELEMS // FFT_WARPS  # points a warp's threads hold
FFT_ACC = 8192
FFT_RUN = 32  # output hop blocks a run of kernel D covers at most, from SMALL_NFFT up
# whole groups a run of kernel D's complex-frame kernel takes at most below
# SMALL_NFFT (its ring of sums holds no run)
CPLX_SMALL_GROUPS = 4
# an n_fft below this (a frame of 1 to 63 samples, up to 4,096 frames a
# block) takes runs of kernel D that grow with its group (``fft_run``)
SMALL_NFFT = 64
# a big block of the complex-frame kernels (fft_smem.cuh::Blk<true>): one
# slot of 4097 to 8192 points, 1024 threads
FFT_BIG_ELEMS = 8192
FFT_BIG_WARPS = FFT_BIG_ELEMS // FFT_WARP_POINTS
REAL_MAX_NFFT = 2 * FFT_ELEMS  # the real-FFT kernels' largest n_fft
# the cluster route (csrc/fft_cluster.cuh): at most this many big blocks a
# cluster, so n to CLUSTER_MAX * FFT_BIG_ELEMS points (n_fft 131072)
CLUSTER_MAX = 8
# the most points the cluster chirp route takes: a chirp length L >= 2n - 1
# within a cluster (csrc/fft_route.cuh::CHIRP_MAX_N)
CHIRP_MAX_N = CLUSTER_MAX * FFT_BIG_ELEMS // 2
# the global chirp route (csrc/fft_global.cuh): a chirp length L = L1 L2
# with each factor within a block, so L to FFT_ELEMS^2 and n to half that
# (csrc/fft_route.cuh::GLOBAL_MAX_L); a launch of each pass takes every
# slot while their scratch stays within GLOBAL_SCRATCH_BYTES (one launch
# over every slot of n_fft 40005 on 960 s, 2.1 GB, ran A and D 13-18%
# faster than groups whose scratch stayed in the card's 50 MB L2: PERF.md),
# else groups of slots that fill it
GLOBAL_MAX_L = FFT_ELEMS * FFT_ELEMS
GLOBAL_SCRATCH_BYTES = 4 << 30
FFT_RADICES = (2, 3, 5, 7, 11, 13)  # the prime radices of fft_smem.cuh's stages
# ... and its large radices (stage_large), for an n within a block
LARGE_RADICES = (17, 19, 23, 29, 31)
REAL_RADICES = (2, 3, 5, 7)  # those of the real-FFT kernels' builds
CHIRP_RADICES = (2, 3)  # those of a chirp length within a block
CLUSTER_CHIRP_RADICES = (2, 3, 5)  # ... and of a cluster chirp length
# the time tiles of kernels B, E and F (csrc/time_tiles.cuh and the
# kernels' sources, must match their constants): frames of a segment of B,
# of E and of F, columns (bins) and segments of a final-pass block, columns
# of a partials / column-kernel block, and the shared memory a block may use
SEG_B = 40
SEG_E = 64
SEG_F = 64
TILE_COLS = 32
TILE_SEGS = 4
PART_COLS = 128
SMEM_MAX = 232448
# kernel G (csrc/fm_nonstationary_mask.cu, must match its THREADS): threads
# of a block; the longest region a thread of a block of several columns
# walks; the frames of a thread's region on the tiled route (odd, as every
# region: the 32 lanes of a warp then read 32 banks)
FM_THREADS = 256
FM_WARPS = FM_THREADS // 32
FM_LANE = 16
FM_TILE_LANE = 15
# kernel C (csrc/freq_smooth_blend.cu, must match its constants): threads of
# a block, outputs a run, taps a group; and the most floats a span holds
FS_THREADS = 256
FS_RUN = 9
FS_GROUP = 12
FS_SPAN = 6144


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def kernels_supported(scfg: StftConfig, n_freq_taps: int = 1) -> bool:
    """Whether the kernels serve this STFT geometry, in either convention,
    with ``n_freq_taps`` frequency taps: a hop that divides the analysis
    frame, an n_fft that has a route (``fft_route``: every n of at most
    GLOBAL_MAX_L / 2 points; an n past it, n_fft 8,388,609 odd or
    16,777,218 even and up, goes to the staged twins), and a line of bins
    that kernel C's plan holds with those taps (``freq_smooth_fits``:
    every line with up to about 14,000 taps, whole or in pieces).
    n_grad_time and n_movemean are unbounded."""
    return (scfg.frame_length % scfg.hop_length == 0
            and fft_route(scfg) is not None
            and freq_smooth_fits(scfg.n_bins, n_freq_taps))


def _strip(n: int, primes: tuple) -> int:
    for p in primes:
        while n % p == 0:
            n //= p
    return n


def fft_n(n_fft: int) -> int:
    """Complex points of one frame's transform on the FFT and chirp routes:
    n_fft/2 for an even n_fft, n_fft for an odd one (two frames a
    transform)."""
    return n_fft if n_fft % 2 else n_fft // 2


def fft_route(scfg: StftConfig):
    """Kernels A and D's route for this geometry (``csrc/fft_route.cuh``),
    from n = ``fft_n``: "fft" for an n with no prime factor above 13 that
    fits a block of FFT_ELEMS points (2, 40, 1024, 1536, 400, 1100, 441,
    1323, odd 3, 63, ...) or is below a big block's FFT_BIG_ELEMS with no
    cluster shape (8580, 5005, ...), or none above 31 that fits a block
    (1102: n = 551 = 19 x 29, 493 = 17 x 29, 34 = 2 x 17, 62 = 2 x 31,
    ...); "cluster" for such a 13-smooth n past a block that takes a
    cluster shape (``cluster_shape``: 12000, 16380, 16384, 40000, 32768,
    ...); "chirp" for any other n whose chirp length fits a big block (an
    n to 4096 with a prime factor above 31: 1101, 4106, odd 37 to 61 of
    the primes, ...); "cluster_chirp" for any other n of at most
    CHIRP_MAX_N points, a chirp-z transform whose length takes a cluster
    shape (4803, 16386, 16940, 65534, ...); "global_chirp" for any other n
    whose 2n - 1 fits GLOBAL_MAX_L, a chirp-z transform over a four-step
    FFT through device memory (40005, 65538, 192000, ...); None for an n
    past GLOBAL_MAX_L / 2 points, which no kernel takes."""
    return _route_of(scfg.n_fft)


# Cached, as _fft_layout: every launch of A and D reads them, and a short
# launch waits for the host.
@functools.lru_cache(maxsize=None)
def _route_of(n_fft: int):
    n = fft_n(n_fft)
    if _strip(n, FFT_RADICES) == 1:
        if cluster_shape(n):
            return "cluster"
        if n < FFT_BIG_ELEMS:
            return "fft"
    elif n <= FFT_ELEMS and _strip(n, FFT_RADICES + LARGE_RADICES) == 1:
        return "fft"
    elif 2 * n - 1 <= FFT_BIG_ELEMS:
        return "chirp"
    if n <= CHIRP_MAX_N:
        return "cluster_chirp"
    return "global_chirp" if 2 * n - 1 <= GLOBAL_MAX_L else None


@functools.lru_cache(maxsize=None)
def cluster_shape(n: int):
    """(c, n1, n2) of the cluster route's four-step FFT of n points
    (``csrc/fft_route.cuh::cluster_shape``): c blocks dividing n1 and n2,
    n = n1 n2, each block holding n / c points, at most a big block's; the
    fewest blocks from 2 to CLUSTER_MAX, then the largest n1 <= n2. None
    for an n that fits a block's FFT_ELEMS, or with no such shape (6000
    takes 2 blocks of 60 x 100, 8192 2 of 64 x 128)."""
    if n <= FFT_ELEMS:
        return None
    for c in range(2, CLUSTER_MAX + 1):
        if n % (c * c) or n // c > FFT_BIG_ELEMS:
            continue
        m = n // (c * c)
        a = max(d for d in range(1, int(m**0.5) + 1) if m % d == 0)
        return c, c * a, c * (m // a)
    return None


@functools.lru_cache(maxsize=None)
def cluster_layout(n: int) -> tuple:
    """(ldc, ldr, buffer) of the cluster route's blocks for n points
    (``csrc/fft_cluster.cuh::make_four``): step 1's n2 points of each
    column at stride ldc (the columns, n1 / c, made odd), step 4's n1
    points of each row at stride ldr (the rows, n2 / c, made odd), and the
    float2 values of each of a block's two buffers, the larger layout made
    even (the second buffer starts on 16 bytes)."""
    c, n1, n2 = cluster_shape(n)
    ldc, ldr = (n1 // c) | 1, (n2 // c) | 1
    size = max(n2 * ldc, n1 * ldr)
    return ldc, ldr, size + size % 2


def cluster_build(n: int) -> int:
    """The odd radices the cluster route's build for n points compiles
    (``csrc/fft_cluster.cuh::cluster_build``): n's odd primes within {3,
    5}, 105 for any other set within 3, 5 and 7, 15015 for a set with 11
    or 13."""
    odd = 1
    for p in (3, 5, 7, 11, 13):
        if n % p == 0:
            odd *= p
    if odd % 11 == 0 or odd % 13 == 0:
        return 15015
    return 105 if odd % 7 == 0 else odd


@functools.lru_cache(maxsize=None)
def real_kernel(n_fft: int) -> bool:
    """Whether the real-FFT kernels serve n_fft on the FFT route: even,
    from 2 to REAL_MAX_NFFT, its half 2^k 3^a 5^b 7^c."""
    return (n_fft % 2 == 0 and 2 <= n_fft <= REAL_MAX_NFFT
            and _strip(n_fft // 2, REAL_RADICES) == 1)


@functools.lru_cache(maxsize=None)
def cluster_chirp_lengths() -> tuple:
    """The cluster chirp route's lengths, ascending: every 2^a 3^b 5^c past
    a big block, within CLUSTER_MAX big blocks, with a cluster shape
    (``csrc/fft_route.cuh::cluster_chirp_length_ok``)."""
    return tuple(L for L in range(FFT_BIG_ELEMS + 1, CLUSTER_MAX * FFT_BIG_ELEMS + 1)
                 if _strip(L, CLUSTER_CHIRP_RADICES) == 1 and cluster_shape(L))


@functools.lru_cache(maxsize=None)
def global_split(L: int):
    """(L1, L2) of a global chirp length L (``csrc/fft_route.cuh::
    global_split``): L1 the largest divisor of L at most sqrt(L), L2 = L /
    L1, so L2 is the least cofactor; None where L2 does not fit a block of
    FFT_ELEMS points (then no split of L does). 81,000 = 270 x 300, 192,000
    = 400 x 480."""
    a = max(d for d in range(1, math.isqrt(L) + 1) if L % d == 0)
    return (a, L // a) if L // a <= FFT_ELEMS else None


@functools.lru_cache(maxsize=None)
def global_chirp_lengths() -> tuple:
    """The global chirp route's lengths, ascending: every 2^a 3^b 5^c past
    CLUSTER_MAX big blocks and within GLOBAL_MAX_L whose split fits two
    blocks (``csrc/fft_route.cuh::global_chirp_length_ok``)."""
    smooth = sorted(v for v in (2**a * 3**b * 5**c for a in range(25) for b in range(16)
                                for c in range(11))
                    if CLUSTER_MAX * FFT_BIG_ELEMS < v <= GLOBAL_MAX_L)
    return tuple(L for L in smooth if global_split(L))


@functools.lru_cache(maxsize=None)
def chirp_length(n: int) -> int:
    """The chirp-z routes' circular convolution length for n points: the
    smallest 2^a 3^b >= 2n - 1 while that fits a block of FFT_ELEMS
    points, else FFT_BIG_ELEMS while 2n - 1 fits a big block (2^a 3^b
    against a power of two or the smallest length with factors up to 13,
    PERF.md), else the smallest cluster chirp length >= 2n - 1
    (``cluster_chirp_lengths``: 2^a 3^b 5^c against 2^a 3^b, PERF.md),
    and past CHIRP_MAX_N points the smallest global chirp length >= 2n - 1
    (``global_chirp_lengths``: n 40005 takes 81,000, 32,769 65,610)
    (``csrc/fft_route.cuh::chirp_length_ok``)."""
    need = 2 * n - 1
    if n > CHIRP_MAX_N:
        lengths = global_chirp_lengths()
        return lengths[bisect.bisect_left(lengths, need)]
    if need > FFT_BIG_ELEMS:
        lengths = cluster_chirp_lengths()
        return lengths[bisect.bisect_left(lengths, need)]
    if need > FFT_ELEMS:
        return FFT_BIG_ELEMS
    return next(L for L in range(need, FFT_ELEMS + 1) if _strip(L, CHIRP_RADICES) == 1)


@functools.lru_cache(maxsize=None)
def global_shape(L: int) -> tuple:
    """(L1, L2, tc, rb) of the global chirp route's passes for a chirp
    length L (``csrc/fft_global.cuh::make_glob``): its split, a column
    block's tile of tc adjacent columns of L1 points (FFT_ELEMS // L1, at
    most L2) and a row block's rb rows of L2 points (FFT_ELEMS // L2, at
    most L1). 81,000: 270 x 300, tiles of 15 columns, 13 rows a block."""
    L1, L2 = global_split(L)
    return L1, L2, min(L2, FFT_ELEMS // L1), min(L1, FFT_ELEMS // L2)


def global_group(L: int, total: int) -> int:
    """Slots of length L that a launch of each of the global chirp route's
    passes takes at once, of ``total``: all of them while their scratch of
    8 L bytes a slot stays within GLOBAL_SCRATCH_BYTES, else as many as
    fit it (81,000: 6,628 slots; 16,777,216: 32)."""
    return max(1, min(total, GLOBAL_SCRATCH_BYTES // (8 * L)))


def _block_frames(warps: int, m: int, block_warps: int = FFT_WARPS) -> int:
    """Frame slots of m points a block of ``block_warps`` warps holds with
    segments of ``warps`` warps, each segment owning whole slots
    (fft_smem.cuh::fft_block_frames)."""
    return (block_warps // warps) * (warps * FFT_WARP_POINTS // m)


@functools.lru_cache(maxsize=None)
def _fft_layout(m: int, block_warps: int = FFT_WARPS) -> tuple:
    """(warps of a thread segment, frame slots of a block) for m-point
    slots: the segment width that fits the most slots, the fewest warps on
    a tie; a power of two for a power of two m, whose indices shift.
    Cached: a launch reads it, and the search costs ~10 us of host time that
    a short launch would wait for."""
    pow2 = m & (m - 1) == 0
    cands = [w for w in range(1, block_warps + 1) if not pow2 or w & (w - 1) == 0]
    warps = max(cands, key=lambda w: (_block_frames(w, m, block_warps), -w))
    return warps, _block_frames(warps, m, block_warps)


@functools.lru_cache(maxsize=None)
def _layout(n_fft: int, route: str) -> tuple:
    """GateGeometry.fft_layout of n_fft on ``route``; on the cluster routes,
    a slot of n points (the chirp length on the cluster chirp route) across
    a cluster, each block's warps one segment, and one slot (two frames for
    an odd n_fft) a group; on the global chirp route a slot of the chirp
    length and one slot a group (its passes' blocks: ``global_shape``)."""
    n = fft_n(n_fft)
    if route == "global_chirp":
        return chirp_length(n), FFT_WARPS, 2 if n_fft % 2 else 1
    if route in ("cluster", "cluster_chirp"):
        slot = chirp_length(n) if route == "cluster_chirp" else n
        return slot, FFT_BIG_WARPS, 2 if n_fft % 2 else 1
    slot = chirp_length(n) if route == "chirp" else n
    warps, slots = _fft_layout(slot, FFT_BIG_WARPS if slot > FFT_ELEMS else FFT_WARPS)
    return slot, warps, slots * (2 if n_fft % 2 else 1)


@dataclasses.dataclass(frozen=True)
class TimeTilePlan:
    """Launch shapes of kernel B, E or F over a (rows, n_frames, n_bins)
    plane with ``n_taps`` time taps; ``words`` is the 4-byte values a
    final-pass thread stages per frame: B 2 (re and im, then the floor and
    |Z|), E and F 1 (the blended mask), or 0 for E or F with one tap, which
    write straight to ``out``. F's window does not enter the plan: its far
    ends are read from device memory, whatever n_movemean.

    A final-pass block holds ``TILE_SEGS`` consecutive segments of
    ``TILE_COLS`` columns and their frames with a halo on each side in one
    shared-memory tile. ``fused``: the final pass smooths from that tile
    with a halo of ``halo`` frames. Otherwise it writes the raw mask to a
    plane and a separate launch smooths it (``halo`` 0 for the final
    pass)."""

    rows: int
    n_frames: int
    n_bins: int
    n_taps: int
    words: int
    seg_len: int

    @property
    def n_segs(self) -> int:
        return max(1, -(-self.n_frames // self.seg_len))

    @property
    def columns(self) -> int:
        return self.rows * self.n_bins

    @property
    def fused(self) -> bool:
        return self._smem(self.n_taps // 2) <= SMEM_MAX

    @property
    def halo(self) -> int:
        """Frames each side of a segment that the final pass reads."""
        return self.n_taps // 2 if self.fused else 0

    def _smem(self, halo: int) -> int:
        return self.words * 4 * TILE_COLS * (TILE_SEGS * self.seg_len + 2 * halo)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a final-pass block (0: one tap of E,
        which writes straight to ``out``)."""
        return self._smem(self.halo)

    @property
    def final_blocks(self) -> int:
        return -(-self.n_segs // TILE_SEGS) * -(-self.columns // TILE_COLS)

    @property
    def part_blocks(self) -> int:
        return self.n_segs * -(-self.columns // PART_COLS)


@dataclasses.dataclass(frozen=True)
class FmMaskPlan:
    """Launch shapes of kernel G over ``n_cols`` columns of ``n_frames``
    frames (``csrc/fm_nonstationary_mask.cu``). A block of FM_THREADS
    threads holds ``cols`` columns of a stretch of ``tile_len`` frames in
    shared memory, FM_WARPS / ``cols`` warps a column, and each thread walks
    a region of ``lane_len`` frames (odd) of one column.

    "resident" (one CUDA launch): whole columns, ``tile_len`` = n_frames.
    "tiled" (three): one column and a tile of FM_THREADS * ``lane_len``
    frames a block, ``n_tiles`` tiles a column."""

    route: str
    cols: int
    lane_len: int
    tile_len: int
    n_tiles: int
    smem_bytes: int
    n_cols: int
    n_frames: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * -(-self.n_cols // self.cols)

    @property
    def last_tile(self) -> int:
        """Frames of a column's last tile (resident: the column)."""
        return self.n_frames - (self.n_tiles - 1) * self.tile_len

    @property
    def short_lane(self) -> int:
        """Frames of the region that holds the last tile's last frame."""
        return self.last_tile - (self.last_tile - 1) // self.lane_len * self.lane_len


def fm_smem(cols: int, tile_len: int) -> int:
    """Kernel G's dynamic shared memory: the warps' two scan aggregates
    (four doubles a warp), then two planes (|Z|, and y then w) of ``cols``
    columns of ``tile_len`` frames, the second one 16-byte aligned after the
    first, both shifted by up to 3 words to the output's 16-byte
    alignment."""
    return 8 * 4 * FM_WARPS + 4 * (3 + 2 * (-(-cols * tile_len // 4) * 4))


@functools.lru_cache(maxsize=256)
def fm_mask_plan(n_cols: int, n_frames: int, route: str | None = None) -> FmMaskPlan:
    """Kernel G's plan. The resident route takes the most columns a block
    (8, 4, 2, 1) whose regions stay within FM_LANE frames (short serial
    walks), one column a block with longer regions past 4,096 frames, while
    the column's two planes fit ``SMEM_MAX`` (to 29,020 frames); the tiled
    route takes longer columns, in regions of FM_TILE_LANE frames.
    ``route`` forces one (the resident route only where it fits)."""
    for cols in (8, 4, 2, 1):
        lane = -(-n_frames // (32 * (FM_WARPS // cols))) | 1  # odd
        if lane <= FM_LANE:
            break
    smem = fm_smem(cols, n_frames)
    fits = smem <= SMEM_MAX
    route = route or ("resident" if fits else "tiled")
    if route == "resident":
        if not fits:
            raise ValueError(f"fm_mask_plan: {n_frames} frames do not fit a block")
        return FmMaskPlan("resident", cols, lane, n_frames, 1, smem, n_cols, n_frames)
    if route != "tiled":
        raise ValueError(f"fm_mask_plan: no route {route!r}")
    tile = FM_THREADS * FM_TILE_LANE
    return FmMaskPlan("tiled", 1, FM_TILE_LANE, tile, -(-n_frames // tile),
                      fm_smem(1, tile), n_cols, n_frames)


@dataclasses.dataclass(frozen=True)
class FreqSmoothPlan:
    """Launch shapes of kernel C over ``n_rows`` lines of ``n_bins`` bins
    with ``n_live`` odd taps (``csrc/freq_smooth_blend.cu``). Block s takes
    the span of lines [s * ``lines``, (s + 1) * ``lines``), the last one
    short; or, with ``piece`` > 0 (a line too long for a block), the span
    of bins [k0, k0 + ``piece``) of one line (``piece_span``), which loads
    ``half`` bins before them and n_taps - 1 - ``half`` after, clipped to
    the line. A line or piece is cut into runs of FS_RUN outputs, the last
    one short. The kernel reads the taps [``first``, ``first`` + 2
    ``half`` + 1) of the live ones, zero padded to ``n_taps``, a multiple
    of FS_GROUP: a tap more than n_bins - 1 bins off centre only ever meets
    the zero fill, so it is dropped."""

    n_rows: int
    n_bins: int
    n_live: int
    lines: int
    piece: int = 0

    @property
    def half(self) -> int:
        return min(self.n_live // 2, self.n_bins - 1)

    @property
    def first(self) -> int:
        return self.n_live // 2 - self.half

    @property
    def n_taps(self) -> int:
        return _round_up(2 * self.half + 1, FS_GROUP)

    @property
    def spans(self) -> int:
        if self.piece:
            return self.n_rows * self.pieces_per_line
        return -(-self.n_rows // self.lines)

    @property
    def pieces_per_line(self) -> int:
        return -(-self.n_bins // self.piece) if self.piece else 1

    def piece_span(self, s: int) -> tuple:
        """(line, k0, k1, lo, hi) of span s of a plan in pieces: outputs
        [k0, k1) of the line, from its input bins [lo, hi)."""
        line, j = divmod(s, self.pieces_per_line)
        k0 = j * self.piece
        return (line, k0, min(self.n_bins, k0 + self.piece), max(0, k0 - self.half),
                min(self.n_bins, k0 + self.piece + self.n_taps - 1 - self.half))

    @property
    def runs_per_line(self) -> int:
        return -(-self.n_bins // FS_RUN)

    @property
    def smem_bytes(self) -> int:
        """The taps, then two input planes and an output plane of a span
        each, with 3 words of slack for their 16-byte phase."""
        floats = self.piece + self.n_taps - 1 if self.piece else self.lines * self.n_bins
        return 4 * (self.n_taps + 3 * (_round_up(floats, 4) + 4))

    def span(self, s: int) -> tuple:
        """(first line, lines) of span s."""
        r0 = s * self.lines
        return r0, min(self.lines, self.n_rows - r0)

    def staging(self, s: int, word: int) -> tuple:
        """(head, pieces, tail) of span s of a plane whose element 0 lies
        ``word`` 4-byte words past a 16-byte boundary: the floats before the
        span's first 16-byte boundary, its 16-byte pieces, and the floats
        after the last one."""
        r0, nl = self.span(s)
        n = nl * self.n_bins
        head = min(n, -(word + r0 * self.n_bins) % 4)
        pieces = (n - head) // 4
        return head, pieces, n - head - 4 * pieces

    def device_taps(self, taps) -> tuple:
        """The taps as the kernel reads them: the kept ones, zero padded."""
        kept = tuple(float(v) for v in taps)[self.first : self.first + 2 * self.half + 1]
        return kept + (0.0,) * (self.n_taps - len(kept))


@functools.lru_cache(maxsize=256)
def freq_smooth_plan(n_rows: int, n_bins: int, n_live: int, piece: int = 0) -> FreqSmoothPlan:
    """Kernel C's plan: the lines a span (at most FS_SPAN floats, at least
    one line) that leave the fewest of a block's threads idle on the last
    pass over the span's runs, the larger span on a tie, while a span's
    three planes and the taps fit ``SMEM_MAX`` (a line of up to about
    19,000 bins). A longer line is cut into pieces of the most outputs, a
    multiple of FS_RUN and at most FS_SPAN, that fit with their taps'
    reach; ``piece`` forces pieces of that many outputs on any line. Raises
    where not even a piece of FS_RUN outputs fits (``freq_smooth_fits``)."""
    if piece:
        plan = FreqSmoothPlan(n_rows, n_bins, n_live, 1, piece)
        if piece % FS_RUN or plan.smem_bytes > SMEM_MAX:
            raise ValueError(f"freq_smooth_plan: no pieces of {piece} bins with {n_live} taps")
        return plan
    per_line = -(-n_bins // FS_RUN)
    best, best_share = 1, 0.0
    for lines in range(1, max(1, FS_SPAN // n_bins) + 1):
        runs = lines * per_line
        share = runs / (-(-runs // FS_THREADS) * FS_THREADS)
        if share >= best_share:
            best, best_share = lines, share
    plan = FreqSmoothPlan(n_rows, n_bins, n_live, best)
    if plan.smem_bytes <= SMEM_MAX:
        return plan
    for piece in range(FS_SPAN // FS_RUN * FS_RUN, 0, -FS_RUN):
        plan = FreqSmoothPlan(n_rows, n_bins, n_live, 1, piece)
        if plan.smem_bytes <= SMEM_MAX:
            return plan
    raise ValueError(f"freq_smooth_plan: a line of {n_bins} bins with {n_live} taps "
                     "does not fit a block, even in pieces")


@functools.lru_cache(maxsize=256)
def freq_smooth_fits(n_bins: int, n_live: int) -> bool:
    """Whether kernel C serves lines of ``n_bins`` bins with ``n_live``
    taps: a plan of whole lines or of pieces fits a block."""
    try:
        freq_smooth_plan(1, n_bins, n_live)
    except ValueError:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class GateGeometry:
    """Shapes of one gate launch over ``rows`` signal rows, each cut into
    ``n_chunks`` views of ``view_len`` samples.

    View c of row h holds source samples
    [c*chunk_stride + view_start, ... + view_len), zero outside [0, n_src);
    the convention's boundary zeros (scipy win//2, torch n_fft//2) extend
    each view on both sides.
    """

    scfg: StftConfig
    view_len: int

    @property
    def win(self) -> int:
        """Samples per analysis frame (scipy: win_length; torch: n_fft)."""
        return self.scfg.frame_length

    @property
    def hop(self) -> int:
        return self.scfg.hop_length

    @property
    def n_fft(self) -> int:
        return self.scfg.n_fft

    @property
    def n_bins(self) -> int:
        return self.scfg.n_bins

    @property
    def r(self) -> int:
        return self.win // self.hop

    @property
    def bpad(self) -> int:
        return self.scfg.boundary_pad

    @property
    def n_frames(self) -> int:
        return self.scfg.n_frames(self.view_len)

    @property
    def n_blocks(self) -> int:
        """Hop blocks of the overlap-added frames (before the edge trim)."""
        return self.n_frames + self.r - 1

    @property
    def istft_len(self) -> int:
        """istft output length: scipy, the full OLA minus win//2 each side;
        torch, the natural (n_frames - 1) * hop."""
        return self.scfg.istft_length(self.n_frames)

    @property
    def env_floor(self) -> float:
        """Envelope entries at or below this count as 1 (scipy 1e-10,
        torch 1e-11)."""
        return 1e-10 if self.scfg.convention == Convention.SCIPY else 1e-11

    # ---- the FFT and chirp routes of kernels A and D
    @property
    def route(self) -> str:
        return fft_route(self.scfg)

    @property
    def fft_n(self) -> int:
        return fft_n(self.n_fft)

    @property
    def fft_paired(self) -> bool:
        """Two frames a transform, one real, one imaginary: an odd n_fft."""
        return self.n_fft % 2 == 1

    @property
    def fft_real(self) -> bool:
        """The real-FFT kernels serve the FFT route (else the complex-frame
        kernels)."""
        return real_kernel(self.n_fft)

    def fft_layout(self, route: str | None = None) -> tuple:
        """(points of a frame slot, warps of a thread segment, frames of a
        tile of kernel A and of a group of kernel D) on ``route`` (the
        geometry's own by default). A slot holds one transform: fft_n
        points, or the chirp length on the chirp route; a slot past
        FFT_ELEMS points takes a big block. A segment owns whole slots and
        syncs alone, so the layout that fits the most slots keeps the most
        lanes busy; on a tie the fewest warps, whose barrier is cheapest
        (one warp: ``__syncwarp``). A power of two M gets max(1, M/256),
        one frame or 256/M frames a warp; M = 768 three warps a frame, 5
        frames a block; M = 200 four warps for 5 frames, 20 a block (one
        frame a warp would leave 7 lanes of 32 idle)."""
        return _layout(self.n_fft, route or self.route)

    @property
    def fft_seg_warps(self) -> int:
        """Warps of one thread segment of A's and D's blocks (fft_layout)."""
        return self.fft_layout()[1]

    @property
    def fft_tile_frames(self) -> int:
        """Frames of one view a block of kernel A transforms together, and
        of one group of kernel D: the frames of the block's slots."""
        return self.fft_layout()[2]

    @property
    def fft_run(self) -> int:
        """Output hop blocks of one row a block of kernel D writes on the
        FFT and chirp routes (the cluster routes have no runs:
        ``cluster_frames``): at most FFT_RUN hop blocks from SMALL_NFFT up,
        and on the real-FFT kernel at most FFT_ACC samples. The real-FFT
        kernel's run is the longest within that whose run + r - 1 frames
        fill whole groups of ``fft_tile_frames``, where one does (29 at hop
        256, r 4, groups of 8: 4 groups, where 32 took a fifth for 3
        frames; 17 at 1536 / 384). The complex-frame kernel's is FFT_RUN,
        the longest it takes (its ring of sums holds no run): a launch
        takes ``cplx_run``, which may be shorter.
        Below SMALL_NFFT a group holds 64 to 8,192 frames, so the run
        grows with it: the run plus r - 1 halo frames (and, for an odd
        n_fft, whose groups start at an even frame, one more) fill whole
        groups, on the real-FFT kernel the fewest in which the halo takes
        at most half (201 at n_fft 40 / hop 10: one group of 204; 4,095 at
        2 / 1: 4,096), on the complex-frame kernel CPLX_SMALL_GROUPS of them
        (363 at odd 37 / 1: four groups of 100 frames, the halo 37 of
        them)."""
        cap = FFT_ACC // self.hop
        group, halo = self.fft_tile_frames, self.r - 1
        if self.n_fft < SMALL_NFFT:
            halo += 1 if self.fft_paired else 0
            if not self.fft_real:
                return CPLX_SMALL_GROUPS * group - halo
            groups = max(1, -(-2 * halo // group))
            return max(1, min(cap, groups * group - halo))
        if not self.fft_real:
            return FFT_RUN
        run = max(1, min(FFT_RUN, cap))
        whole = (run + halo) // group * group - halo
        return whole if whole >= 1 else run

    @property
    def cplx_two_pass(self) -> bool:
        """Whether kernel D's complex-frame kernel (``csrc/istft_cplx.cu``)
        takes the geometry in the cluster routes' two passes: a slot past
        FFT_ELEMS points (a big block, one slot a group), each frame of the
        output window (``cluster_frames``) inverted once into a scratch of
        (rows, frames, win) float32, then the overlap-add pass. Smaller
        slots take the walk over runs (``cplx_run``), which ran faster there
        at 1100 on 960 s, 1323 and 37 (PERF.md)."""
        return self.fft_layout()[0] > FFT_ELEMS

    def cplx_run(self, rows: int, n_out: int, blocks: int) -> int:
        """Output hop blocks a run of kernel D's complex-frame walk
        (``csrc/istft_cplx.cu``, a slot within a block: not
        ``cplx_two_pass``) takes on ``rows`` rows of ``n_out`` hop blocks
        walked by ``blocks`` persistent blocks (``kernels.cplx_capacity``):
        of ``fft_run`` and the shorter runs that fill whole groups of
        ``fft_tile_frames`` (k G - halo: r - 1 halo frames and, for an odd
        n_fft, one more), the one whose rounds of the grid times its groups
        and one more (the run's last flush of the ring) are fewest, the
        longest on a tie. 25 at 1100 / 275 on 5 views of 600,000-sample
        cores (2,182 hop blocks a view, 7 frames a group, 264 blocks: 2
        rounds of 4 groups and a flush, where 32 take 2 of 5 and a flush);
        32 at 960 s in 77 views. Without the flush's group the choice ran D
        2.5% slower at 1100 on 960 s and 6.9% at 37 than ``fft_run``
        (PERF.md)."""
        group = self.fft_tile_frames
        halo = self.r - 1 + (1 if self.fft_paired else 0)
        longest = self.fft_run

        def cost(run: int) -> int:
            rounds = -(-rows * -(-n_out // run) // blocks)
            return rounds * (-(-(run + halo) // group) + 1)

        runs = [longest] + [k * group - halo for k in range((longest + halo) // group, 0, -1)
                            if 1 <= k * group - halo < longest]
        return min(runs, key=cost)  # the first of the fewest: the longest

    def cluster_frames(self, j0: int, n_out: int) -> tuple:
        """(t_lo, n_fr): the frames t_lo to t_lo + n_fr - 1 of each row
        that kernel D's cluster and global chirp routes transform, once
        each, for output hop blocks [j0, j0 + n_out) (``out_blocks``):
        every frame that overlaps them, from an even frame for an odd n_fft
        (two frames a transform), held in a scratch of (rows, n_fr, win)
        float32 for its overlap-add pass (``csrc/istft_cluster.cu``,
        ``csrc/istft_global.cu``)."""
        t_lo = max(0, j0 - self.r + 1)
        if self.fft_paired:
            t_lo -= t_lo % 2
        t_hi = min(self.n_frames - 1, j0 + n_out - 1)
        return t_lo, max(0, t_hi - t_lo + 1)

    @property
    def cluster(self) -> tuple:
        """(c, n1, n2) of the cluster routes' FFT (``cluster_shape`` of n,
        or of the chirp length on the cluster chirp route)."""
        return cluster_shape(self.fft_layout()[0])

    def out_blocks(self, out_off: int, out_len: int) -> tuple:
        """(first hop block, count) of the OLA blocks that cover trimmed
        output samples [out_off, out_off + out_len)."""
        lo = self.bpad + out_off
        j0 = lo // self.hop
        j1 = -(-(lo + out_len) // self.hop)
        return j0, j1 - j0


def gate_geometry(scfg: StftConfig, view_len: int) -> GateGeometry:
    if not kernels_supported(scfg):
        raise NotImplementedError(
            "the kernels need a hop that divides the analysis frame and an "
            "n_fft whose transform has at most 8,388,608 points (got "
            f"n_fft={scfg.n_fft}, frame_length={scfg.frame_length}, hop={scfg.hop_length}, "
            f"convention={scfg.convention!r}); see ROADMAP.md, Queue 6"
        )
    return GateGeometry(scfg=scfg, view_len=view_len)
