"""Hopper geometry of the fused gates, both STFT conventions (counterpart
of ``noisereduce_tpu/ops/pallas/geometry.py::_geometry``, ``:372``).

The TPU kernel keeps a chunk's whole time axis resident in VMEM per
128-lane frequency tile, and its geometry is shaped by that: lane tiles with
halo bins, 8/16-row alignment, VMEM budgets and the n_grad_time <= 16 halo.
None of that exists here. The kernels work on exact (rows, n_frames,
n_bins) planes in device memory, and both time and bins are tiled by the
launch shapes below:

- A ``spectra`` and D ``istft_ola`` take one of three routes, chosen by
  the geometry alone (``fft_route``, the same rules as
  ``csrc/fft_route.cuh``). A frame's transform has n complex points,
  n_fft/2 for an even n_fft (even samples real, odd imaginary) and n_fft
  for an odd one (two frames a transform). For an n_fft from
  ``FFT_MIN_NFFT`` to ``FFT_MAX_NFFT``: the FFT route when n has no prime
  factor above 13, shared-memory mixed-radix FFTs (``csrc/fft_smem.cuh``;
  an even n_fft whose half is 2^k 3^a 5^b 7^c in the real-FFT kernels
  ``csrc/spectra_fft.cu`` / ``csrc/istft_fft.cu``, the rest in the
  complex-frame kernels ``csrc/spectra_cplx.cu`` / ``csrc/istft_cplx.cu``);
  the chirp-z route for any other n whose chirp length ``chirp_length``
  (the smallest 2^a 3^b >= 2n - 1, or 8192) fits a big block, in the
  complex-frame kernels. Each kernel takes frame slots of n points (the
  chirp's L), A in tiles of ``fft_tile_frames`` frames, D in runs of
  ``fft_run`` output hop blocks, each block's threads in segments of
  ``fft_seg_warps`` warps. Any other
  n_fft (below 64, above 8192, an odd one above 4096 with a prime factor
  above 13) takes implicit matrix products tiled 128 x ``GEMM_BN`` x
  ``GEMM_BK`` (frames x DFT columns x window samples for A; output hop
  blocks x hop x shifted bins for D).
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
  frame) lines, about 16 KB each (``freq_smooth_plan``), which persistent
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

import dataclasses
import functools

from noisereduce_tpu_torch.config import Convention, StftConfig

# tile shape of csrc/gemm_tile.cuh (must match its constants): the constant
# tables are zero padded to it
GEMM_BN = 128
GEMM_BK = 8
# the FFT route (csrc/fft_smem.cuh, must match its constants): complex
# values a block holds, its threads, and the output samples one run of
# kernel D sums
FFT_ELEMS = 4096
FFT_THREADS = 512
FFT_WARPS = FFT_THREADS // 32
FFT_WARP_POINTS = FFT_ELEMS // FFT_WARPS  # points a warp's threads hold
FFT_ACC = 8192
FFT_RUN = 32  # output hop blocks a run of kernel D covers at most
# a big block of the complex-frame kernels (fft_smem.cuh::Blk<true>): one
# slot of 4097 to 8192 points, 1024 threads
FFT_BIG_ELEMS = 8192
FFT_BIG_WARPS = FFT_BIG_ELEMS // FFT_WARP_POINTS
FFT_MIN_NFFT, FFT_MAX_NFFT = 64, FFT_BIG_ELEMS
FFT_RADICES = (2, 3, 5, 7, 11, 13)  # the prime radices of fft_smem.cuh's stages
REAL_RADICES = (2, 3, 5, 7)  # those of the real-FFT kernels' builds
CHIRP_RADICES = (2, 3)  # those of a chirp length within a block
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


def kernels_supported(scfg: StftConfig) -> bool:
    """Whether the kernels serve this STFT geometry, in either convention:
    a hop that divides the analysis frame. There is no size limit;
    n_grad_time, n_grad_freq and n_movemean are unbounded."""
    return scfg.frame_length % scfg.hop_length == 0


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


def fft_route(scfg: StftConfig) -> str:
    """Kernels A and D's route for this geometry (``csrc/fft_route.cuh``):
    "fft" for an n_fft from FFT_MIN_NFFT to FFT_MAX_NFFT whose
    ``fft_n`` has no prime factor above 13 (1024, 1536, 400, 1100, 441,
    1323, ...); "chirp" for any other such n_fft whose chirp length fits a
    big block (1102, 1101, every even n_fft up to 8192); "product" for the
    rest: n_fft below 64 or above 8192, and an odd n_fft above 4096 with a
    prime factor above 13."""
    return _route_of(scfg.n_fft)


# Cached, as _fft_layout: every launch of A and D reads them, and a short
# launch waits for the host.
@functools.lru_cache(maxsize=None)
def _route_of(n_fft: int) -> str:
    if not FFT_MIN_NFFT <= n_fft <= FFT_MAX_NFFT:
        return "product"
    n = fft_n(n_fft)
    if _strip(n, FFT_RADICES) == 1:
        return "fft"
    return "chirp" if 2 * n - 1 <= FFT_BIG_ELEMS else "product"


@functools.lru_cache(maxsize=None)
def real_kernel(n_fft: int) -> bool:
    """Whether the real-FFT kernels serve n_fft on the FFT route: even, its
    half 2^k 3^a 5^b 7^c."""
    return (n_fft % 2 == 0 and FFT_MIN_NFFT <= n_fft <= FFT_MAX_NFFT
            and _strip(n_fft // 2, REAL_RADICES) == 1)


@functools.lru_cache(maxsize=None)
def chirp_length(n: int) -> int:
    """The chirp-z route's circular convolution length for n points: the
    smallest 2^a 3^b >= 2n - 1 while that fits a block of FFT_ELEMS
    points, else FFT_BIG_ELEMS (``csrc/fft_route.cuh::chirp_length_ok``;
    2^a 3^b against a power of two or the smallest length with factors up
    to 13, PERF.md)."""
    need = 2 * n - 1
    if need > FFT_ELEMS:
        return FFT_BIG_ELEMS
    return next(L for L in range(need, FFT_ELEMS + 1) if _strip(L, CHIRP_RADICES) == 1)


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
    """GateGeometry.fft_layout of n_fft on ``route``."""
    n = fft_n(n_fft)
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
    short; a line is cut into runs of FS_RUN outputs, the last one short.
    The kernel reads the taps [``first``, ``first`` + 2 ``half`` + 1) of
    the live ones, zero padded to ``n_taps``, a multiple of FS_GROUP: a
    tap more than n_bins - 1 bins off centre only ever meets the zero fill,
    so it is dropped."""

    n_rows: int
    n_bins: int
    n_live: int
    lines: int

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
        return -(-self.n_rows // self.lines)

    @property
    def runs_per_line(self) -> int:
        return -(-self.n_bins // FS_RUN)

    @property
    def smem_bytes(self) -> int:
        """The taps, then two input planes and an output plane of a span
        each, with 3 words of slack for their 16-byte phase."""
        cap = _round_up(self.lines * self.n_bins, 4) + 4
        return 4 * (self.n_taps + 3 * cap)

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
def freq_smooth_plan(n_rows: int, n_bins: int, n_live: int) -> FreqSmoothPlan:
    """Kernel C's plan: the lines a span (at most FS_SPAN floats, at least
    one line) that leave the fewest of a block's threads idle on the last
    pass over the span's runs, the larger span on a tie. A span's three
    planes and the taps must fit ``SMEM_MAX`` (a line of up to about
    19,000 bins)."""
    per_line = -(-n_bins // FS_RUN)
    best, best_share = 1, 0.0
    for lines in range(1, max(1, FS_SPAN // n_bins) + 1):
        runs = lines * per_line
        share = runs / (-(-runs // FS_THREADS) * FS_THREADS)
        if share >= best_share:
            best, best_share = lines, share
    plan = FreqSmoothPlan(n_rows, n_bins, n_live, best)
    if plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"freq_smooth_plan: a line of {n_bins} bins with {n_live} taps "
                         "does not fit a block")
    return plan


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
        """Output hop blocks of one row a block of kernel D writes."""
        return max(1, min(FFT_RUN, FFT_ACC // self.hop))

    # ---- kernel A, product route: analysis table (k_a x cols_a), row n =
    # window sample
    @property
    def k_a(self) -> int:
        return _round_up(self.win, GEMM_BK)

    @property
    def cols_a(self) -> int:
        """re columns [0, n_bins), im columns [n_bins, 2*n_bins), padded."""
        return _round_up(2 * self.n_bins, GEMM_BN)

    # ---- kernel D, product route: synthesis table (r * f2 x cols_d), row
    # i*f2 + col
    @property
    def f2(self) -> int:
        """Per-shift contraction width: re and im bins, padded to GEMM_BK so
        a K tile never straddles two shifts."""
        return _round_up(2 * self.n_bins, GEMM_BK)

    @property
    def k_d(self) -> int:
        return self.r * self.f2

    @property
    def cols_d(self) -> int:
        return _round_up(self.hop, GEMM_BN)

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
            "the kernels need a hop that divides the analysis frame (got "
            f"frame_length={scfg.frame_length}, hop={scfg.hop_length}, "
            f"convention={scfg.convention!r}); see ROADMAP.md, Queue 2"
        )
    return GateGeometry(scfg=scfg, view_len=view_len)
