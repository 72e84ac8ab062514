"""Hopper geometry of the fused gates, both STFT conventions (counterpart
of ``noisereduce_tpu/ops/pallas/geometry.py::_geometry``, ``:372``).

The TPU kernel keeps a chunk's whole time axis resident in VMEM per
128-lane frequency tile, and its geometry is shaped by that: lane tiles with
halo bins, 8/16-row alignment, VMEM budgets and the n_grad_time <= 16 halo.
None of that exists here. The kernels work on exact (rows, n_frames,
n_bins) planes in device memory, and both time and bins are tiled by the
launch shapes below:

- A ``spectra`` and D ``istft_ola`` take one of two routes, chosen by the
  geometry alone (``fft_route``). For a power-of-two n_fft from
  ``FFT_MIN_NFFT`` to ``FFT_MAX_NFFT``, shared-memory FFTs
  (``csrc/spectra_fft.cu``, ``csrc/istft_fft.cu`` over
  ``csrc/fft_smem.cuh``): A in tiles of ``fft_tile_frames`` frames, D in
  runs of ``fft_run`` output hop blocks. For any other n_fft, implicit
  matrix products tiled 128 x ``GEMM_BN`` x ``GEMM_BK`` (frames x DFT
  columns x window samples for A; output hop blocks x hop x shifted bins
  for D).
- B ``nonstationary_mask``, E ``stationary_mask`` and F
  ``torch_nonstationary_mask`` run one thread per (row, bin) down the time
  axis, so the IIR carry or the moving-average window never crosses a
  block.
- C ``freq_smooth_blend`` runs one block per (row, frame).

The only structural requirement is that the hop divides the analysis frame
(the window for scipy, n_fft for torch), so an output hop block is the sum
of exactly r = frame_length/hop frame segments. The TPU predicate of the
torch convention (``torch_dispatch.py::fused_tpugate_supported``, ``:55``:
win == n_fft, a 128-aligned hop, r in {2, 4}, n_movemean <= 512, VMEM) has
no counterpart here.
"""
from __future__ import annotations

import dataclasses

from noisereduce_tpu_torch.config import Convention, StftConfig

# tile shape of csrc/gemm_tile.cuh (must match its constants): the constant
# tables are zero padded to it
GEMM_BN = 128
GEMM_BK = 8
# the FFT route (csrc/fft_smem.cuh, must match its constants): complex
# values a block holds, and the output samples one run of kernel D sums
FFT_ELEMS = 4096
FFT_ACC = 8192
FFT_RUN = 32  # output hop blocks a run of kernel D covers at most
FFT_MIN_NFFT, FFT_MAX_NFFT = 64, 2 * FFT_ELEMS


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def kernels_supported(scfg: StftConfig) -> bool:
    """Whether the kernels serve this STFT geometry, in either convention:
    a hop that divides the analysis frame. There is no size limit;
    n_grad_time, n_grad_freq and n_movemean are unbounded."""
    return scfg.frame_length % scfg.hop_length == 0


def fft_route(scfg: StftConfig) -> bool:
    """Whether kernels A and D take the FFT route for this geometry: a
    power-of-two n_fft from FFT_MIN_NFFT to FFT_MAX_NFFT. Any other n_fft
    takes the DFT-product route."""
    n = scfg.n_fft
    return FFT_MIN_NFFT <= n <= FFT_MAX_NFFT and n & (n - 1) == 0


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

    # ---- the FFT route of kernels A and D
    @property
    def fft_tile_frames(self) -> int:
        """Frames of one view a block of kernel A transforms together."""
        return FFT_ELEMS // (self.n_fft // 2)

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
