"""Hopper geometry of the fused non-stationary gate (counterpart of
``noisereduce_tpu/ops/pallas/geometry.py::_geometry``, ``:372``).

The TPU kernel keeps a chunk's whole time axis resident in VMEM per
128-lane frequency tile, and its geometry is shaped by that: lane tiles with
halo bins, 8/16-row alignment, VMEM budgets and the n_grad_time <= 16 halo.
None of that exists here. The kernels work on exact (rows, n_frames,
n_bins) planes in device memory, and both time and bins are tiled by the
launch shapes below:

- A ``spectra`` and D ``istft_ola`` are implicit matrix products tiled
  128 x ``GEMM_BN`` x ``GEMM_BK`` (frames x DFT columns x window samples
  for A; output hop blocks x hop x shifted bins for D).
- B ``nonstationary_mask`` runs one thread per (row, bin) down the time
  axis, so the IIR carry never crosses a block.
- C ``freq_smooth_blend`` runs one block per (row, frame).

The only structural requirement is that the hop divides the window, so an
output hop block is the sum of exactly r = win/hop frame segments.
"""
from __future__ import annotations

import dataclasses

from noisereduce_tpu_torch.config import Convention, StftConfig

# tile shape of csrc/gemm_tile.cuh (must match its constants): the constant
# tables are zero padded to it
GEMM_BN = 128
GEMM_BK = 8


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def kernels_supported(scfg: StftConfig) -> bool:
    """Whether kernels A-D serve this STFT geometry: scipy convention and a
    hop that divides the window. There is no size limit; n_grad_time and
    n_grad_freq are unbounded."""
    return (
        scfg.convention == Convention.SCIPY
        and not scfg.quantize_window_f32
        and scfg.frame_length % scfg.hop_length == 0
    )


@dataclasses.dataclass(frozen=True)
class GateGeometry:
    """Shapes of one gate launch over ``rows`` signal rows, each cut into
    ``n_chunks`` views of ``view_len`` samples.

    View c of row h holds source samples
    [c*chunk_stride + view_start, ... + view_len), zero outside [0, n_src);
    scipy's win//2 boundary zeros extend each view on both sides.
    """

    scfg: StftConfig
    view_len: int

    @property
    def win(self) -> int:
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
        """scipy istft output length: full OLA minus win//2 each side."""
        return self.win + (self.n_frames - 1) * self.hop - 2 * self.bpad

    # ---- kernel A: analysis table (k_a x cols_a), row n = window sample
    @property
    def k_a(self) -> int:
        return _round_up(self.win, GEMM_BK)

    @property
    def cols_a(self) -> int:
        """re columns [0, n_bins), im columns [n_bins, 2*n_bins), padded."""
        return _round_up(2 * self.n_bins, GEMM_BN)

    # ---- kernel D: synthesis table (r * f2 x cols_d), row i*f2 + col
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
            "kernels A-D need the scipy convention and a hop that divides "
            f"the window (got win={scfg.frame_length}, hop={scfg.hop_length}, "
            f"convention={scfg.convention!r}); see ROADMAP.md, Queue 2"
        )
    return GateGeometry(scfg=scfg, view_len=view_len)
