"""Static configuration of the spectral-gating pipeline (PyTorch port).

The port's own copy of ``noisereduce_tpu/config.py``: importing that module
runs ``noisereduce_tpu/__init__.py``, which imports JAX, and a CUDA
deployment has no JAX. Everything here is plain Python; the frozen
``GateConfig`` plus the numpy constant tables derived from it is the whole
state of the gate (the system has no weights).

Reference semantics being reproduced:
  - STFT parameter defaulting ``win_length = n_fft``, ``hop = win // 4``
    (spectralgate/base.py:79-86).
  - Mask-smoothing kernel sizing (spectralgate/base.py:99-128).
  - Non-stationary IIR coefficient from ``time_constant_s``
    (spectralgate/nonstationary.py:106-115).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


class Convention:
    """STFT framing/scaling conventions of the two reference backends."""

    SCIPY = "scipy"  # scipy.signal.stft/istft semantics (NumPy engines)
    TORCH = "torch"  # torch.stft/istft semantics (TorchGate engine)


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Static STFT geometry (see ``noisereduce_tpu.config.StftConfig``).

    ``scipy``: frames are ``win_length`` samples long, windowed, then
    zero-padded to ``n_fft`` for the FFT; the signal is extended with
    ``win_length // 2`` zeros on each side; frames are scaled by
    ``1 / window.sum()``. ``torch``: frames are ``n_fft`` samples long with
    the window zero-padded centered to ``n_fft``; ``n_fft // 2`` zeros each
    side; no scaling. The port's STFT implements the scipy convention only.
    """

    n_fft: int = 1024
    win_length: Optional[int] = None
    hop_length: Optional[int] = None
    convention: str = Convention.SCIPY
    quantize_window_f32: bool = False

    def __post_init__(self):
        if self.win_length is None:
            object.__setattr__(self, "win_length", self.n_fft)
        if self.hop_length is None:
            object.__setattr__(self, "hop_length", self.win_length // 4)
        if self.win_length > self.n_fft:
            raise ValueError("win_length must be <= n_fft")
        if self.convention not in (Convention.SCIPY, Convention.TORCH):
            raise ValueError(f"unknown convention {self.convention!r}")

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def frame_length(self) -> int:
        """Samples per extracted frame (pre-FFT)."""
        return self.win_length if self.convention == Convention.SCIPY else self.n_fft

    @property
    def boundary_pad(self) -> int:
        """Zeros added to each side of the signal before framing."""
        return (
            self.win_length // 2
            if self.convention == Convention.SCIPY
            else self.n_fft // 2
        )

    def n_frames(self, n_samples: int) -> int:
        """Number of STFT frames for an ``n_samples``-long signal."""
        extended = n_samples + 2 * self.boundary_pad
        return (extended - self.frame_length) // self.hop_length + 1

    def istft_length(self, n_frames: int) -> int:
        """Output length of the inverse transform for ``n_frames`` frames."""
        if self.convention == Convention.SCIPY:
            full = self.frame_length + (n_frames - 1) * self.hop_length
            return full - 2 * (self.win_length // 2)
        return (n_frames - 1) * self.hop_length


def smoothing_kernel_sizes(
    sr: int,
    n_fft: int,
    hop_length: int,
    freq_mask_smooth_hz: Optional[float],
    time_mask_smooth_ms: Optional[float],
) -> Optional[tuple]:
    """Half-widths (n_grad_freq, n_grad_time) of the triangular mask smoother.

    Mirrors reference spectralgate/base.py:99-128, including its ValueError
    messages. Returns ``None`` when smoothing is disabled (both args None,
    or both sizes degenerate).
    """
    if freq_mask_smooth_hz is None and time_mask_smooth_ms is None:
        return None
    if freq_mask_smooth_hz is None:
        n_grad_freq = 1
    else:
        n_grad_freq = int(freq_mask_smooth_hz / (sr / (n_fft / 2)))
        if n_grad_freq < 1:
            raise ValueError(
                "freq_mask_smooth_hz needs to be at least "
                f"{int(sr / (n_fft / 2))}Hz"
            )
    if time_mask_smooth_ms is None:
        n_grad_time = 1
    else:
        n_grad_time = int(time_mask_smooth_ms / ((hop_length / sr) * 1000))
        if n_grad_time < 1:
            raise ValueError(
                "time_mask_smooth_ms needs to be at least "
                f"{int((hop_length / sr) * 1000)}ms"
            )
    if n_grad_freq == 1 and n_grad_time == 1:
        return None
    return (n_grad_freq, n_grad_time)


def iir_b_coefficient(time_constant_s: float, sr: int, hop_length: int) -> float:
    """First-order IIR coefficient of the non-stationary noise floor
    (reference spectralgate/nonstationary.py:106-114)."""
    t_frames = time_constant_s * sr / float(hop_length)
    return (math.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2)


@dataclasses.dataclass(frozen=True)
class GateConfig:
    """Full static configuration of one spectral-gating pipeline.

    Field names and defaults track the public ``reduce_noise`` signature
    (reference noisereduce/noisereduce.py:13-36).
    """

    sr: int = 44100
    stationary: bool = False
    prop_decrease: float = 1.0
    time_constant_s: float = 2.0
    freq_mask_smooth_hz: Optional[float] = 500
    time_mask_smooth_ms: Optional[float] = 50
    thresh_n_mult_nonstationary: float = 2
    sigmoid_slope_nonstationary: float = 10
    n_std_thresh_stationary: float = 1.5
    n_fft: int = 1024
    win_length: Optional[int] = None
    hop_length: Optional[int] = None
    convention: str = Convention.SCIPY

    def __post_init__(self):
        if self.win_length is None:
            object.__setattr__(self, "win_length", self.n_fft)
        if self.hop_length is None:
            object.__setattr__(self, "hop_length", self.win_length // 4)

    @classmethod
    def from_fields(cls, d: dict) -> "GateConfig":
        """Build from the field dict of a JAX ``GateConfig``
        (``dataclasses.asdict``). Unknown keys raise, so a field added on
        one side only is caught rather than dropped."""
        names = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - names
        if extra:
            raise ValueError(f"unknown GateConfig fields: {sorted(extra)}")
        return cls(**d)

    @property
    def stft(self) -> StftConfig:
        return StftConfig(
            n_fft=self.n_fft,
            win_length=self.win_length,
            hop_length=self.hop_length,
            convention=self.convention,
        )

    @property
    def smoothing(self) -> Optional[tuple]:
        return smoothing_kernel_sizes(
            self.sr,
            self.n_fft,
            self.hop_length,
            self.freq_mask_smooth_hz,
            self.time_mask_smooth_ms,
        )

    @property
    def iir_b(self) -> float:
        return iir_b_coefficient(self.time_constant_s, self.sr, self.hop_length)
