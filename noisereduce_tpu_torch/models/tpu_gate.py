"""TPUGate as a ``torch.nn.Module``: the torch-convention spectral gate
(counterpart of ``noisereduce_tpu/models/tpu_gate.py``; the reference's
``TorchGate``, torchgate/torchgate.py:7-264).

``forward`` runs the kernels A, F or E, C and D
(``ops.cuda.torch_dispatch``; on the CPU their plain versions) wherever
they serve the STFT geometry; for a hop that does not divide n_fft, the
plain STFT and iSTFT around F or E and C (``staged_tpugate``); for a card
tensor of a dtype the kernels do not take (float64), the staged twin
``_call_staged``, the counterpart of ``TPUGate._call_jnp`` (``:243``) and
the numerical oracle of both: it smooths with every SVD rank of the
float32-rounded smoothing kernel, where the kernels take rank 1 (the rest is
~1e-8 of it), and like the reference it gives NaN on silence (a 0/0
moving-average ratio) where the kernels give finite zeros.

Torch-path quirks kept: ``amp_to_db`` with top_db 40, noise statistics with
ddof 1, the moving-average floor, ``temperature_sigmoid``, the prop_decrease
blend BEFORE the smoothing (torchgate.py:241-249), and torch.istft's natural
output length (T-1)*hop.

A bfloat16 input (the bf16 mode) returns bfloat16: the kernels read and
write bf16 planes; ``_call_staged`` keeps the spectrogram in bfloat16 and
makes the mask decisions in float32 (``tpu_gate.py:263-265``).

The module is differentiable with respect to ``x`` and ``xn``, on the card
and on the CPU, in ``forward``, ``batched_chunks`` and ``chunked``: the
value under grad is the kernels' output, bitwise the serving value, and the
cotangent comes from ``_call_staged`` (the contract of the JAX package's
``_fused_tpugate_cvjp1/2``; ``ops/cuda/torch_dispatch.py``). The backward
pass launches no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.config import Convention, StftConfig, smoothing_kernel_sizes
from noisereduce_tpu_torch.ops.cuda.torch_dispatch import (
    fused_tpugate,
    fused_tpugate_chunked,
    fused_tpugate_supported,
    staged_tpugate,
)
from noisereduce_tpu_torch.ops.dsp import (
    amp_to_db,
    moving_average_same,
    smooth_mask_2d_torchgate,
    temperature_sigmoid,
    to_mask_dtype,
)
from noisereduce_tpu_torch.ops.stft import istft, stft
from noisereduce_tpu_torch.parallel.chunking import process_chunked

__all__ = ["TPUGate", "stationary_mask_torch", "nonstationary_mask_torch"]


def stationary_mask_torch(X_db, XN_db, n_std_thresh: float, time_axis: int = -1):
    """Binary mask X_db > per-(batch, freq) noise threshold, the statistics
    over ``time_axis`` with ddof 1 (torchgate.py:126-165;
    ``tpu_gate.py:41``). ``XN_db`` None: the signal's own statistics."""
    ref_db = X_db if XN_db is None else XN_db
    mean = ref_db.mean(dim=time_axis)
    n = ref_db.shape[time_axis]
    var = ref_db.var(dim=time_axis, correction=0) * (n / (n - 1))
    thresh = (mean + torch.sqrt(var) * n_std_thresh).unsqueeze(time_axis)
    return (X_db > thresh).to(X_db.dtype)


def nonstationary_mask_torch(X_abs, n_movemean: int, n_thresh: float,
                             temp_coeff: float, time_axis: int = -1):
    """Moving-average noise floor and temperature sigmoid
    (torchgate.py:167-198; ``tpu_gate.py:60``)."""
    X_smoothed = moving_average_same(X_abs, n_movemean, axis=time_axis)
    ratio = (X_abs - X_smoothed) / X_smoothed
    return temperature_sigmoid(ratio, n_thresh, temp_coeff)


_FIELDS = (
    "sr", "nonstationary", "n_std_thresh_stationary", "n_thresh_nonstationary",
    "temp_coeff_nonstationary", "n_movemean_nonstationary", "prop_decrease",
    "n_fft", "win_length", "hop_length", "freq_mask_smooth_hz",
    "time_mask_smooth_ms",
)


class TPUGate(torch.nn.Module):
    """Spectral gate with torch.stft conventions; the reference TorchGate's
    constructor surface (torchgate.py:32-46). Call with ``x`` of shape
    (batch, signal_length) and an optional noise clip ``xn`` of shape
    (signal_length,) or (batch_n, signal_length), batch_n 1 or batch. The
    module has no parameters: the fields below are its whole state."""

    def __init__(
        self,
        sr: int,
        nonstationary: bool = False,
        n_std_thresh_stationary: float = 1.5,
        n_thresh_nonstationary: float = 1.3,
        temp_coeff_nonstationary: float = 0.1,
        n_movemean_nonstationary: int = 20,
        prop_decrease: float = 1.0,
        n_fft: int = 1024,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        freq_mask_smooth_hz: Optional[float] = 500,
        time_mask_smooth_ms: Optional[float] = 50,
    ):
        super().__init__()
        if not (0.0 <= prop_decrease <= 1.0):
            raise ValueError("prop_decrease must be in [0, 1]")
        if n_movemean_nonstationary < 1:
            raise ValueError("n_movemean_nonstationary must be at least 1")
        self.sr = sr
        self.nonstationary = nonstationary
        self.n_std_thresh_stationary = n_std_thresh_stationary
        self.n_thresh_nonstationary = n_thresh_nonstationary
        self.temp_coeff_nonstationary = temp_coeff_nonstationary
        self.n_movemean_nonstationary = n_movemean_nonstationary
        self.prop_decrease = prop_decrease
        self.n_fft = n_fft
        self.win_length = n_fft if win_length is None else win_length
        self.hop_length = self.win_length // 4 if hop_length is None else hop_length
        self.freq_mask_smooth_hz = freq_mask_smooth_hz
        self.time_mask_smooth_ms = time_mask_smooth_ms
        # validate the smoothing geometry eagerly, like the reference
        self.smoothing

    @classmethod
    def from_fields(cls, d: dict) -> "TPUGate":
        """Build from the field dict of a JAX ``TPUGate``
        (``dataclasses.asdict``). Unknown keys raise, so a field added on
        one side only is caught rather than dropped."""
        extra = set(d) - set(_FIELDS)
        if extra:
            raise ValueError(f"unknown TPUGate fields: {sorted(extra)}")
        return cls(**d)

    def fields(self) -> dict:
        """The constructor's fields, as ``dataclasses.asdict`` gives a JAX
        ``TPUGate``'s."""
        return {name: getattr(self, name) for name in _FIELDS}

    @property
    def stft_config(self) -> StftConfig:
        return StftConfig(
            n_fft=self.n_fft,
            win_length=self.win_length,
            hop_length=self.hop_length,
            convention=Convention.TORCH,
            quantize_window_f32=True,  # torch.hann_window's default float32
        )

    @property
    def smoothing(self):
        return smoothing_kernel_sizes(
            self.sr, self.n_fft, self.hop_length, self.freq_mask_smooth_hz,
            self.time_mask_smooth_ms,
        )

    def _check(self, x, xn, batch: int, length=None) -> None:
        """The reference's argument errors; ``length``: the samples each
        call of the gate sees (default: x's last axis)."""
        if (x.shape[-1] if length is None else length) < self.win_length * 2:
            raise ValueError(f"x must be bigger than {self.win_length * 2}")
        if xn is not None:
            if xn.ndim not in (1, 2):
                raise ValueError("xn must be 1-D or 2-D")
            if xn.shape[-1] < self.win_length * 2:
                raise ValueError(f"xn must be bigger than {self.win_length * 2}")
            bn = xn.shape[0] if xn.ndim == 2 else 1
            if bn not in (1, batch):
                raise ValueError(
                    f"the noise clip's batch {bn} must be 1 or the signal's {batch}"
                )

    def forward(self, x: torch.Tensor, xn: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoise (batch, signal_length) -> (batch, (T-1)*hop), torch.istft's
        natural length (torchgate.py:200-264)."""
        if x.ndim != 2:
            raise ValueError("x must have shape (batch, signal_length)")
        self._check(x, xn, x.shape[0])
        if fused_tpugate_supported(self, x):
            return fused_tpugate(x, xn, self)
        return staged_tpugate(x, xn, self)

    def batched_chunks(self, chunks: torch.Tensor, xn: Optional[torch.Tensor] = None):
        """The gate over (channels, n_chunks, view) halo'd chunks, each
        chunk's natural-length deficit zero filled back to ``view``
        (``tpu_gate.py:183``). The chunk axis flattens into the batch axis,
        one launch each for every chunk, with a (channels, n_clip) noise
        clip mapped channel-major onto the flattened rows."""
        ch, k, view = chunks.shape
        self._check(chunks, xn, ch)
        flat = chunks.reshape(ch * k, view).contiguous()
        if fused_tpugate_supported(self, flat):
            return fused_tpugate(flat, xn, self, out_len=view).reshape(ch, k, view)
        out = staged_tpugate(flat, xn, self)
        return F.pad(out, (0, view - out.shape[-1])).reshape(ch, k, view)

    def chunked(self, y2d: torch.Tensor, chunk_size: int, padding: int,
                xn: Optional[torch.Tensor] = None, max_parallel_chunks: int = 0,
                progress: bool = False, mesh=None, axis_name: str = "chunks") -> torch.Tensor:
        """The reference's chunked body over (channels, n) (base.py:144-226):
        halo'd chunk views gated and their cores assembled, a signal of at
        most ``chunk_size`` samples padded by ``padding`` zeros each side
        and gated whole (``api.py::_run_torch_gate``, ``:163``). Through the
        kernels the views are read straight from the signal and only the
        cores written. ``max_parallel_chunks`` > 0 or ``progress``: the
        chunks in groups of that many (1 for 0), one call of the gate a
        group, under a ``tqdm`` bar with ``progress``
        (``parallel.chunking.chunk_groups``). ``mesh`` (a
        ``parallel.mesh.ChunkMesh``): the chunks sharded over its devices,
        the noise clip's statistics copied to each, the output on
        ``y2d``'s device (``parallel.chunking.shard_cores``). (ch, n) ->
        (ch, n). ``reduce_noise`` also passes its host signal on its way to
        the card (``parallel.transfer``), which the fused path gates in
        pieces and the other paths take whole."""
        ch, n = y2d.shape
        if fused_tpugate_supported(self, y2d, None if mesh is None else mesh.devices[0]):
            self._check(y2d, xn, ch, min(chunk_size, n) + 2 * padding)
            return fused_tpugate_chunked(y2d, self, chunk_size, padding, xn,
                                         max_parallel_chunks, progress, mesh, axis_name)

        def call(c, noise):
            if c.ndim == 3:  # (channels, n_chunks, view)
                return self.batched_chunks(c, noise)
            out = staged_tpugate(c, noise, self)
            return F.pad(out, (0, c.shape[-1] - out.shape[-1]))

        return process_chunked(call, y2d, chunk_size, padding, max_parallel_chunks, progress,
                               mesh, axis_name, (xn,))

    def _call_staged(self, x: torch.Tensor, xn: Optional[torch.Tensor] = None):
        """Staged pipeline in plain torch (``_call_jnp``, ``tpu_gate.py:243``),
        time-major (batch, frames, bins): the oracle of the kernels and the
        twin whose cotangent the gate's backward pass takes."""
        scfg = self.stft_config
        re, im = stft(x, scfg)
        # bf16: the spectrogram stays bf16, the decisions run in float32
        r, i = to_mask_dtype(re, im)
        mag = torch.sqrt(r * r + i * i)
        if self.nonstationary:
            mask = nonstationary_mask_torch(
                mag, self.n_movemean_nonstationary, self.n_thresh_nonstationary,
                self.temp_coeff_nonstationary, time_axis=-2,
            )
        else:
            XN_db = None
            if xn is not None:
                rn, in_ = to_mask_dtype(*stft(xn if xn.ndim == 2 else xn[None], scfg))
                XN_db = amp_to_db(torch.sqrt(rn * rn + in_ * in_), top_db=40.0, axis=-2)
            mask = stationary_mask_torch(
                amp_to_db(mag, top_db=40.0, axis=-2), XN_db,
                self.n_std_thresh_stationary, time_axis=-2,
            )
        # prop_decrease blend BEFORE smoothing (torch-path order)
        mask = self.prop_decrease * (mask - 1.0) + 1.0
        if self.smoothing is not None:
            mask = smooth_mask_2d_torchgate(mask, *self.smoothing, time_major=True)
        mask = mask.to(re.dtype)
        return istft((re * mask, im * mask), scfg)

