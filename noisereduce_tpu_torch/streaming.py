"""File-to-file streaming and the real-time gate (counterpart of
``noisereduce_tpu/streaming.py``).

``reduce_noise_file`` gates arbitrarily long recordings at constant host
memory: the C++ chunker (``utils/io.py`` over ``native/nrio.cpp``) yields
halo'd chunk views, one chunk at a time goes to the card (as int16 for a
PCM16 source), the gate runs there through its kernels (A, B, C, D; A, E,
C, D for the stationary gate; A, F or E, C, D for the torch convention),
one launch of each a chunk, and the core comes back (as PCM16 when the
output file is PCM16) while the host reads the next chunks from disk.
``StreamingGate`` gates a live stream block by block at a fixed latency.
Chunk geometry and gate math are those of the in-memory path (reference
spectralgate/base.py:130-226), so both equal ``reduce_noise`` with the same
``chunk_size`` and ``padding`` up to float32 rounding order; on the card,
where the kernels compute a view's values the same way in either, they are
bitwise equal (``chip_smoke.py`` checks it at the headline size).

``device`` defaults to ``"cuda"`` and raises where CUDA is absent, as
``reduce_noise`` does; ``device="cpu"`` runs the kernels' plain versions.
``method`` is accepted and unused, and ``mesh`` raises
``NotImplementedError`` (``api.py``).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.api import MESH_LATER, _resolve_device, torch_gate_for
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models.spectral_gate import (
    gate_nonstationary,
    gate_stationary,
    stationary_noise_threshold,
)
from noisereduce_tpu_torch.ops.dsp import EPS_F64
from noisereduce_tpu_torch.ops.stft import _analysis_window_np
from noisereduce_tpu_torch.utils import io as nrio

__all__ = ["reduce_noise_file", "StreamingGate"]


def _noise_threshold(yn: torch.Tensor, cfg: GateConfig) -> torch.Tensor:
    """The stationary threshold of noise rows (channels collapsed to their
    mean, as ``reduce_noise`` collapses them): kernel A and the statistics."""
    with torch.no_grad():
        return stationary_noise_threshold(yn if yn.ndim == 1 else yn.mean(dim=0), cfg)


def _view_gate(cfg: GateConfig, thresh=None, gate=None, xn=None):
    """(channels, view) -> (channels, view): the stationary gate when
    ``thresh`` is given, the torch-convention ``gate`` (its natural-length
    deficit zero filled) when that is, else the non-stationary gate."""
    if gate is not None:
        def run(x):
            out = gate(x, xn)
            return F.pad(out, (0, x.shape[-1] - out.shape[-1]))
    elif thresh is not None:
        def run(x):
            return gate_stationary(x, thresh, cfg)
    else:
        def run(x):
            return gate_nonstationary(x, cfg)
    return run


def _chunk_core(x: torch.Tensor, run, padding: int, chunk_size: int, pcm_out: bool):
    """One streamed chunk on its device: the int16 feed (x * 2^-15, the
    host's float conversion bit for bit), the gate ``run``, the core slice
    (only chunk_size samples go back to the host), and the PCM16 quantize
    when the output file is PCM16 (trunc after the clip, numpy's C cast in
    ``WavWriter.write`` exactly)."""
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * 2.0**-15
    with torch.no_grad():
        core = run(x)[..., padding : padding + chunk_size]
    if pcm_out:
        return torch.trunc(torch.clamp(core * 32767.0, -32768.0, 32767.0)).to(torch.int16)
    return core


_THRESH_SEG_FRAMES = 4096


def _slab_frames_db(slab: torch.Tensor, scfg, n_frames: int) -> torch.Tensor:
    """Raw (unfloored) dB magnitudes of ``n_frames`` STFT frames of a
    zero-extended signal slab (frame j at [j*hop, j*hop + win)): the
    framing, window, DFT and scale of ``ops.stft.stft`` for the scipy
    convention, without its boundary handling (the caller assembles the
    extended slab). Plain torch (``torch.fft.rfft``), as the JAX package
    computes it outside its kernels."""
    frames = slab.unfold(-1, scfg.frame_length, scfg.hop_length)[:n_frames]
    w = _analysis_window_np(scfg)
    frames = frames * torch.as_tensor(w, dtype=slab.dtype, device=slab.device)
    z = torch.fft.rfft(frames, n=scfg.n_fft, dim=-1)
    mag = torch.sqrt(z.real * z.real + z.imag * z.imag) * (1.0 / float(w.sum()))
    return 20.0 * torch.log10(mag + EPS_F64)


def _streaming_noise_threshold(path: str, cfg: GateConfig, dev: torch.device):
    """Stationary per-bin threshold over the WHOLE recording at constant
    host memory (``y_noise=None, clip_noise_stationary=False``: the
    reference's statistics over the entire signal, stationary.py:47-81).

    Two streamed passes over frame-aligned slabs of ``_THRESH_SEG_FRAMES``
    frames of the zero-extended mono mix, their dB spectra on ``dev``: (1)
    the per-bin dB max that anchors amp_to_db's top_db=80 floor, (2) the
    mean and std (ddof 0) of the floored values, summed in float64 on the
    host. Returns (bins,) float32 on ``dev``; it matches the in-memory
    threshold to float32 reduction-order rounding."""
    _, _, n = nrio.wav_info(path)
    scfg = cfg.stft
    win, hop, pad = scfg.frame_length, scfg.hop_length, scfg.boundary_pad
    n_frames = scfg.n_frames(n)
    f_seg = min(_THRESH_SEG_FRAMES, n_frames)
    slab_len = (f_seg - 1) * hop + win

    def slabs():
        for f0 in range(0, n_frames, f_seg):
            f1 = min(f0 + f_seg, n_frames)
            s0 = f0 * hop                     # slab start, extended coordinates
            s1 = (f1 - 1) * hop + win
            y0, y1 = max(0, s0 - pad), min(n, s1 - pad)
            _, seg = nrio.read_wav(path, dtype="float32", start=y0, frames=max(0, y1 - y0))
            mono = seg.mean(axis=1) if seg.ndim == 2 else seg
            slab = np.zeros(slab_len, np.float32)
            left = max(0, pad - s0)
            slab[left : left + mono.shape[0]] = mono
            db = _slab_frames_db(torch.from_numpy(slab).to(dev), scfg, f_seg)
            yield db.cpu().numpy()[: f1 - f0]

    mx = np.full(scfg.n_bins, -np.inf, np.float64)
    for db in slabs():
        mx = np.maximum(mx, db.max(axis=0))
    floor = mx - 80.0
    s1v = np.zeros(scfg.n_bins, np.float64)
    s2v = np.zeros(scfg.n_bins, np.float64)
    for db in slabs():
        db = np.maximum(db.astype(np.float64), floor)
        s1v += db.sum(axis=0)
        s2v += (db * db).sum(axis=0)
    mean = s1v / n_frames
    var = np.maximum(s2v / n_frames - mean * mean, 0.0)
    thresh = mean + np.sqrt(var) * cfg.n_std_thresh_stationary
    return torch.as_tensor(thresh, dtype=torch.float32, device=dev)


class StreamingGate:
    """Real-time stateful spectral gate: feed successive audio blocks, get
    denoised audio back at a fixed, documented latency.

    The offline chunked runtime gates every halo'd chunk view on its own
    (halo recompute, ``parallel.chunking.process_chunked``). A live stream
    can therefore emit block ``i`` as soon as ``padding`` samples of
    lookahead have arrived: the emitted block is the core of the SAME view
    ``[i*B - P, (i+1)*B + P)`` (zero filled before the stream start) that the
    offline path builds, gated on ``device`` (one launch of each kernel a
    block on the card). The concatenated stream output equals
    ``reduce_noise(y, sr, chunk_size=block_size, padding=padding)`` for
    every stream length, short streams included, where :meth:`flush`
    reproduces the offline unchunked ±padding view.

    Algorithmic latency: ``block_size + padding`` samples (``latency_s``):
    a block is emitted when the first ``padding`` samples of the next block
    have arrived.

    Parameters mirror :func:`noisereduce_tpu_torch.reduce_noise`; the
    reference has no streaming API. Stationary self-noise statistics
    (``y_noise=None``) come from the first ``block_size`` samples, the
    offline ``clip_noise_stationary=True`` semantics when ``chunk_size ==
    block_size`` (stationary.py:47-64); pass ``y_noise`` for statistics
    from a separate clip. ``clip_noise_stationary=False`` needs the whole
    signal up front and is refused. ``method`` is accepted and unused.

    >>> gate = StreamingGate(sr=48000, block_size=4800, padding=1024)
    >>> out = []
    >>> for block in capture():          # doctest: +SKIP
    ...     out.append(gate.process(block))
    >>> out.append(gate.flush())
    """

    def __init__(
        self,
        sr: int,
        block_size: int = 4800,
        padding: int = 1024,
        stationary: bool = False,
        y_noise: Optional[np.ndarray] = None,
        prop_decrease: float = 1.0,
        time_constant_s: float = 2.0,
        freq_mask_smooth_hz: Optional[float] = 500,
        time_mask_smooth_ms: Optional[float] = 50,
        thresh_n_mult_nonstationary: float = 2,
        sigmoid_slope_nonstationary: float = 10,
        n_std_thresh_stationary: float = 1.5,
        n_fft: int = 1024,
        win_length: Optional[int] = None,
        hop_length: Optional[int] = None,
        clip_noise_stationary: bool = True,
        method: str = "auto",
        channels: int = 1,
        device="cuda",
    ):
        del method  # the route comes from the STFT geometry
        if block_size <= 0 or padding < 0 or channels < 1:
            raise ValueError("block_size must be > 0, padding >= 0, channels >= 1")
        if stationary and y_noise is None and not clip_noise_stationary:
            raise ValueError(
                "clip_noise_stationary=False computes noise statistics over "
                "the ENTIRE signal, which a live stream cannot see; pass "
                "y_noise or keep clip_noise_stationary=True (statistics "
                "from the first block)"
            )
        self.sr = sr
        self.block_size = int(block_size)
        self.padding = int(padding)
        self.channels = int(channels)
        self._stationary = stationary
        self._device = _resolve_device(device)
        self._cfg = GateConfig(
            sr=sr, stationary=stationary, prop_decrease=prop_decrease,
            time_constant_s=time_constant_s, freq_mask_smooth_hz=freq_mask_smooth_hz,
            time_mask_smooth_ms=time_mask_smooth_ms,
            thresh_n_mult_nonstationary=thresh_n_mult_nonstationary,
            sigmoid_slope_nonstationary=sigmoid_slope_nonstationary,
            n_std_thresh_stationary=n_std_thresh_stationary, n_fft=n_fft,
            win_length=win_length, hop_length=hop_length,
        )
        self._thresh = None
        if stationary and y_noise is not None:
            yn = torch.as_tensor(np.asarray(y_noise, dtype=np.float32)).to(self._device)
            if clip_noise_stationary:
                yn = yn[..., : self.block_size]
            self._thresh = _noise_threshold(yn, self._cfg)
        # host stream state: _buf holds samples from position _buf_pos on;
        # _emitted counts blocks already returned; _flushed latches the end
        self._buf = np.zeros((self.channels, 0), np.float32)
        self._buf_pos = 0  # stream position of _buf[:, 0]
        self._emitted = 0
        self._flushed = False
        self._mono_in = self.channels == 1  # updated at the first process()

    @property
    def latency_samples(self) -> int:
        """Input samples between a sample arriving and its denoised value
        becoming available (worst case over the block): block + lookahead."""
        return self.block_size + self.padding

    @property
    def latency_s(self) -> float:
        return self.latency_samples / self.sr

    def _received(self) -> int:
        return self._buf_pos + self._buf.shape[-1]

    def _ensure_thresh(self):
        """Stationary self-noise: statistics from the first block's mono
        mix (the offline clip_noise_stationary semantics at chunk_size ==
        block_size)."""
        if self._thresh is None and self._stationary:
            # the first emission comes before any buffer trim
            # (_drop_consumed keeps position 0 until block 0 is out), so the
            # stream's head is still resident
            if self._buf_pos != 0:
                raise RuntimeError("StreamingGate: the stream's first block is gone")
            head = torch.from_numpy(self._buf[:, : self.block_size]).to(self._device)
            self._thresh = _noise_threshold(head, self._cfg)

    def _run(self):
        return _view_gate(self._cfg, self._thresh)

    def _view(self, i: int) -> np.ndarray:
        """Halo'd view of block ``i``: stream samples [i*B - P, (i+1)*B + P),
        zero filled outside [0, received): ``extract_chunks``'s view."""
        B, P = self.block_size, self.padding
        s0, s1 = i * B - P, (i + 1) * B + P
        n = self._received()
        view = np.zeros((self.channels, s1 - s0), np.float32)
        lo, hi = max(0, s0), min(n, s1)
        if hi > lo:
            view[:, lo - s0 : hi - s0] = self._buf[:, lo - self._buf_pos : hi - self._buf_pos]
        return view

    def _emit(self, i: int) -> np.ndarray:
        """Gate block ``i``'s view on the device and return its
        (channels, block_size) core."""
        self._ensure_thresh()
        x = torch.from_numpy(self._view(i)).to(self._device)
        return _chunk_core(x, self._run(), self.padding, self.block_size, False).cpu().numpy()

    def _drop_consumed(self):
        """Free buffer samples no future view can read (keep from
        _emitted*B - P on)."""
        keep_from = max(0, self._emitted * self.block_size - self.padding)
        if keep_from > self._buf_pos:
            self._buf = self._buf[:, keep_from - self._buf_pos :]
            self._buf_pos = keep_from

    def process(self, block: np.ndarray) -> np.ndarray:
        """Feed audio; return every block whose lookahead is now complete.

        ``block``: (n,) mono or (channels, n) float samples, any length
        (buffered; emission happens in ``block_size`` units). Returns
        (n_out,) / (channels, n_out) with ``n_out`` a multiple of
        ``block_size`` (possibly 0 while the pipeline fills).
        """
        if self._flushed:
            raise RuntimeError("StreamingGate.process called after flush()")
        x = np.asarray(block, dtype=np.float32)
        mono_in = x.ndim == 1
        self._mono_in = mono_in
        if mono_in:
            x = x[None]
        if x.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channel(s), got {x.shape[0]} "
                "(set channels= in the constructor)"
            )
        self._buf = np.concatenate([self._buf, x], axis=-1)
        B, P = self.block_size, self.padding
        cores = []
        while self._received() >= (self._emitted + 1) * B + P:
            cores.append(self._emit(self._emitted))
            self._emitted += 1
            self._drop_consumed()
        out = (np.concatenate(cores, axis=-1) if cores
               else np.zeros((self.channels, 0), np.float32))
        return out[0] if mono_in else out

    def flush(self) -> np.ndarray:
        """End the stream: emit everything still buffered.

        The tail views are zero filled past the stream's end as the offline
        chunk extractor zero-extends the signal; if the WHOLE stream fit in
        one block, the offline unchunked ±padding view is reproduced
        instead (its IIR floor spans other frames, so the view's length
        matters: ``chunking.process_chunked``). After flush the gate must
        not be fed again.
        """
        mono = self._mono_in
        if self._flushed:
            out = np.zeros((self.channels, 0), np.float32)
            return out[0] if mono else out
        self._flushed = True
        n = self._received()
        B, P = self.block_size, self.padding
        if n == 0:
            out = np.zeros((self.channels, 0), np.float32)
        elif n <= B and self._emitted == 0:
            # the offline unchunked view: n + 2P samples, not a
            # zero-extended full block
            self._ensure_thresh()
            x = F.pad(torch.from_numpy(self._buf).to(self._device), (P, P))
            out = _chunk_core(x, self._run(), P, n, False).cpu().numpy()
        else:
            n_blocks = (n - 1) // B + 1
            cores = []
            for i in range(self._emitted, n_blocks):
                core = self._emit(i)
                if (i + 1) * B > n:  # crop the final partial block
                    core = core[:, : n - i * B]
                cores.append(core)
                self._emitted = i + 1
            out = (np.concatenate(cores, axis=-1) if cores
                   else np.zeros((self.channels, 0), np.float32))
        return out[0] if mono else out

    def warmup(self):
        """Build the kernels and the IO library and launch once before
        real-time use (the first call builds for seconds; later blocks take
        milliseconds): a silent block goes through a throwaway clone, so no
        state is disturbed."""
        nrio.native_available()
        clone = object.__new__(StreamingGate)
        clone.__dict__.update(self.__dict__)
        clone._buf = np.zeros((self.channels, 0), np.float32)
        clone._buf_pos = 0
        clone._emitted = 0
        clone._flushed = False
        if clone._thresh is None and clone._stationary:
            clone._thresh = _noise_threshold(
                torch.zeros(self.block_size, device=self._device), clone._cfg)
        clone._emit(0)
        return self


class _Slot:
    """Host buffers of one chunk in flight (pinned on the card, so both
    copies are asynchronous) and the event recorded after its D2H: neither
    buffer is touched again before that event has completed."""

    def __init__(self, chunk: np.ndarray, out_shape, out_dtype, dev: torch.device):
        pin = dev.type == "cuda"
        self.inp = torch.empty(chunk.shape, dtype=torch.from_numpy(chunk[:, :0]).dtype,
                               pin_memory=pin)
        self.out = torch.empty(out_shape, dtype=out_dtype, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.out.numpy()


# chunks dispatched to the device before the host waits for the oldest
_DEPTH = 2


def _pipeline(chunks, core, out_shape, out_dtype, write, dev: torch.device):
    """Gate streamed chunks with ``_DEPTH`` newer chunks in flight on the
    device: chunk i is copied into its slot's pinned buffer and sent to the
    device without blocking, gated (``core``), and its result copied back
    without blocking; the host waits on chunk i's event only when ``_DEPTH``
    newer chunks have been dispatched, so its disk reads overlap the device.
    Results reach ``write`` in order. ``_DEPTH + 1`` slots serve in turn: a
    slot is reused only after its chunk was waited for and written."""
    slots, in_flight = [], deque()
    for i, (_, chunk) in enumerate(chunks):
        if not slots:
            slots = [_Slot(chunk, out_shape, out_dtype, dev) for _ in range(_DEPTH + 1)]
        slot = slots[i % len(slots)]
        slot.inp.copy_(torch.from_numpy(chunk))
        out = core(slot.inp.to(dev, non_blocking=True))
        slot.out.copy_(out, non_blocking=True)
        if slot.event is not None:
            slot.event.record()
        in_flight.append(slot)
        if len(in_flight) > _DEPTH:
            write(in_flight.popleft().wait())
    while in_flight:
        write(in_flight.popleft().wait())


def reduce_noise_file(
    in_path: str,
    out_path: str,
    stationary: bool = False,
    y_noise: Optional[np.ndarray] = None,
    prop_decrease: float = 1.0,
    time_constant_s: float = 2.0,
    freq_mask_smooth_hz: Optional[float] = 500,
    time_mask_smooth_ms: Optional[float] = 50,
    thresh_n_mult_nonstationary: float = 2,
    sigmoid_slope_nonstationary: float = 10,
    n_std_thresh_stationary: float = 1.5,
    chunk_size: int = 600000,
    padding: int = 30000,
    n_fft: int = 1024,
    win_length: Optional[int] = None,
    hop_length: Optional[int] = None,
    clip_noise_stationary: bool = True,
    method: str = "auto",
    as_float: bool = False,
    use_tqdm: bool = False,
    use_torch: bool = False,
    mesh=None,
    device="cuda",
) -> int:
    """Denoise a WAV file into another WAV file, streaming chunk by chunk.

    Returns the number of frames written. The output is PCM16 unless
    ``as_float``. Stationary self-noise statistics (``y_noise=None``) come
    from the first ``chunk_size`` samples of the mono mix when
    ``clip_noise_stationary`` (the samples the in-memory path uses,
    stationary.py:47-64), or from the WHOLE recording when not, in two
    constant-memory passes over the file. ``use_torch`` selects the
    torch-convention gate (``TPUGate``), as ``reduce_noise(use_torch=True)``
    does, its noise clip cut along its first axis when longer than the
    signal (streamed_torch_gate.py:57-58). ``use_tqdm`` shows a ``tqdm`` bar
    over the chunks. ``method`` is accepted and unused; ``mesh`` other than
    None raises ``NotImplementedError``. ``device`` as ``reduce_noise``'s:
    ``"cuda"`` by default, raising where CUDA is absent.

    Each chunk is one launch of each of the gate's kernels on the card;
    up to three chunks are in flight (``_pipeline``), so host memory stays
    at a few chunks whatever the file's length.
    """
    del method  # the route comes from the STFT geometry
    if mesh is not None:
        raise NotImplementedError(MESH_LATER)
    dev = _resolve_device(device)
    sr, channels, n_frames_in = nrio.wav_info(in_path)
    gate_kw = dict(
        stationary=stationary, prop_decrease=prop_decrease, time_constant_s=time_constant_s,
        freq_mask_smooth_hz=freq_mask_smooth_hz, time_mask_smooth_ms=time_mask_smooth_ms,
        thresh_n_mult_nonstationary=thresh_n_mult_nonstationary,
        sigmoid_slope_nonstationary=sigmoid_slope_nonstationary,
        n_std_thresh_stationary=n_std_thresh_stationary, n_fft=n_fft,
        win_length=win_length, hop_length=hop_length,
    )
    cfg = GateConfig(sr=sr, **gate_kw)

    if use_torch:
        gate = torch_gate_for(sr, **gate_kw)
        xn = None
        if y_noise is not None:
            yn = np.asarray(y_noise, dtype=np.float32)
            if yn.shape[-1] > n_frames_in and clip_noise_stationary:
                yn = yn[:n_frames_in]  # the reference's first-axis cut
            xn = torch.as_tensor(yn if yn.ndim == 2 else yn[None]).to(dev)
        run = _view_gate(cfg, gate=gate, xn=xn)
    elif stationary:
        if y_noise is not None:
            yn = torch.as_tensor(np.asarray(y_noise, dtype=np.float32)).to(dev)
            if clip_noise_stationary:
                yn = yn[..., :chunk_size]
            thresh = _noise_threshold(yn, cfg)
        elif clip_noise_stationary:
            _, head = nrio.read_wav(in_path, dtype="float32", frames=chunk_size)
            thresh = _noise_threshold(torch.from_numpy(head.T.copy()).to(dev), cfg)
        else:
            # statistics over the ENTIRE signal (stationary.py:47-64 with
            # clip_noise_stationary=False), in two constant-memory passes
            thresh = _streaming_noise_threshold(in_path, cfg, dev)
        run = _view_gate(cfg, thresh=thresh)
    else:
        run = _view_gate(cfg)

    with nrio.WavWriter(out_path, sr, channels, n_frames_in, as_float=as_float) as writer:
        if n_frames_in <= chunk_size:
            # reduce_noise's unchunked path exactly: the gated view is
            # n + 2*padding samples, NOT a zero-extended full chunk (the
            # non-stationary IIR floor is global over frames)
            _, data = nrio.read_wav(in_path, dtype="float32")
            y2d = data.T if data.ndim == 2 else data[None]
            x = F.pad(torch.from_numpy(np.ascontiguousarray(y2d)).to(dev), (padding, padding))
            writer.write(_chunk_core(x, run, padding, n_frames_in, False).cpu().numpy().T)
            return n_frames_in

        # PCM16 sources stream as raw int16 (half the H2D bytes; converted
        # on the device bit for bit); other formats yield float32
        chunks = nrio.stream_chunks(in_path, chunk_size, padding, dtype="int16")
        if use_tqdm:
            from tqdm.auto import tqdm

            chunks = tqdm(chunks, total=(n_frames_in - 1) // chunk_size + 1)
        pcm_out = not as_float
        _pipeline(
            chunks, lambda x: _chunk_core(x, run, padding, chunk_size, pcm_out),
            (channels, chunk_size), torch.int16 if pcm_out else torch.float32,
            lambda core: writer.write(core.T), dev,
        )
    return n_frames_in
