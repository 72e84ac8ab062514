"""Public API: ``reduce_noise``, signature-compatible with the reference
(noisereduce/noisereduce.py:13-185), with all three engines (the
scipy-convention ones, stationary and non-stationary, and the
torch-convention gate of ``use_torch=True``), and ``reduce_noise_batch``
(counterpart of ``noisereduce_tpu/api.py``).

- ``device`` defaults to ``"cuda"``, as the reference's torch path does.
  Where CUDA is absent, ``device="cuda"`` raises; it does not fall back to
  the CPU. ``device="cpu"`` runs the kernels' plain versions (the parity
  mode).
- ``compute_dtype`` defaults to ``torch.float32``. ``torch.bfloat16`` is
  the opt-in fast mode of the JAX package: the signal, the spectrogram
  planes and the output are bfloat16, the mask decisions and the
  stationary threshold float32, on the card through the kernels' bfloat16
  builds (A reads the bf16 signal and stores bf16 planes, B, E or F read
  them, D stores a bf16 output); the result has the input's dtype, within
  ~1.2e-2 rms of the float32 result non-stationary and ~1e-1 stationary,
  where a ``UserWarning`` says so (``tests/test_torch_bf16.py``).
  ``torch.float64`` runs the kernels' plain versions on the CPU and the
  staged twins on the card (no kernel launches).
- The JAX signature's tail is taken: ``method`` (accepted and unused: the
  kernels' route comes from the STFT geometry, ``geometry.fft_route``),
  ``mesh`` (a ``parallel.mesh.ChunkMesh``, e.g. ``chunk_mesh()`` over the
  host's cards: each device gates a contiguous range of the chunks from
  its own slice of the signal, the stationary threshold computed once on
  the first device and copied to the others, each device's cores copied
  into their own columns of the one pinned host output; the mesh's devices
  take the place of ``device``, and a signal of at most ``chunk_size``
  samples runs unsharded on the first one) and ``max_parallel_chunks`` (0:
  every chunk in one launch of each kernel; g > 0: host-driven groups of g
  chunks, so only one group's planes are on the card at a time, per device
  under a mesh). ``use_tqdm=True`` shows a ``tqdm`` bar over those groups
  (g = 1 when ``max_parallel_chunks`` is 0) for a signal longer than
  ``chunk_size``, as the JAX package's ``_run_chunked_with_progress`` does
  (no bar with a mesh, as there); it needs ``tqdm`` installed. Neither
  grouping nor a mesh changes the output.
- Another ``compute_dtype`` (float16) raises ``NotImplementedError``.
  ``tmp_folder`` and ``n_jobs`` are accepted for compatibility (chunk
  fan-out is the kernels' batch axis, not a process pool), except that
  ``use_torch=True`` with ``n_jobs != 1`` raises the reference's
  ``ValueError``.
"""
from __future__ import annotations

import inspect
import numbers
import warnings

import numpy as np
import torch

from noisereduce_tpu_torch.config import Convention, GateConfig, smoothing_kernel_sizes
from noisereduce_tpu_torch.models.tpu_gate import TPUGate
from noisereduce_tpu_torch.models.spectral_gate import (
    gate_nonstationary,
    gate_stationary,
    stationary_noise_threshold,
)
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_chunked,
    fused_gate_supported,
)
from noisereduce_tpu_torch.parallel.chunking import n_chunks_for, process_chunked
from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

__all__ = ["reduce_noise", "reduce_noise_batch"]

COMPUTE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


class _Rows(list):
    """``reduce_noise_batch``'s equal-length 1-D rows of one group, or one
    noise row for each of them: a private type, so that a list a user
    passes as ``y`` or ``y_noise`` goes through ``np.asarray`` as the JAX
    package takes it (``api.py:458``)."""


def _chunk_group(padding, max_parallel_chunks, n_samples: int, chunk_size: int) -> int:
    """The chunks a host-driven group takes (0: all of them in one launch),
    after refusing, before any launch, what the JAX package refuses: a
    negative ``padding`` (its ``ValueError``, whatever the signal's
    length), and a ``max_parallel_chunks`` that cannot count groups of
    chunks where it groups them: a signal longer than a chunk, with more
    chunks than a positive value (``TypeError``, as JAX raises for -1 and
    1.5; at -2 and below it raises ``ValueError``). Where the JAX package
    does not group (one chunk, or no more chunks than the value), neither
    does the port."""
    if padding < 0:
        raise ValueError(f"padding must be >= 0, got {padding}")
    g = max_parallel_chunks
    if isinstance(g, numbers.Integral) and g > 0:
        return int(g)
    if not g or n_samples <= chunk_size:
        return 0
    if isinstance(g, numbers.Real) and g >= n_chunks_for(n_samples, chunk_size):
        return 0
    raise TypeError(
        "max_parallel_chunks must be None or an int >= 0 (0: every chunk in one "
        f"launch), got {g!r}")


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, ChunkMesh):
        raise TypeError(
            "mesh must be None or a noisereduce_tpu_torch.parallel.mesh.ChunkMesh "
            f"(e.g. chunk_mesh()), got {type(mesh).__name__}"
        )


def _fused_chunked_ok(cfg: GateConfig, y2d: torch.Tensor, chunk_size: int, mesh=None) -> bool:
    """Whole-body fused chunked path (views read straight from the signal)
    for signals longer than one chunk; shorter ones keep their exact
    unchunked view geometry (``api.py:50``)."""
    return y2d.shape[-1] > chunk_size and fused_gate_supported(
        cfg, y2d, None if mesh is None else mesh.devices[0])


def _run_stationary(y2d, y_noise_mono, cfg, chunk_size, padding, group=0, progress=False,
                    mesh=None):
    """Threshold from the noise rows, once, then the gate (``api.py:100``),
    over groups of ``group`` chunks or sharded over ``mesh``
    (``process_chunked``), the threshold copied to each device."""
    thresh = stationary_noise_threshold(y_noise_mono, cfg)
    if _fused_chunked_ok(cfg, y2d, chunk_size, mesh):
        return fused_gate_chunked(y2d, cfg, chunk_size, padding, thresh, group, progress, mesh)
    return process_chunked(
        lambda c, t: gate_stationary(c, t, cfg), y2d, chunk_size, padding, group, progress,
        mesh, extra=(thresh,),
    )


def _run_nonstationary(y2d, cfg, chunk_size, padding, group=0, progress=False, mesh=None):
    if _fused_chunked_ok(cfg, y2d, chunk_size, mesh):
        return fused_gate_chunked(y2d, cfg, chunk_size, padding, None, group, progress, mesh)
    return process_chunked(
        lambda c: gate_nonstationary(c, cfg), y2d, chunk_size, padding, group, progress, mesh
    )


def _hop(n_fft, win_length, hop_length) -> int:
    """The STFT's hop, by its defaults: win = n_fft, hop = win // 4."""
    win = n_fft if win_length is None else win_length
    return win // 4 if hop_length is None else hop_length


def torch_gate_for(
    sr,
    stationary=False,
    prop_decrease=1.0,
    time_constant_s=2.0,
    freq_mask_smooth_hz=500,
    time_mask_smooth_ms=50,
    thresh_n_mult_nonstationary=2,
    sigmoid_slope_nonstationary=10,
    n_std_thresh_stationary=1.5,
    n_fft=1024,
    win_length=None,
    hop_length=None,
) -> TPUGate:
    """The TorchGate that ``reduce_noise(y, sr, use_torch=True, ...)`` runs
    with these arguments (the same names and defaults), as the
    StreamedTorchGate builds it (streamed_torch_gate.py:12-87;
    ``api.py::_reduce_noise_torch_path``, ``:634``): temp_coeff = 1/slope,
    n_movemean = time_constant * sr / hop."""
    hop = _hop(n_fft, win_length, hop_length)
    return TPUGate(
        sr=sr,
        nonstationary=not stationary,
        n_std_thresh_stationary=n_std_thresh_stationary,
        n_thresh_nonstationary=thresh_n_mult_nonstationary,
        temp_coeff_nonstationary=1 / sigmoid_slope_nonstationary,
        n_movemean_nonstationary=int(time_constant_s / hop * sr),
        prop_decrease=prop_decrease,
        n_fft=n_fft,
        win_length=win_length,
        hop_length=hop_length,
        freq_mask_smooth_hz=freq_mask_smooth_hz,
        time_mask_smooth_ms=time_mask_smooth_ms,
    )


def _reduce_noise_torch_path(y2d, gate, y_noise, chunk_size, padding, clip_noise_stationary,
                             group=0, progress=False, mesh=None):
    """The StreamedTorchGate engine: ``gate`` over halo'd chunks. The noise
    clip stays multichannel and, longer than the signal, is cut along its
    FIRST axis (the reference's quirk, streamed_torch_gate.py:57-58:
    samples for a 1-D clip, channels for a 2-D one). ``y_noise`` may also be
    ``_Rows`` of equal-length 1-D rows (``reduce_noise_batch``'s per-signal
    clips). With ``mesh`` the clip goes to its first device, where the
    statistics run."""
    yn = None
    if y_noise is not None:
        yn = y_noise if isinstance(y_noise, _Rows) else np.asarray(y_noise)
        n_clip = yn[0].shape[-1] if isinstance(yn, _Rows) else yn.shape[-1]
        if n_clip > y2d.shape[-1] and clip_noise_stationary:
            yn = yn[: y2d.shape[-1]]
        yn = _to_tensor(yn, y2d.device if mesh is None else mesh.devices[0], y2d.dtype)
    return gate.chunked(y2d, chunk_size, padding, yn, group, progress, mesh)


def _as_2d(y: np.ndarray):
    """Reference input normalization (base.py:52-62): 1-D -> (1, n) plus a
    flat flag; more than 2-D is rejected."""
    if y.ndim == 1:
        return y[None, :], True
    if y.ndim > 2:
        raise ValueError("Waveform must be in shape (# frames, # channels)")
    return y, False


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass device='cpu' "
            "to run the plain versions"
        )
    return dev


def _finalize_reduce_output(out: torch.Tensor, out_dtype, flat: bool) -> np.ndarray:
    """Host array with the input's dtype and shape restored (``api.py:623``).

    A card's output lands in pinned host memory, which the returned array
    keeps: a pageable D2H, or a second host copy, each cost more than the
    kernels together at the headline size (PERF.md, section 6). A bfloat16
    output (numpy has no such type) is widened to float32 first, where it
    is."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    if out.device.type != "cpu":
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out)
        out = host
    arr = out.numpy().astype(out_dtype, copy=False)
    return arr.reshape(-1) if flat else arr


def reduce_noise(
    y,
    sr,
    stationary=False,
    y_noise=None,
    prop_decrease=1.0,
    time_constant_s=2.0,
    freq_mask_smooth_hz=500,
    time_mask_smooth_ms=50,
    thresh_n_mult_nonstationary=2,
    sigmoid_slope_nonstationary=10,
    n_std_thresh_stationary=1.5,
    tmp_folder=None,
    chunk_size=600000,
    padding=30000,
    n_fft=1024,
    win_length=None,
    hop_length=None,
    clip_noise_stationary=True,
    use_tqdm=False,
    n_jobs=1,
    use_torch=False,
    device="cuda",
    compute_dtype=None,
    method="auto",
    mesh=None,
    max_parallel_chunks=0,
):
    """Reduce noise by spectral gating (reference noisereduce.py:13-185).

    Parameters
    ----------
    y : np.ndarray [(frames,) or (channels, frames)], real-valued
    sr : int, sample rate
    stationary : stationary (a fixed per-bin threshold from noise
        statistics) or non-stationary (a time-varying threshold from an
        IIR-smoothed floor) gating; default False
    y_noise : noise clip for the stationary statistics, (frames,) or
        (channels, frames), collapsed to mono; defaults to the signal itself
    prop_decrease : proportion to reduce the noise by (1.0 = 100%)
    time_constant_s : time constant of the noise-floor IIR, seconds
    freq_mask_smooth_hz, time_mask_smooth_ms : triangular mask-smoothing
        widths (None disables that axis)
    thresh_n_mult_nonstationary, sigmoid_slope_nonstationary : threshold
        multiple and sigmoid slope of the non-stationary mask
    n_std_thresh_stationary : stationary threshold = mean + this many std
        of the noise dB spectrogram
    chunk_size, padding : long recordings are gated as halo'd chunks; a
        negative padding raises ``ValueError``
    n_fft, win_length, hop_length : STFT geometry (win defaults to n_fft,
        hop to win // 4)
    clip_noise_stationary : clip the noise clip to chunk_size samples
    device : torch device to run on (default "cuda"; raises if absent)
    compute_dtype : torch.float32 (default), torch.bfloat16 (the fast mode:
        bf16 signal, planes and output, the mask decisions in float32;
        stationary=True warns, its binary mask flips near-threshold bins)
        or torch.float64 (on the card through the staged twins, launching
        no kernel)
    use_torch : the TorchGate engine (torch STFT conventions, a
        moving-average floor and temperature sigmoid, or noise statistics
        with top_db 40 and ddof 1; chunked, the noise clip cut to the
        signal's length); needs ``n_jobs=1``
    tmp_folder, n_jobs : accepted for reference compatibility
    method : accepted for the JAX signature ("auto", "fft", "matmul", ...);
        the kernels' route comes from the STFT geometry alone
    mesh : None, or a ``parallel.mesh.ChunkMesh`` (``chunk_mesh()``: the
        host's cards) whose devices take the place of ``device``: the
        chunks of a signal longer than ``chunk_size`` are sharded over them
        in contiguous ranges, each device gating its own from its own slice
        of the signal, bitwise the unsharded output; anything else raises
        ``TypeError``
    max_parallel_chunks : 0 gates every chunk in one launch of each kernel;
        g > 0 gates a signal of more than g chunks in host-driven groups of
        g chunks, one group's planes on the card at a time (bounded device
        memory; per device with a mesh), the cores assembled on the card;
        the output is the same. Another value (negative, fractional) raises
        ``TypeError`` where the signal has more chunks than it, as the JAX
        package does
    use_tqdm : a ``tqdm`` progress bar over the chunk groups (g = 1 when
        ``max_parallel_chunks`` is 0), for a signal longer than
        ``chunk_size`` and no mesh; needs ``tqdm`` installed

    Returns a NumPy array with the input's shape and dtype.
    """
    del tmp_folder
    out, meta = _reduce_noise_deferred(
        y, sr, stationary, y_noise, prop_decrease, time_constant_s,
        freq_mask_smooth_hz, time_mask_smooth_ms, thresh_n_mult_nonstationary,
        sigmoid_slope_nonstationary, n_std_thresh_stationary, chunk_size,
        padding, n_fft, win_length, hop_length, clip_noise_stationary,
        use_tqdm, n_jobs, use_torch, device, compute_dtype, method, mesh,
        max_parallel_chunks,
    )
    return _finalize_reduce_output(out, *meta)


def _reduce_noise_deferred(
    y, sr, stationary, y_noise, prop_decrease, time_constant_s,
    freq_mask_smooth_hz, time_mask_smooth_ms, thresh_n_mult_nonstationary,
    sigmoid_slope_nonstationary, n_std_thresh_stationary, chunk_size, padding,
    n_fft, win_length, hop_length, clip_noise_stationary, use_tqdm, n_jobs,
    use_torch, device, compute_dtype, method="auto", mesh=None, max_parallel_chunks=0,
    _noise_rows=None,
):
    """``reduce_noise``'s body, returning the output tensor (its kernels
    queued on the card, not waited for) and what ``_finalize_reduce_output``
    needs, so that ``reduce_noise_batch`` can queue every group before the
    first D2H.

    ``y`` may be ``_Rows`` of B equal-length 1-D rows (a batch group); a
    user's list is an array, as ``np.asarray`` reads it.
    ``_noise_rows``: B noise rows (a list of equal-length 1-D arrays) of a
    stationary batch of B mono signals riding the channel axis, or
    ``"self"`` for the signal rows themselves; each row's threshold comes from its own noise row (no mono
    collapse), and the gate reads them as one (B, bins) threshold
    (``api.py:438-442``). With ``use_torch``, ``y_noise`` may be ``_Rows``
    of B equal-length 1-D noise rows, one per signal row."""
    del method  # the route comes from the STFT geometry (geometry.fft_route)
    if use_torch and n_jobs != 1:
        raise ValueError("n_jobs must be 1 when using torch version of spectral gating.")
    _check_mesh(mesh)
    # validate the smoothing geometry eagerly, like the reference
    # constructors (spectralgate/base.py:99-128): same ValueErrors
    hop = _hop(n_fft, win_length, hop_length)
    smoothing_kernel_sizes(sr, n_fft, hop, freq_mask_smooth_hz, time_mask_smooth_ms)

    cdtype = torch.float32 if compute_dtype is None else compute_dtype
    if cdtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={cdtype}: float32, float64 and bfloat16 only")
    if stationary and cdtype == torch.bfloat16:
        # bf16 spectra flip the binary mask's threshold-adjacent bins
        # (tests/test_torch_bf16.py); the JAX package's words, api.py:472-484
        warnings.warn(
            "compute_dtype=bfloat16 with stationary=True: the binary threshold mask "
            "amplifies bf16 rounding (pinned envelope ~1.5e-1 of peak vs f32). Use "
            "float32, or stationary=False for bf16 fast mode.",
            stacklevel=3,
        )
    # with a mesh the signal stays on the host, each device receiving its
    # own slice, and the noise statistics run on the first device
    dev = _resolve_device(device) if mesh is None else mesh.devices[0]

    if isinstance(y, _Rows):  # reduce_noise_batch's rows of one group
        out_dtype, flat, n_samples = y[0].dtype, False, y[0].shape[-1]
    else:
        y = np.asarray(y)
        out_dtype = y.dtype
        y, flat = _as_2d(y)
        n_samples = y.shape[-1]
    group = _chunk_group(padding, max_parallel_chunks, n_samples, chunk_size)
    y2d = _to_tensor(y, dev if mesh is None else torch.device("cpu"), cdtype)
    # the host-driven group loop under a bar, for a signal longer than a
    # chunk (api.py:517), one chunk a group unless max_parallel_chunks says;
    # a mesh shows none
    progress = bool(use_tqdm) and y2d.shape[-1] > chunk_size and mesh is None
    group = group or (1 if progress else 0)

    if use_torch:
        gate = torch_gate_for(
            sr, stationary=stationary, prop_decrease=prop_decrease,
            time_constant_s=time_constant_s,
            freq_mask_smooth_hz=freq_mask_smooth_hz,
            time_mask_smooth_ms=time_mask_smooth_ms,
            thresh_n_mult_nonstationary=thresh_n_mult_nonstationary,
            sigmoid_slope_nonstationary=sigmoid_slope_nonstationary,
            n_std_thresh_stationary=n_std_thresh_stationary, n_fft=n_fft,
            win_length=win_length, hop_length=hop_length,
        )
        with torch.no_grad():
            out = _reduce_noise_torch_path(
                y2d, gate, y_noise, chunk_size, padding, clip_noise_stationary, group,
                progress, mesh,
            )
        return out, (out_dtype, flat)

    cfg = GateConfig(
        sr=sr,
        stationary=bool(stationary),
        prop_decrease=prop_decrease,
        time_constant_s=time_constant_s,
        freq_mask_smooth_hz=freq_mask_smooth_hz,
        time_mask_smooth_ms=time_mask_smooth_ms,
        thresh_n_mult_nonstationary=thresh_n_mult_nonstationary,
        sigmoid_slope_nonstationary=sigmoid_slope_nonstationary,
        n_std_thresh_stationary=n_std_thresh_stationary,
        n_fft=n_fft,
        win_length=win_length,
        hop_length=hop_length,
        convention=Convention.SCIPY,
    )
    with torch.no_grad():
        if not stationary:
            out = _run_nonstationary(y2d, cfg, chunk_size, padding, group, progress, mesh)
        else:
            # noise clip handling (stationary.py:47-64; api.py:560-578):
            # default to y, mono collapse, clip to chunk_size samples
            def own_rows():  # the signal's rows where the statistics run
                if mesh is None:
                    return y2d  # "self": no second transfer
                return (y2d[..., :chunk_size] if clip_noise_stationary else y2d).to(dev)

            if isinstance(_noise_rows, str):
                yn_mono = own_rows()
            elif _noise_rows is not None:
                yn_mono = _to_tensor(_noise_rows, dev, cdtype)
            else:
                yn2d = own_rows() if y_noise is None else _to_tensor(
                    _as_2d(np.asarray(y_noise))[0], dev, cdtype
                )
                yn_mono = yn2d.mean(dim=0)
            if clip_noise_stationary:
                yn_mono = yn_mono[..., :chunk_size]
            out = _run_stationary(y2d, yn_mono, cfg, chunk_size, padding, group, progress,
                                  mesh)
    return out, (out_dtype, flat)


def _to_tensor(a, dev: torch.device, dtype) -> torch.Tensor:
    """An array, or a list of equal-length 1-D rows, on ``dev`` in ``dtype``.
    Rows go to the device one by one into one (rows, n) tensor: stacking
    them on the host first would cost a host copy of the whole block. A
    bfloat16 array crosses in its own dtype and is cast on the device, as
    the rows are: the host's cast of a long signal costs about what the
    halved copy saves (``chip_smoke.py`` times both; PERF.md, section
    6)."""
    if not isinstance(a, list):
        t = torch.as_tensor(np.ascontiguousarray(a))
        if dtype == torch.bfloat16:
            return t.to(dev).to(dtype)
        return t.to(device=dev, dtype=dtype)
    rows = [torch.from_numpy(np.ascontiguousarray(r)) for r in a]
    out = torch.empty((len(rows), rows[0].shape[-1]), dtype=rows[0].dtype, device=dev)
    for i, r in enumerate(rows):
        out[i].copy_(r)
    return out.to(dtype)


def reduce_noise_batch(ys, sr, y_noise=None, **kwargs):
    """Denoise many mono recordings in as few launches as possible
    (``api.py:704``).

    Signals are grouped by (length, dtype) and each group runs as one
    batched call: the gate's math is row-independent, so each output is
    what the per-signal ``reduce_noise`` call gives. Every group's kernels
    are queued on the card before the first result is copied back.

    Parameters
    ----------
    ys : sequence of 1-D np.ndarray, mono recordings (lengths and dtypes
        may differ)
    sr : int, shared sample rate
    y_noise : one shared noise clip (one threshold), one clip per signal,
        or None
    **kwargs : forwarded to ``reduce_noise`` (``method``, ``mesh``,
        ``max_parallel_chunks`` and ``use_tqdm`` too). ``stationary=True`` with
        ``y_noise=None`` takes each signal's threshold from itself, and
        per-signal 1-D clips give per-signal thresholds: both batch as one
        threshold call and one gate call per group through a (B, bins)
        threshold (with ``use_torch``, the TorchGate engine's statistics,
        which are per row already: self-noise as no clip, and the clips,
        each cut to its signal's length, as B noise rows). Per-signal
        multichannel clips run per signal.

    Returns a list of np.ndarray in input order, each with its input's
    shape and dtype.
    """
    ys = [np.asarray(y) for y in ys]
    for i, y in enumerate(ys):
        if y.ndim != 1:
            raise ValueError(
                f"ys[{i}] has ndim {y.ndim}; reduce_noise_batch takes mono "
                "1-D signals (call reduce_noise directly for multichannel)"
            )
    per_signal_noise = isinstance(y_noise, (list, tuple))
    if per_signal_noise and len(y_noise) != len(ys):
        raise ValueError(f"got {len(y_noise)} noise clips for {len(ys)} signals")
    call = dict(_REDUCE_DEFAULTS, **kwargs)
    call.pop("tmp_folder", None)
    stationary = bool(call["stationary"])
    # per-row noise statistics: self-noise or per-signal clips, both batched
    # through a (B, bins) threshold
    per_row = stationary and (per_signal_noise or y_noise is None)

    if stationary and per_signal_noise and any(np.ndim(c) != 1 for c in y_noise):
        # per-signal multichannel clips need each signal's own mono
        # collapse: per-signal calls, all queued before the first D2H
        pending = [
            _reduce_noise_deferred(**dict(call, y=y, sr=sr, y_noise=y_noise[i]))
            for i, y in enumerate(ys)
        ]
        return [_finalize_reduce_output(o, *meta) for o, meta in pending]

    groups: dict = {}
    for i, y in enumerate(ys):
        key = (y.shape[0], y.dtype)
        if per_signal_noise and stationary:
            c = np.asarray(y_noise[i])
            key += (c.shape[-1], c.dtype)
        groups.setdefault(key, []).append(i)
    pending = []
    for idx in groups.values():
        block = _Rows(ys[i] for i in idx)  # B rows of n samples
        if not per_row:
            # a shared clip, or the non-stationary gate (which reads no
            # noise): one call
            noise = y_noise if stationary else None
            pending.append((idx, _reduce_noise_deferred(
                **dict(call, y=block, sr=sr, y_noise=noise))))
        elif call["use_torch"]:
            # TorchGate's statistics are per row already (torchgate.py:126-
            # 165): self-noise as no clip, per-signal clips as noise rows,
            # each cut to its signal's length (streamed_torch_gate.py:57-58)
            clips = None
            if per_signal_noise:
                n = block[0].shape[0]
                clips = _Rows(np.asarray(y_noise[i]) for i in idx)
                if call["clip_noise_stationary"]:
                    clips = _Rows(c[:n] for c in clips)
            pending.append((idx, _reduce_noise_deferred(
                **dict(call, y=block, sr=sr, y_noise=clips))))
        else:
            rows = [np.asarray(y_noise[i]) for i in idx] if per_signal_noise else "self"
            pending.append((idx, _reduce_noise_deferred(
                **dict(call, y=block, sr=sr, y_noise=None, _noise_rows=rows))))
    out: list = [None] * len(ys)
    for idx, (o, meta) in pending:
        res = _finalize_reduce_output(o, *meta)
        for row, i in enumerate(idx):
            out[i] = res[row]
    return out


_REDUCE_DEFAULTS = {
    name: p.default
    for name, p in inspect.signature(reduce_noise).parameters.items()
    if p.default is not inspect.Parameter.empty
}
