"""The host signal's way to the card and the gated cores' way back.

A host array reaches the card in slabs along the sample axis: the host
copies slab i (every row's samples [a, b), read straight from the array,
strided or not, in the array's own dtype, by a pool of threads) into a
pinned slot of a small ring, a copy stream sends it with
``non_blocking=True`` and casts it on the card into the signal's device
tensor, and an event is recorded after it. The calling thread sends the
slabs in order as the chunked body asks for them
(``StagedSignal.wait_slab``), between the launches of its kernels: the
chunks run in pieces, and a piece's kernels wait, on the compute stream,
only for the slab that holds the last sample its halo'd views read. Each
piece's cores go back on a second copy stream into their columns of one
pinned output (``PinnedCores``) while the next piece's slabs are copied,
sent and gated.

``transfer_plan`` is the schedule as a pure function (slabs, pieces and
the slab each piece waits for), which ``chunking.staged_pieces`` follows;
``piece_chunks`` is the rule that sizes a piece from the geometry.

Only card devices stage: ``device="cpu"`` makes no stream, no event and no
pinned tensor. Pinning raises where it fails; nothing falls back to a
pageable copy.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = [
    "SLAB_BYTES",
    "RING_SLABS",
    "MAX_PIECES",
    "MIN_PIECE_SAMPLES",
    "LOOKAHEAD_SLABS",
    "COPY_THREADS",
    "COPY_PART_BYTES",
    "slab_width",
    "piece_chunks",
    "transfer_plan",
    "HostSignal",
    "StagedSignal",
    "PinnedCores",
    "materialize",
]

# bytes of the host signal in one slab (every row's samples of its range)
SLAB_BYTES = 16 << 20
# pinned slots in a thread's ring: slab i reuses slot i % RING_SLABS once the
# copy of slab i - RING_SLABS has completed
RING_SLABS = 4
# a piece holds at least ceil(n_chunks / MAX_PIECES) chunks, and at least
# MIN_PIECE_SAMPLES samples of all rows (measured in PERF.md, section 6:
# each piece costs the host one launch of each kernel, and the first
# piece's slabs and the last piece's kernels and D2H are not overlapped)
MAX_PIECES = 4
MIN_PIECE_SAMPLES = 1 << 22
# slabs sent beyond the one a piece waits for before its kernels are
# launched, so that the next slab's H2D runs beside them
LOOKAHEAD_SLABS = 1
# the host's copy of a slab into its slot: numpy copies (which release the
# GIL) of parts of at least COPY_PART_BYTES, one row's run or a piece of it,
# spread over a pool of COPY_THREADS threads
COPY_THREADS = 8
COPY_PART_BYTES = 2 << 20


def slab_width(rows: int, itemsize: int) -> int:
    """Samples of each row in one slab: ``SLAB_BYTES`` of all rows, at
    least one."""
    return max(1, SLAB_BYTES // (rows * itemsize))


def piece_chunks(n_chunks: int, chunk_size: int, rows: int) -> int:
    """Chunks in one piece of ``n_chunks`` halo'd chunks of ``rows`` rows:
    at most ``MAX_PIECES`` pieces, each of at least ``MIN_PIECE_SAMPLES``
    samples, so one piece for a short signal."""
    by_count = -(-n_chunks // MAX_PIECES)
    by_size = -(-MIN_PIECE_SAMPLES // (chunk_size * rows))
    return max(1, min(n_chunks, max(by_count, by_size)))


def transfer_plan(n_src: int, chunk_size: int, padding: int, first: int, count: int,
                  piece: int, width: int, src_start: int = 0):
    """The staged schedule of chunks [first, first + count) read from a
    source of ``n_src`` samples that starts at signal sample ``src_start``
    (a mesh device's slice; 0 and the whole signal otherwise): the slabs,
    [(a, b)] over [0, n_src) in ``width`` samples, and the pieces of
    ``piece`` chunks, [(first chunk, chunks, slab)], each with the index of
    the slab that holds the last source sample its views read,
    min(n_src, (c + k) * chunk_size + padding - src_start) - 1."""
    slabs = [(a, min(n_src, a + width)) for a in range(0, n_src, width)]
    pieces = []
    for s in range(0, count, piece):
        c, k = first + s, min(piece, count - s)
        end = min(n_src, (c + k) * chunk_size + padding - src_start)
        pieces.append((c, k, (end - 1) // width))
    return slabs, pieces


_STREAMS: dict = {}


def _copy_stream(device: torch.device, way: str) -> torch.cuda.Stream:
    """The device's copy stream for ``way`` ("h2d" or "d2h"), made once: the
    two ways have a stream each, so that a piece's D2H, which waits for its
    kernels, never holds up a later slab's H2D."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), way)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(torch.device("cuda", key[0]))
    return _STREAMS[key]


class _Slot:
    """One pinned slot of the ring and the event recorded after the last
    copy that read it: it is refilled only once that event has completed."""

    def __init__(self, nbytes: int):
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.event = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        if self.buf.numel() < nbytes:
            self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.buf


_LOCAL = threading.local()


def _ring() -> list:
    """This thread's ring of ``RING_SLABS`` pinned slots, made at its first
    staged call and reused by every later one: slab i of a signal takes
    slot i % RING_SLABS."""
    ring = getattr(_LOCAL, "ring", None)
    if ring is None:
        ring = _LOCAL.ring = [_Slot(SLAB_BYTES) for _ in range(RING_SLABS)]
    return ring


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


_POOL = None
_POOL_LOCK = threading.Lock()


def _copy_pool():
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _POOL = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="noisereduce-copy")
        return _POOL


class HostSignal:
    """A host signal of equal-length rows (a 2-D array, any strides, or a
    list of 1-D arrays), read in ``dtype``: the signal a call gates, before
    any of it is on a card. ``shape``, ``dtype`` and ``device`` (the host)
    are those of the tensor it stands for."""

    def __init__(self, rows, dtype: torch.dtype):
        if isinstance(rows, list):
            self.rows = [np.asarray(r) for r in rows]
        else:
            self.rows = list(np.asarray(rows))
        self.shape = (len(self.rows), self.rows[0].shape[-1])
        self.dtype = dtype
        self.device = torch.device("cpu")
        self.host_dtype = _torch_dtype(self.rows[0].dtype)

    def tensor(self) -> torch.Tensor:
        """The whole signal as a host tensor in ``dtype`` (cast on the
        host), for the paths that take a host tensor."""
        out = torch.empty(self.shape, dtype=self.host_dtype)
        self.copy_into(out, 0, self.shape[1])
        return out.to(self.dtype)

    def copy_into(self, dst: torch.Tensor, a: int, b: int) -> None:
        """Every row's samples [a, b) into the (rows, b - a) host tensor
        ``dst``, read straight from the rows whatever their strides, in
        parts of at least ``COPY_PART_BYTES`` spread over the copy pool (the
        calling thread copies a single part itself)."""
        out = dst.numpy()
        w = b - a
        step = max(1, COPY_PART_BYTES // dst.element_size(),
                   -(-w * len(self.rows) // COPY_THREADS))
        parts = [(r, s, min(w, s + step)) for r in range(len(self.rows))
                 for s in range(0, w, step)]

        def copy(part):
            r, s, e = part
            np.copyto(out[r, s:e], self.rows[r][a + s : a + e], casting="no")

        if len(parts) == 1:
            copy(parts[0])
        else:
            for _ in _copy_pool().map(copy, parts):
                pass

    def stage(self, device: torch.device, lo: int = 0, hi=None) -> "StagedSignal":
        """Samples [lo, hi) of every row on ``device``, staged lazily."""
        return StagedSignal(self, torch.device(device), lo, self.shape[1] if hi is None else hi)


class StagedSignal:
    """Samples [lo, hi) of a ``HostSignal``'s rows on a card, sent in slabs
    as they are asked for, ``width`` samples of each row a slab. ``buffer``
    is the (rows, hi - lo) device tensor the slabs fill, in the signal's
    dtype; a kernel reads a range of it only after ``wait_through`` of the
    range's end (or ``wait_slab`` of its last slab) on its stream.
    ``start`` is ``lo``, the signal sample that ``buffer``'s column 0
    holds."""

    def __init__(self, host: HostSignal, device: torch.device, lo: int, hi: int):
        if device.type != "cuda":
            raise ValueError(f"staging needs a card, got {device}")
        self.host, self.start = host, lo
        rows = host.shape[0]
        self.shape = (rows, hi - lo)
        self.dtype, self.device = host.dtype, device
        self._itemsize = torch.empty(0, dtype=host.host_dtype).element_size()
        self.width = slab_width(rows, self._itemsize)
        self._n_slabs = -(-(hi - lo) // self.width)
        self._h2d = _copy_stream(device, "h2d")
        with torch.cuda.stream(self._h2d):
            self.buffer = torch.empty(self.shape, dtype=host.dtype, device=device)
        # the compute stream reads it: no reuse before its reads are done
        self.buffer.record_stream(torch.cuda.current_stream(device))
        self._events = []

    def _stage_next(self) -> None:
        """The next slab: the host's copy into this thread's ring, the H2D
        and the cast on the copy stream, and an event after them."""
        i = len(self._events)
        a = i * self.width
        b = min(self.shape[1], a + self.width)
        rows, w = self.shape[0], b - a
        ring = _ring()
        slot = ring[i % len(ring)]
        nbytes = rows * w * self._itemsize
        pinned = slot.take(nbytes)[:nbytes].view(self.host.host_dtype).view(rows, w)
        self.host.copy_into(pinned, self.start + a, self.start + b)
        dst = self.buffer[:, a:b]
        with torch.cuda.stream(self._h2d):
            if dst.is_contiguous() and self.host.host_dtype == self.dtype:
                dst.copy_(pinned, non_blocking=True)
            else:  # sent in the host's dtype, cast on the card
                raw = torch.empty((rows, w), dtype=self.host.host_dtype, device=self.device)
                raw.copy_(pinned, non_blocking=True)
                dst.copy_(raw)
            event = torch.cuda.Event()
            event.record(self._h2d)
        slot.event = event
        self._events.append(event)

    def wait_slab(self, i: int) -> None:
        """Send the slabs up to slab ``i`` (and ``LOOKAHEAD_SLABS`` more)
        and make the device's current stream wait for it (and so for every
        slab before it)."""
        while len(self._events) <= min(i + LOOKAHEAD_SLABS, self._n_slabs - 1):
            self._stage_next()
        torch.cuda.current_stream(self.device).wait_event(self._events[i])

    def wait_through(self, end: int) -> None:
        """``wait_slab`` of the slab holding local sample ``end - 1``."""
        if self._n_slabs:  # no samples: nothing to send
            self.wait_slab((max(1, end) - 1) // self.width)

    def head(self, m=None) -> torch.Tensor:
        """``buffer``'s first ``m`` samples (all for None) once they are
        on the card, for the current stream."""
        m = self.shape[1] if m is None else min(m, self.shape[1])
        self.wait_through(m)
        return self.buffer[:, :m]

    def tensor(self) -> torch.Tensor:
        return self.head()


class PinnedCores:
    """The pinned host output (rows, n) of a chunked call, filled by pieces:
    ``put`` sends a piece's cores, on the device's D2H stream after the
    piece's kernels, into their columns; ``result`` waits for every copy.
    Each call has its own output, never a pooled slot, so a result outlives
    the next call."""

    def __init__(self, rows: int, n: int):
        self.host = torch.empty((rows, n), dtype=torch.float32, pin_memory=True)
        self._events = []

    def put(self, a: int, cores: torch.Tensor) -> None:
        """Cores (rows, w) on a card, queued on its current stream, into
        columns [a, a + w) cut to the output's length (bfloat16 widened on
        the card first)."""
        dev = cores.device
        compute = torch.cuda.current_stream(dev)
        if cores.dtype != torch.float32:
            cores = cores.float()
        b = min(self.host.shape[1], a + cores.shape[1])
        d2h = _copy_stream(dev, "d2h")
        d2h.wait_stream(compute)
        with torch.cuda.stream(d2h):
            if self.host.shape[0] == 1:
                self.host[:, a:b].copy_(cores[:, : b - a], non_blocking=True)
            else:  # one row at a time: each a contiguous run on both sides
                for r in range(self.host.shape[0]):
                    self.host[r, a:b].copy_(cores[r, : b - a], non_blocking=True)
            event = torch.cuda.Event()
            event.record(d2h)
        cores.record_stream(d2h)
        self._events.append(event)

    def result(self) -> torch.Tensor:
        for event in self._events:
            event.synchronize()
        self._events = []
        return self.host


def materialize(y):
    """A tensor for the paths that take one: a staged signal once all of it
    is on the card, a host signal cast on the host; a tensor as it is."""
    return y.tensor() if isinstance(y, (HostSignal, StagedSignal)) else y
