"""The host signal's way to the card and the gated cores' way back.

A host array reaches the card in slabs along the sample axis: the host
copies slab i (every row's samples [a, b), read straight from the array,
strided or not, in the array's own dtype or, for float64 headed for
float32, cast in the same pass; by the native threads of
``host_copy.CopyPool``) into a pinned slot of a small ring, a copy stream
sends it with ``non_blocking=True`` and casts it on the card into the
signal's device tensor, and an event is recorded after it. The calling
thread sends the slabs in order as the chunked body asks for them
(``StagedSignal.wait_slab``), between the launches of its kernels: the
chunks run in pieces, and a piece's kernels wait, on the compute stream,
only for the slab that holds the last sample its halo'd views read. Each
piece's cores go back on a second copy stream into their columns of one
pinned output (``PinnedCores``) while the next piece's slabs are copied,
sent and gated. That output is in the caller's dtype (``output_dtype``), so
the host casts nothing: float64 rows get the cores widened on the card
(exact); int8, uint8, int16, uint16, int32 and float16 rows get them
narrowed on the card by kernel H (``ops/cuda/kernels.py::output_cast``,
numpy's cast), whose D2H then moves the narrow bytes; any other rows get
float32, which numpy casts (``to_output``).

``transfer_plan`` is the schedule as a pure function (slabs, pieces and
the slab each piece waits for), which ``chunking.staged_pieces`` follows;
``piece_chunks`` is the rule that sizes a piece from the geometry.

Only card devices stage: ``device="cpu"`` makes no stream, no event and no
pinned tensor. Where the card has a NUMA node, the copy threads are bound
to its CPUs and a ring's slots are pinned by a thread bound there.
Pinning and the native copy raise where they fail (a ``g++`` error with
it); nothing falls back to a pageable copy or to numpy.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from noisereduce_tpu_torch.parallel import host_copy

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
    "output_dtype",
    "to_output",
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
# the host's copy of a slab into its slot (host_copy.CopyPool, native code
# off the GIL, non-temporal stores where the slot is aligned): parts of at
# least COPY_PART_BYTES, one row's run or a piece of it, spread over
# COPY_THREADS threads; where the card has a NUMA node, the threads bound to
# its CPUs and the ring's slots pinned by a thread bound there
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


_NODE_CPUS: dict = {}


def _copy_pool(device=None) -> host_copy.CopyPool:
    """The copy threads that fill ``device``'s slots: bound to the CPUs of
    the card's NUMA node where it has one, else unbound (and unbound for a
    host tensor, ``device`` None)."""
    cpus = None
    if device is not None:
        key = device.index if device.index is not None else torch.cuda.current_device()
        if key not in _NODE_CPUS:
            _NODE_CPUS[key] = host_copy.node_cpus(torch.device("cuda", key))
        cpus = _NODE_CPUS[key]
    return host_copy.pool(COPY_THREADS, cpus)


class _Slot:
    """One pinned slot of the ring, the copy ``pool``'s to fill: pinned by
    torch with the calling thread bound to the pool's CPUs (their node's
    pages, where the card has a node), and the event recorded after the
    last copy that read it: it is refilled only once that event has
    completed."""

    def __init__(self, nbytes: int, pool: host_copy.CopyPool):
        self.pool, self.event = pool, None
        self._alloc(nbytes)

    def _alloc(self, nbytes: int) -> None:
        self.buf = host_copy.on_cpus(self.pool.cpus, lambda: torch.empty(
            nbytes, dtype=torch.uint8, pin_memory=True))
        self.ptr, self.nbytes = self.buf.data_ptr(), nbytes

    def take(self, nbytes: int) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        if self.nbytes < nbytes:
            self._alloc(nbytes)
        return self.buf


_LOCAL = threading.local()


def _ring(device: torch.device) -> list:
    """This thread's ring of ``RING_SLABS`` pinned slots for the copy pool
    of ``device`` (``_copy_pool``), made at its first staged call and
    reused by every later one: slab i of a signal takes slot
    i % RING_SLABS."""
    pool = _copy_pool(device)
    rings = getattr(_LOCAL, "rings", None)
    if rings is None:
        rings = _LOCAL.rings = {}
    if pool not in rings:
        rings[pool] = [_Slot(SLAB_BYTES, pool) for _ in range(RING_SLABS)]
    return rings[pool]


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def _narrowed() -> tuple:
    """The caller dtypes that kernel H writes (imported here, not at the
    top: the kernels' module imports this one)."""
    from noisereduce_tpu_torch.ops.cuda.kernels import CAST_DTYPES

    return CAST_DTYPES


def output_dtype(rows: np.dtype, compute: torch.dtype) -> torch.dtype:
    """The dtype a card's output of numpy ``rows``-dtype rows computed in
    ``compute`` comes back to the host in: the rows' own for float64 and
    for the dtypes kernel H writes (int8, uint8, int16, uint16, int32,
    float16), so that the host casts nothing; float64 for the latter when
    the compute is float64 (the parity mode, which launches no kernel:
    numpy casts its output, as the JAX package casts its own); float32 for
    any other rows (uint32, int64, ...: numpy's cast, whose x86 rules
    differ for them)."""
    rows = _torch_dtype(rows)
    if rows == torch.float64 or (compute == torch.float64 and rows in _narrowed()):
        return torch.float64
    return rows if rows in _narrowed() else torch.float32


def to_output(cores: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``cores`` in ``dtype`` on their device: narrowed by kernel H
    (``output_cast``, numpy's cast; a CPU tensor by its plain version) for
    the dtypes it writes, else cast by torch (a widening: bfloat16 to
    float32, float32 to float64, exact); ``cores`` themselves where they
    are in ``dtype`` already."""
    if cores.dtype == dtype:
        return cores
    if dtype in _narrowed():
        from noisereduce_tpu_torch.ops.cuda.kernels import output_cast

        return output_cast(cores, dtype)
    return cores.to(dtype)


class HostSignal:
    """A host signal of equal-length rows (a 2-D array, any strides, or a
    list of 1-D arrays of one dtype), read in ``dtype``: the signal a call
    gates, before any of it is on a card. ``shape``, ``dtype`` and
    ``device`` (the host) are those of the tensor it stands for.
    ``wire_dtype`` is the dtype its slabs cross in: the rows' own, or
    float32 for float64 rows headed for float32 (the host's cast, round to
    nearest even, is bitwise the card's; float64 headed for bfloat16 would
    round twice on the host, so it crosses as float64). ``out_dtype`` is
    the dtype its gated output comes back in (``PinnedCores``;
    ``output_dtype``): the rows' own for float64 (widened on the card,
    exact) and for int8, uint8, int16, uint16, int32 and float16 (narrowed
    on the card by kernel H, numpy's cast), with no host pass over the
    output; else float32."""

    def __init__(self, rows, dtype: torch.dtype):
        if isinstance(rows, list):
            self.rows = [np.asarray(r) for r in rows]
        else:
            self.rows = list(np.asarray(rows))
        first = self.rows[0]
        if any(r.shape != first.shape or r.dtype != first.dtype or r.ndim != 1
               for r in self.rows):
            raise ValueError("a host signal's rows are 1-D arrays of one length and dtype")
        self.shape = (len(self.rows), first.shape[-1])
        self.dtype = dtype
        self.device = torch.device("cpu")
        self.host_dtype = _torch_dtype(first.dtype)
        self.wire_dtype = (torch.float32 if self.host_dtype == torch.float64
                           and dtype == torch.float32 else self.host_dtype)
        self.out_dtype = output_dtype(first.dtype, dtype)
        self._addr = np.array([r.ctypes.data for r in self.rows], dtype=np.int64)
        self._stride = np.array([r.strides[0] for r in self.rows], dtype=np.int64)

    def tensor(self) -> torch.Tensor:
        """The whole signal as a host tensor in ``dtype`` (cast on the
        host), for the paths that take a host tensor."""
        out = torch.empty(self.shape, dtype=self.wire_dtype)
        self.copy_into(out, 0, self.shape[1])
        return out.to(self.dtype)

    def copy_into(self, dst: torch.Tensor, a: int, b: int, pool=None) -> None:
        """Every row's samples [a, b) into the (rows, b - a) host tensor
        ``dst`` (rows of unit stride), in the rows' dtype or, for float64
        rows, float32, read straight from the rows whatever their strides:
        native code (``host_copy``) in parts of at least ``COPY_PART_BYTES``
        spread over the threads of ``pool`` (a slot's own; None: the
        unbound pool of ``COPY_THREADS``), a single part on the calling
        thread, with non-temporal stores where ``dst`` is aligned."""
        rows, w = self.shape[0], b - a
        if not 0 <= a <= b <= self.shape[1]:
            raise IndexError(f"samples [{a}, {b}) of rows of {self.shape[1]}")
        if dst.device.type != "cpu" or tuple(dst.shape) != (rows, w) or (
                w > 1 and dst.stride(1) != 1):
            raise ValueError(f"copy_into needs a host tensor of {(rows, w)} with rows of "
                             f"unit stride, got {tuple(dst.shape)} on {dst.device}")
        cast = dst.dtype == torch.float32 and self.host_dtype == torch.float64
        if dst.dtype != self.host_dtype and not cast:
            raise TypeError(f"no host copy of {self.host_dtype} rows into {dst.dtype}")
        if not w:
            return
        size = dst.element_size()
        step = max(1, COPY_PART_BYTES // size, -(-w * rows // COPY_THREADS))
        pool = _copy_pool() if pool is None else pool
        pool.copy(self._addr + a * self._stride, self._stride, self.rows[0].itemsize,
                  dst.data_ptr(), dst.stride(0) * size, size, w, step)

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
        self._itemsize = torch.empty(0, dtype=host.wire_dtype).element_size()
        self.width = slab_width(rows, self._itemsize)
        self._n_slabs = -(-(hi - lo) // self.width)
        self._h2d = _copy_stream(device, "h2d")
        with torch.cuda.stream(self._h2d):
            self.buffer = torch.empty(self.shape, dtype=host.dtype, device=device)
        # the compute stream reads it: no reuse before its reads are done
        self.buffer.record_stream(torch.cuda.current_stream(device))
        self._events = []

    def _stage_next(self) -> None:
        """The next slab: the host's copy into this thread's ring (float64
        cast to float32 in it where the signal is float32), the H2D and the
        cast on the copy stream, and an event after them."""
        i = len(self._events)
        a = i * self.width
        b = min(self.shape[1], a + self.width)
        rows, w = self.shape[0], b - a
        ring = _ring(self.device)
        slot = ring[i % len(ring)]
        nbytes = rows * w * self._itemsize
        wire = self.host.wire_dtype
        pinned = slot.take(nbytes)[:nbytes].view(wire).view(rows, w)
        self.host.copy_into(pinned, self.start + a, self.start + b, pool=slot.pool)
        dst = self.buffer[:, a:b]
        with torch.cuda.stream(self._h2d):
            if dst.is_contiguous() and wire == self.dtype:
                dst.copy_(pinned, non_blocking=True)
            else:  # sent in the wire's dtype, cast on the card
                raw = torch.empty((rows, w), dtype=wire, device=self.device)
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
    """The pinned host output (rows, n) of a chunked call in ``dtype``
    (``HostSignal.out_dtype``), filled by pieces: ``put`` sends a piece's
    cores, on the device's D2H stream after the piece's kernels, into their
    columns; ``result`` waits for every copy. Each call has its own output,
    never a pooled slot, so a result outlives the next call."""

    def __init__(self, rows: int, n: int, dtype: torch.dtype):
        self.host = torch.empty((rows, n), dtype=dtype, pin_memory=True)
        self._events = []

    def put(self, a: int, cores: torch.Tensor) -> None:
        """Cores (rows, w) on a card, queued on its current stream, into
        columns [a, a + w) cut to the output's length, in the output's dtype
        first where theirs differs (``to_output`` on the compute stream:
        bfloat16 cores widened to float32, float32 ones widened to float64
        or narrowed by kernel H), so the D2H moves the output's bytes."""
        dev = cores.device
        compute = torch.cuda.current_stream(dev)
        b = min(self.host.shape[1], a + cores.shape[1])
        cores = to_output(cores[:, : b - a], self.host.dtype)
        d2h = _copy_stream(dev, "d2h")
        d2h.wait_stream(compute)
        with torch.cuda.stream(d2h):
            if self.host.shape[0] == 1:
                self.host[:, a:b].copy_(cores, non_blocking=True)
            else:  # one row at a time: each a contiguous run on both sides
                for r in range(self.host.shape[0]):
                    self.host[r, a:b].copy_(cores[r], non_blocking=True)
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
