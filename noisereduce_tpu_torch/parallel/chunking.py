"""Chunk + halo combinator (counterpart of
``noisereduce_tpu/parallel/chunking.py``).

The reference splits long recordings into ``chunk_size``-sample chunks,
each extended by a ``padding``-sample halo read from the source signal
(zero fill past the signal edges, base.py:130-142), filters the chunks and
assembles the cores (base.py:167-226). Here the chunk axis is a batch axis
of one call, or of one call per group of chunks (``chunk_groups``: the
JAX package's ``max_parallel_chunks`` and its host-driven group loop under
a progress bar, ``noisereduce_tpu/api.py::_run_chunked_with_progress``),
or is sharded over the devices of a ``parallel.mesh.ChunkMesh``
(``shard_cores``: each device a contiguous range of chunks, gated from its
own slice of the signal with its halos, in groups where asked; the JAX
package's ``shard_map`` over the chunk axis). The fused path
(``ops.cuda.dispatch.fused_gate_chunked``) reads the views straight from
the signal instead; this module serves the unchunked path and the
geometries the kernels do not. A host signal that a card gates arrives in
slabs (``parallel.transfer``): ``grouped_cores`` and ``shard_cores`` then
run its chunks in pieces, each waiting only for its own slabs, each
piece's cores copied back into one pinned output behind it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from noisereduce_tpu_torch.parallel.transfer import (
    HostSignal,
    PinnedCores,
    StagedSignal,
    materialize,
    piece_chunks,
    to_output,
    transfer_plan,
)

__all__ = [
    "n_chunks_for",
    "pad_chunk_signal",
    "chunk_views",
    "extract_chunks",
    "assemble_chunks",
    "process_chunked",
    "chunk_groups",
    "grouped_cores",
    "staged_pieces",
    "mesh_ranges",
    "shard_cores",
    "shard_filter",
]


def n_chunks_for(n_samples: int, chunk_size: int) -> int:
    """Number of chunks the reference processes (base.py:174-177)."""
    return (n_samples - 1) // chunk_size + 1


def pad_chunk_signal(y: torch.Tensor, chunk_size: int, padding: int) -> torch.Tensor:
    """Zero-extend (..., n) so that chunk i's halo'd view is the plain
    slice [i*cs, i*cs + cs + 2*padding) of the result."""
    n = y.shape[-1]
    total = n_chunks_for(n, chunk_size) * chunk_size
    return F.pad(y, (padding, total - n + padding))


def extract_chunks(y: torch.Tensor, chunk_size: int, padding: int) -> torch.Tensor:
    """(..., n) -> (..., n_chunks, chunk_size + 2*padding) halo'd views:
    chunk i covers source samples [i*cs - padding, (i+1)*cs + padding),
    zero outside [0, n) (base.py:144-148 + 130-142)."""
    view = chunk_size + 2 * padding
    return pad_chunk_signal(y, chunk_size, padding).unfold(-1, view, chunk_size)


def chunk_views(y: torch.Tensor, chunk_size: int, padding: int, first: int, k: int,
                src_start: int = 0) -> torch.Tensor:
    """(..., n_src) -> (..., k, chunk_size + 2*padding): the halo'd views of
    chunks [first, first + k) when ``y`` holds the source samples from
    ``src_start`` on (a device's slice of the signal): the samples of
    ``extract_chunks``' views, zero outside ``y``, which must reach the
    signal's true ends wherever a view runs past the slice."""
    view = chunk_size + 2 * padding
    start = first * chunk_size - padding - src_start
    end = start + (k - 1) * chunk_size + view
    ypad = F.pad(y, (max(0, -start), max(0, end - y.shape[-1])))
    lo = max(0, start)
    return ypad[..., lo : lo + end - start].unfold(-1, view, chunk_size)


def assemble_chunks(
    filtered: torch.Tensor, chunk_size: int, padding: int, n_samples: int
) -> torch.Tensor:
    """(..., n_chunks, chunk + 2*pad) -> (..., n_samples): trim the halos,
    concatenate, crop (base.py:150, 162-165, 217-220)."""
    core = filtered[..., padding : padding + chunk_size]
    out = core.reshape(core.shape[:-2] + (core.shape[-2] * chunk_size,))
    return out[..., :n_samples]


def chunk_groups(n_chunks: int, group: int = 0, progress: bool = False):
    """(first chunk, chunks) of each group of ``group`` chunks in order, the
    last one short; one group of all of them for ``group`` 0. With
    ``progress``, under a ``tqdm`` bar (imported only then), one step a
    group, as the JAX package's loop shows it."""
    g = group or n_chunks
    starts = range(0, n_chunks, g)
    if progress:
        from tqdm.auto import tqdm

        starts = tqdm(starts, total=len(starts), desc="chunks", unit="group")
    for s in starts:
        yield s, min(g, n_chunks - s)


def grouped_cores(core_fn, y, chunk_size: int, group: int = 0, progress: bool = False,
                  padding: int = 0):
    """(..., n) -> (..., n) from ``core_fn(chunks)``, the cores of the k
    chunks of ``chunks`` = (first, k) of every row, each row's k cores in
    order ((rows * k, chunk_size) or (..., k, chunk_size)), or of all of
    them for None, in one call. ``group`` > 0 or ``progress``: one call a
    group (``chunk_groups``), its cores written into one output, so only
    one group's views and planes exist at a time.

    ``y`` may be a ``StagedSignal`` (a host signal on its way to a card;
    ``core_fn`` reads its ``buffer``): then the chunks run in pieces (the
    groups, or ``transfer.piece_chunks`` of them), each piece waiting for
    the slab that holds the last sample its views read (``padding``: the
    halo), and the result is a ``PinnedCores`` in the signal's
    ``out_dtype`` that each piece's cores reach on the D2H stream."""
    n = y.shape[-1]
    n_chunks = n_chunks_for(n, chunk_size)
    if isinstance(y, StagedSignal):
        out = PinnedCores(*y.shape, y.host.out_dtype)
        staged_pieces(core_fn, y, chunk_size, padding, 0, n_chunks, group, progress, out)
        return out
    if not progress and (not group or group >= n_chunks):
        return core_fn(None).reshape(y.shape[:-1] + (-1,))[..., :n]
    out = y.new_empty(y.shape[:-1] + (n_chunks * chunk_size,))
    for s, k in chunk_groups(n_chunks, group or 1, progress):
        out[..., s * chunk_size : (s + k) * chunk_size] = core_fn((s, k)).reshape(
            y.shape[:-1] + (-1,))
    return out[..., :n]


def staged_pieces(core_fn, sig: StagedSignal, chunk_size: int, padding: int, first: int,
                  count: int, group: int, progress: bool, out: PinnedCores) -> None:
    """Chunks [first, first + count) of the staged ``sig`` in pieces of
    ``group`` chunks (one for ``progress`` and no group; else
    ``piece_chunks``), as ``transfer_plan`` schedules them: piece (c, k)
    waits for the slab that holds the last sample its views read, runs
    ``core_fn((c, k))`` and sends its cores into ``out``'s columns from
    c * chunk_size."""
    rows = sig.shape[0]
    size = group or (1 if progress else piece_chunks(count, chunk_size, rows))
    _, plan = transfer_plan(sig.shape[1], chunk_size, padding, first, count, size, sig.width,
                            sig.start)
    for (c, k, slab), _ in zip(plan, chunk_groups(count, size, progress)):  # the bar's steps
        sig.wait_slab(slab)
        out.put(c * chunk_size, core_fn((c, k)).reshape(rows, -1))


def mesh_ranges(n_chunks: int, mesh, axis_name: str = "chunks"):
    """(device, first chunk, chunks) of each device of ``mesh`` that gates
    any: the JAX package's partition, k_local = ceil(n_chunks / n_dev)
    chunks a device, device d the chunks [d * k_local, min(n_chunks,
    (d + 1) * k_local)); the devices past the last chunk get none (the
    all-zero padding chunks ``shard_map`` gates there change nothing)."""
    n_dev = mesh.shape[axis_name]
    k_local = -(-n_chunks // n_dev)
    for d, dev in enumerate(mesh.devices):
        first = d * k_local
        k = min(n_chunks, first + k_local) - first
        if k > 0:
            yield dev, first, k


def shard_cores(core_fn, y, chunk_size: int, padding: int, mesh,
                axis_name: str = "chunks", group: int = 0, extra: tuple = (),
                out_dtype=None):
    """(..., n) -> (..., n) on ``y``'s device, its chunks sharded over
    ``mesh`` (``mesh_ranges``): device d receives only the samples its
    views read, [first*cs - padding, (first + k)*cs + padding) cut to the
    signal, and a copy of each ``extra`` operand (None stays None; the
    one broadcast), and gates its chunks with ``core_fn(y_local,
    src_start, (first, count), *extra_local)``, which returns the cores of
    those chunks of every row ((rows * count, chunk_size) or (...,
    count, chunk_size)) on the device, in one call, or one call a group of
    ``group`` chunks (the bound on device memory is per device). Every
    device's work is issued before any result is waited for; then each
    device's cores go into their own columns of the one output (one copy a
    device; pinned host memory where ``y`` is on the host), in
    ``out_dtype`` where given (brought to it on each device first,
    ``transfer.to_output``: widened, or narrowed by kernel H), else in the
    cores' own.

    A ``HostSignal`` ``y`` is staged to each device, its slice in slabs
    (``parallel.transfer``), and each device's chunks run in pieces as
    ``grouped_cores`` runs them; the result is a ``PinnedCores`` in its
    ``out_dtype``."""
    n = y.shape[-1]
    lead = y.shape[:-1]
    ranges = list(mesh_ranges(n_chunks_for(n, chunk_size), mesh, axis_name))
    if isinstance(y, HostSignal):
        out = PinnedCores(*y.shape, y.out_dtype)
        for dev, first, k in ranges:
            lo = max(0, first * chunk_size - padding)
            sig = y.stage(dev, lo, min(n, (first + k) * chunk_size + padding))
            ex = tuple(None if e is None else e.to(dev) for e in extra)
            with torch.cuda.device(dev):
                staged_pieces(lambda c, sig=sig, ex=ex: core_fn(sig.buffer, sig.start, c, *ex),
                              sig, chunk_size, padding, first, k, group, False, out)
        return out
    pieces = []
    for dev, first, k in ranges:
        lo = max(0, first * chunk_size - padding)
        y_d = y[..., lo : min(n, (first + k) * chunk_size + padding)].to(dev).contiguous()
        ex = tuple(None if e is None else e.to(dev) for e in extra)
        piece = None
        for s, kk in chunk_groups(k, group):
            c = core_fn(y_d, lo, (first + s, kk), *ex).reshape(lead + (-1,))
            if kk == k:
                piece = c
                break
            if piece is None:
                piece = c.new_empty(lead + (k * chunk_size,))
            piece[..., s * chunk_size : (s + kk) * chunk_size] = c
        pieces.append((first * chunk_size, piece))
    # pinned where the output is on the host and a card gates, so that each
    # device's D2H lands in place
    pin = y.device.type == "cpu" and any(d.type == "cuda" for d in mesh.devices)
    dtype = out_dtype or pieces[0][1].dtype
    out = torch.empty(lead + (n,), dtype=dtype, device=y.device, pin_memory=pin)
    for a, piece in pieces:
        b = min(n, a + piece.shape[-1])
        out[..., a:b].copy_(to_output(piece[..., : b - a], dtype))
    return out


def shard_filter(filter_fn, chunks, mesh, axis_name: str = "chunks", extra: tuple = (),
                 max_parallel_chunks: int = 0) -> torch.Tensor:
    """``filter_fn(views, *extra)`` over pre-extracted halo'd chunks (...,
    n_chunks, view), sharded over the chunk axis (-2): each device filters
    its range (``mesh_ranges``) with its own copy of ``extra``, in groups
    of ``max_parallel_chunks`` chunks where that is smaller (a per-device
    bound), and the filtered chunks are assembled on ``chunks``' device.
    ``chunks`` may also be the tuple of per-device blocks that
    ``mesh.distributed_chunks`` places, assembled on the first one's
    device."""
    if isinstance(chunks, tuple):
        blocks, home = chunks, chunks[0]
    else:
        home = chunks
        blocks = tuple(chunks[..., f : f + k, :].to(dev)
                       for dev, f, k in mesh_ranges(chunks.shape[-2], mesh, axis_name))
    outs = []
    for block in blocks:
        ex = tuple(None if e is None else e.to(block.device) for e in extra)
        k = block.shape[-2]
        outs.extend(filter_fn(block[..., s : s + kk, :], *ex)
                    for s, kk in chunk_groups(k, max_parallel_chunks))
    return torch.cat([o.to(home.device) for o in outs], dim=-2)


def process_chunked(
    filter_fn: Callable[..., torch.Tensor],
    y: torch.Tensor,
    chunk_size: int,
    padding: int,
    group: int = 0,
    progress: bool = False,
    mesh=None,
    axis_name: str = "chunks",
    extra: tuple = (),
) -> torch.Tensor:
    """Apply ``filter_fn`` ((..., L), *extra -> (..., L)) chunk-parallel
    over (..., n). Signals of at most ``chunk_size`` samples are still
    padded by ±``padding`` zeros and filtered whole (base.py:222 -> 144-150;
    SURVEY.md §5 quirk 6), even with a mesh, on its first device: the
    non-stationary IIR is global over frames. ``group`` > 0 or
    ``progress``: ``filter_fn`` takes the chunks in groups of ``group`` (1
    for 0; ``grouped_cores``). ``mesh``: the chunks sharded over its
    devices (``shard_cores``; no bar), ``extra`` (e.g. a stationary
    threshold) copied to each; the output on ``y``'s device. A staged or
    host signal is first made whole (``transfer.materialize``); a host
    signal's output (a mesh's, on the host) comes back in its
    ``out_dtype``, brought to it on the card (``transfer.to_output``)."""
    out_dtype = y.out_dtype if isinstance(y, HostSignal) else None
    y = materialize(y)
    n = y.shape[-1]
    if n <= chunk_size:
        ypad = F.pad(y, (padding, padding))
        if mesh is not None:
            dev = mesh.devices[0]
            ex = tuple(None if e is None else e.to(dev) for e in extra)
            out = filter_fn(ypad.to(dev), *ex)[..., padding : padding + n]
            return to_output(out, out_dtype or out.dtype).to(y.device)
        return filter_fn(ypad, *extra)[..., padding : padding + n]
    if mesh is not None:
        def local_cores(y_d, src_start, c, *ex):
            views = chunk_views(y_d, chunk_size, padding, c[0], c[1], src_start)
            return filter_fn(views, *ex)[..., padding : padding + chunk_size]

        return shard_cores(local_cores, y, chunk_size, padding, mesh, axis_name, group, extra,
                           out_dtype)
    chunks = extract_chunks(y, chunk_size, padding)

    def cores(c):
        views = chunks if c is None else chunks[..., c[0] : c[0] + c[1], :]
        return filter_fn(views, *extra)[..., padding : padding + chunk_size]

    return grouped_cores(cores, y, chunk_size, group, progress)
