"""Chunk + halo combinator without a mesh (counterpart of
``noisereduce_tpu/parallel/chunking.py``).

The reference splits long recordings into ``chunk_size``-sample chunks,
each extended by a ``padding``-sample halo read from the source signal
(zero fill past the signal edges, base.py:130-142), filters the chunks and
assembles the cores (base.py:167-226). Here the chunk axis is a batch axis
of one call, or of one call per group of chunks (``chunk_groups``: the
JAX package's ``max_parallel_chunks`` and its host-driven group loop under
a progress bar, ``noisereduce_tpu/api.py::_run_chunked_with_progress``).
The fused path (``ops.cuda.dispatch.fused_gate_chunked``) reads the views
straight from the signal instead; this module serves the unchunked path and
the geometries the kernels do not.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "n_chunks_for",
    "pad_chunk_signal",
    "extract_chunks",
    "assemble_chunks",
    "process_chunked",
    "chunk_groups",
    "grouped_cores",
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


def grouped_cores(core_fn, y: torch.Tensor, chunk_size: int, group: int = 0,
                  progress: bool = False) -> torch.Tensor:
    """(..., n) -> (..., n) from ``core_fn(chunks)``, the cores of the k
    chunks of ``chunks`` = (first, k) of every row, each row's k cores in
    order ((rows * k, chunk_size) or (..., k, chunk_size)), or of all of
    them for None, in one call. ``group`` > 0 or ``progress``: one call a
    group (``chunk_groups``), its cores written into one output, so only
    one group's views and planes exist at a time."""
    n = y.shape[-1]
    n_chunks = n_chunks_for(n, chunk_size)
    if not progress and (not group or group >= n_chunks):
        return core_fn(None).reshape(y.shape[:-1] + (-1,))[..., :n]
    out = y.new_empty(y.shape[:-1] + (n_chunks * chunk_size,))
    for s, k in chunk_groups(n_chunks, group or 1, progress):
        out[..., s * chunk_size : (s + k) * chunk_size] = core_fn((s, k)).reshape(
            y.shape[:-1] + (-1,))
    return out[..., :n]


def process_chunked(
    filter_fn: Callable[[torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    chunk_size: int,
    padding: int,
    group: int = 0,
    progress: bool = False,
) -> torch.Tensor:
    """Apply ``filter_fn`` ((..., L) -> (..., L)) chunk-parallel over
    (..., n). Signals of at most ``chunk_size`` samples are still padded by
    ±``padding`` zeros and filtered whole (base.py:222 -> 144-150; SURVEY.md
    §5 quirk 6): the non-stationary IIR is global over frames. ``group`` >
    0 or ``progress``: ``filter_fn`` takes the chunks in groups of
    ``group`` (1 for 0; ``grouped_cores``)."""
    n = y.shape[-1]
    if n <= chunk_size:
        ypad = F.pad(y, (padding, padding))
        return filter_fn(ypad)[..., padding : padding + n]
    chunks = extract_chunks(y, chunk_size, padding)

    def cores(c):
        views = chunks if c is None else chunks[..., c[0] : c[0] + c[1], :]
        return filter_fn(views)[..., padding : padding + chunk_size]

    return grouped_cores(cores, y, chunk_size, group, progress)
