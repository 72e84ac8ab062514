"""Chunk meshes: the devices a long signal's chunks are sharded over
(counterpart of ``noisereduce_tpu/parallel/mesh.py``).

The reference scales out with a joblib process pool on one machine
(spectralgate/base.py:206-216). Here:

* one device: the chunk axis is a batch axis of one launch of each kernel
  (``parallel.chunking``);
* several devices of one host: ``chunk_mesh()`` + ``reduce_noise(...,
  mesh=...)`` give each device a contiguous range of the chunks, which it
  gates from its own slice of the signal with its halos (halo recompute:
  no collectives; the stationary threshold is the one operand every device
  receives, ``parallel.chunking.shard_cores``);
* several processes: ``distributed_chunks`` places one process's chunk
  block over the mesh's devices. Processes never communicate (each gates
  its own chunks), and nothing here starts or joins a process group: a
  multi-process run has not been measured.

A ``ChunkMesh`` may name one device more than once: ``ChunkMesh((cpu,) *
8)`` stands for eight devices in the CPU tests, as the JAX tests' eight
fake CPU devices do, and ``(cuda:0,) * 4`` runs four shards one after
another on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["ChunkMesh", "chunk_mesh", "distributed_chunks"]


@dataclass(frozen=True)
class ChunkMesh:
    """An ordered tuple of ``torch.device``s along one named axis, read as
    ``jax.sharding.Mesh`` is: ``axis_names`` and ``shape[axis_name]``."""

    devices: tuple
    axis_name: str = "chunks"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("ChunkMesh: no devices")
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}


def chunk_mesh(n_devices: Optional[int] = None, axis_name: str = "chunks") -> ChunkMesh:
    """A 1-D mesh over the first ``n_devices`` visible CUDA devices (all of
    them for None). Raises where CUDA is absent, as ``device="cuda"``
    does: it never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "chunk_mesh: CUDA is not available; build a ChunkMesh of CPU devices "
            "to run the plain versions"
        )
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return ChunkMesh(tuple(devs), axis_name)


def distributed_chunks(local_chunks, mesh: ChunkMesh, axis_name: str = "chunks") -> tuple:
    """Place this process's (channels, local_n_chunks, view) block of
    halo'd chunks over the mesh's devices: a tuple of blocks, device d's
    the contiguous range of chunks that ``chunking.mesh_ranges`` gives it,
    each on its device (devices left without chunks get none).
    ``chunking.shard_filter`` takes the tuple as it takes one tensor of
    chunks.

    The halos must come from the source signal (zero fill only at the true
    recording edges) to match the reference's chunk reads
    (base.py:130-148): cut a recording's segments with ``padding``
    overlap. Single-process meaning only: the processes of a multi-process
    run each place and gate their own block; nothing is exchanged."""
    from noisereduce_tpu_torch.parallel.chunking import mesh_ranges

    local = torch.as_tensor(local_chunks)
    return tuple(
        local[..., first : first + k, :].to(dev)
        for dev, first, k in mesh_ranges(local.shape[-2], mesh, axis_name)
    )
