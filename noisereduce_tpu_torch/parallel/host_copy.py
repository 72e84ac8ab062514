"""The host's copy of a signal's slab into pinned memory, and the host
facts it depends on.

``native/nrcopy.cpp`` is built by ``utils/io.py::build_library`` with
``g++`` at first use into ``_build/<hash>/libnrcopy.so`` and called through
ctypes, which releases the GIL for the copy. A ``CopyPool`` is a
persistent pool of native threads: ``copy`` spreads every row's samples
[a, b) of a strided source over them in parts, with non-temporal stores
where the destination is 16-byte aligned, and casts float64 to float32 in
the same pass (round to nearest even: bitwise the card's cast, NaN
payloads aside). ``pool(cpus)`` gives one pool a set of CPUs (``None``:
unbound) for this process.

The card's NUMA node and its CPUs are read from ``/sys``
(``card_node``, ``node_cpus``); ``host_facts`` adds the process's
affinity, the transparent huge page mode and the nodes that hold given
ranges of memory (``/proc/self/numa_maps``). Only reads: the module
changes no setting of the machine, and binds only its own threads.

Nothing falls back: where ``g++`` fails the first copy raises with its
error.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import threading

import numpy as np
import torch

from noisereduce_tpu_torch.utils.io import CXX_FLAGS, build_library

__all__ = [
    "SOURCE",
    "CopyPool",
    "pool",
    "on_cpus",
    "numa_nodes",
    "card_node",
    "node_cpus",
    "pages_by_node",
    "host_facts",
]

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "nrcopy.cpp"
FLAGS = [*CXX_FLAGS, "-pthread"]

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """``libnrcopy.so``, built on first call; raises ``RuntimeError`` with
    the compiler's error where it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SOURCE, FLAGS)))
            vp, i32, i64, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
            lib.nrc_pool_new.argtypes, lib.nrc_pool_new.restype = [i32], vp
            lib.nrc_pool_bind.argtypes = [vp, ctypes.POINTER(ctypes.c_int), i32]
            lib.nrc_pool_bind.restype = i32
            lib.nrc_copy.argtypes = [vp, i32, i64p, i64p, i32, i32, vp, i64, i64, i64]
            lib.nrc_copy.restype = i32
            _lib = lib
        return _lib


class CopyPool:
    """A persistent pool of ``threads`` native threads, bound to ``cpus``
    (a collection of CPU ids) or free to run anywhere (``None``), that
    lives as long as the process."""

    def __init__(self, threads: int, cpus=None):
        self._lib = library()
        self.handle = self._lib.nrc_pool_new(threads)
        if not self.handle:
            raise RuntimeError(f"nrcopy: cannot start {threads} threads")
        self.threads = threads
        self.cpus = None if cpus is None else tuple(sorted(cpus))
        if self.cpus is not None:
            arr = (ctypes.c_int * len(self.cpus))(*self.cpus)
            rc = self._lib.nrc_pool_bind(self.handle, arr, len(self.cpus))
            if rc:
                raise OSError(rc, f"nrcopy: binding the copy threads to CPUs {self.cpus}: "
                                  f"{os.strerror(rc)}")

    def copy(self, src: np.ndarray, stride: np.ndarray, src_size: int, dst_ptr: int,
             dst_row: int, dst_size: int, w: int, step: int) -> None:
        """Row r's ``w`` samples from address ``src[r]``, ``stride[r]`` bytes
        apart, into ``dst_ptr + r * dst_row``, in parts of at most ``step``
        samples: the same bytes, or float64 (``src_size`` 8) into float32
        (``dst_size`` 4); non-temporal stores where the destination is
        16-byte aligned."""
        src = np.ascontiguousarray(src, dtype=np.int64)
        stride = np.ascontiguousarray(stride, dtype=np.int64)
        rc = self._lib.nrc_copy(self.handle, len(src), src.ctypes.data, stride.ctypes.data,
                                src_size, dst_size, dst_ptr, dst_row, w, step)
        if rc:
            raise ValueError(f"nrcopy: no copy of {src_size}-byte samples into "
                             f"{dst_size}-byte ones")


_POOLS: dict = {}
_POOLS_LOCK = threading.Lock()


def pool(threads: int, cpus=None) -> CopyPool:
    """This process's pool of ``threads`` threads bound to ``cpus`` (or
    unbound), made at first use; a forked child makes its own."""
    key = (os.getpid(), threads, None if cpus is None else tuple(sorted(cpus)))
    with _POOLS_LOCK:
        if key not in _POOLS:
            _POOLS[key] = CopyPool(threads, cpus)
        return _POOLS[key]


def on_cpus(cpus, fn):
    """``fn()`` with the calling thread bound to ``cpus`` for the call and
    its CPUs given back after, so that pages it touches first lie on their
    NUMA node (``None``: as the thread is)."""
    if cpus is None:
        return fn()
    saved = os.sched_getaffinity(0)  # 0: this thread, not the process
    os.sched_setaffinity(0, cpus)
    try:
        return fn()
    finally:
        os.sched_setaffinity(0, saved)


def _cpu_list(text: str) -> list:
    """CPU ids of a sysfs list such as ``0-3,8-11``."""
    out = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def numa_nodes() -> dict:
    """{node: [CPU ids]} from ``/sys/devices/system/node``; {} where the
    host does not say."""
    root = pathlib.Path("/sys/devices/system/node")
    nodes = {}
    for d in sorted(root.glob("node[0-9]*")):
        try:
            nodes[int(d.name[4:])] = _cpu_list((d / "cpulist").read_text())
        except (OSError, ValueError):
            continue
    return nodes


def _pci_address(device: torch.device):
    """The card's PCI address as sysfs names it, or None."""
    props = torch.cuda.get_device_properties(device)
    parts = [getattr(props, k, None) for k in ("pci_domain_id", "pci_bus_id", "pci_device_id")]
    if any(p is None for p in parts):
        return None
    domain, bus, dev = parts
    return f"{domain:04x}:{bus:02x}:{dev:02x}.0"


def card_node(device: torch.device):
    """The NUMA node of the card ``device`` (its PCI device's
    ``numa_node``), or None where the host gives none (-1) or no address."""
    addr = _pci_address(device)
    if addr is None:
        return None
    try:
        node = int(pathlib.Path(f"/sys/bus/pci/devices/{addr}/numa_node").read_text())
    except (OSError, ValueError):
        return None
    return node if node >= 0 else None


def node_cpus(device: torch.device):
    """The CPUs of the card's node that this process may run on, or None
    (no node, or none of its CPUs allowed)."""
    node = card_node(device)
    if node is None:
        return None
    cpus = set(numa_nodes().get(node, ())) & os.sched_getaffinity(0)
    return sorted(cpus) or None


def _vmas():
    """[(start, end, {node: pages})] of this process, from
    ``/proc/self/maps`` and ``/proc/self/numa_maps`` (the same mappings in
    the same order)."""
    spans = {}
    with open("/proc/self/maps") as fh:
        for line in fh:
            lo, _, hi = line.split(None, 1)[0].partition("-")
            spans[int(lo, 16)] = int(hi, 16)
    out = []
    with open("/proc/self/numa_maps") as fh:
        for line in fh:
            fields = line.split()
            start = int(fields[0], 16)
            nodes = {}
            for f in fields[2:]:
                if f[0] == "N" and "=" in f and f[1:f.index("=")].isdigit():
                    nodes[int(f[1:f.index("=")])] = int(f[f.index("=") + 1:])
            out.append((start, spans.get(start, start), nodes))
    return out


def pages_by_node(ranges) -> dict:
    """{node: pages} of the mappings that hold any of ``ranges``, a list of
    (address, bytes), each mapping counted once (whole mappings:
    ``numa_maps`` counts by mapping); {} where the host has no
    ``numa_maps``."""
    try:
        vmas = _vmas()
    except OSError:
        return {}
    got: dict = {}
    for start, end, nodes in vmas:
        if any(start < ptr + n and ptr < end for ptr, n in ranges):
            for node, k in nodes.items():
                got[node] = got.get(node, 0) + k
    return got


def host_facts(device: torch.device, ranges=None) -> dict:
    """What the host copy depends on: the NUMA nodes and their CPUs, the
    card's node, the process's affinity, the transparent huge page mode,
    and the nodes holding each of ``ranges`` ({name: [(address, bytes)]})."""
    try:
        thp = pathlib.Path("/sys/kernel/mm/transparent_hugepage/enabled").read_text().strip()
    except OSError:
        thp = None
    affinity = sorted(os.sched_getaffinity(0))
    return {
        "nodes": {n: _span_text(c) for n, c in numa_nodes().items()},
        "card_node": card_node(device),
        "copy_cpus": _span_text(node_cpus(device) or []),
        "affinity": _span_text(affinity),
        "thp": thp,
        "pages_by_node": {k: pages_by_node(v) for k, v in (ranges or {}).items()},
    }


def _span_text(cpus) -> str:
    """CPU ids as a sysfs list: [0, 1, 2, 5] -> ``0-2,5``."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)
