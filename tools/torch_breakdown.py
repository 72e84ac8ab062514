#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths on one CUDA card.

    python3 tools/torch_breakdown.py [--reps 3]
    python3 tools/torch_breakdown.py --ab parent=<checkout> --rounds 4 --no-training
    python3 tools/torch_breakdown.py --ab parent=<checkout> --variants RING=mapped
    python3 tools/torch_breakdown.py --ab parent=<checkout> --keep --no-training
    python3 tools/torch_breakdown.py --pieces 1,2,4,8,16 --cells headline --no-training
    python3 tools/torch_breakdown.py --h2d --keep --cells none --no-training

For each cell (``--cells``, comma-separated, default all: the 960 s / 48
kHz headline, non-stationary, stationary with a 10 s noise clip and under
``use_torch=True``; a batch of 32 stationary 10 s clips; the bf16
headline; the headline with ``max_parallel_chunks=8``; the headline as a
float64 caller sends it, ``chip_smoke.float64_signal``, and the batch cut
from it (32 float64 rows of 10 s); the headline as an int16, a float16 and
a uint8 caller send it, ``chip_smoke.int16_signal``, ``float16_signal`` and
``uint8_signal``, whose outputs kernel H narrows on the card; the headline
on a mesh of ``(cuda:0,) * 2``), prints the host wall time of the call (numpy
in and out; minimum, median and maximum of ``--reps`` after a warm-up), then
one call split by ``chip_smoke.call_split``: the host's copy into pinned
memory (the time spent in ``HostSignal.copy_into``, the staged path's only
host copy, and its GB/s; 0 where a tree has no staged path), the pieces
(the launches of kernel D), and from a ``torch.profiler`` trace the
device's busy time and share of the profiled wall (the union of its kernel
and copy intervals), the H2D, the kernels and the D2H (device time by
operation kind), how long kernels ran during an H2D and a D2H during a
kernel, and the device time of each kernel and copy by name. Then one
training step, forward and backward of mean(gate(x)**2), of ``TPUGate``,
``gate_nonstationary`` and ``gate_stationary`` at batch 16 and 256 of 4 s
at 16 kHz (``--no-training`` leaves them out).

``--ab NAME=<checkout>`` also runs another checkout's package (a parent
from ``git archive``) in the same process, copied under another name
beside this one, its kernels loaded from this tree's build (the sources
must be the same): the trees alternate over ``--rounds`` rounds (NAME,
this, this, NAME, ...), each cell's wall over all rounds, then one profiled
call of each. ``--variants NAME=VALUE,...`` adds this tree again with a
setting of ``parallel/transfer.py`` changed, as one more tree of the same
rounds (``COPY_THREADS=4``; ``RING=mapped``: the ring's slots mapped with
huge pages asked for, touched and ``cudaHostRegister``ed, ``MappedSlot``,
in place of torch's pinned ones).
``--pieces`` times the headline with at most that many pieces
(``transfer.MAX_PIECES``, the floor ``MIN_PIECE_SAMPLES`` taken away) over
slabs of each of ``--slabs`` MiB (``transfer.SLAB_BYTES``), staged by the
calling thread as each piece needs its slabs or by a second thread
(``--staging inline,thread``), the variants alternating over the rounds.
``--h2d`` prints the host facts (``host_copy.host_facts``: NUMA nodes and
CPUs, the card's node, the affinity, the huge page mode, the nodes holding
each ring's and the signal's pages) and measures the ways to bring the
headline's 184 MB to the card: the host's copy into a pinned ring (torch's
intra-op threads, one thread, numpy, numpy over 8 threads as
``HostSignal.copy_into`` ran it before the native copy, the intra-op
threads from a second, long-lived thread, and the native copy of
``host_copy``: unbound, bound to the card's node into a ring pinned there,
and into a mapped ring), every slab sent from a ring without the copy
(torch's pinned and the mapped), the signal staged whole (through either
ring), the caller's buffer registered whole (``cudaHostRegister``:
registering, the H2D, unregistering), one pageable copy and one pinned
copy. ``--keep`` times 8 headline calls that keep every result against 8
that drop each, for the float32, the float64 and the int16 headline, and
prints the pinned host memory held; then, for each tree, what
``api._finalize_reduce_output`` takes on the host once a call's copies
have ended (the output cast: float32, float64, int16, float16 and uint8
headline callers).

The inputs are ``chip_smoke.py``'s, made from its seed. Needs one card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import functools
import importlib
import json
import mmap
import pathlib
import queue
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import noisereduce_tpu_torch as nr  # noqa: E402
from noisereduce_tpu_torch.ops.cuda import kernels as K  # noqa: E402
from noisereduce_tpu_torch.parallel import host_copy, transfer  # noqa: E402

CELLS = ("headline", "stationary headline", "torch headline", "batch", "bf16 headline",
         "grouped headline", "float64 headline", "float64 batch", "int16 headline",
         "float16 headline", "uint8 headline", "mesh headline")


def walls(fn, reps: int, copies=None) -> list:
    """Host wall ms of ``reps`` calls; with ``copies`` (a list) and a
    transfer module's ``copy_into`` being timed (``copy_timer``), each
    call's host copy (ms, bytes) appended to it."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        COPY[:] = [0.0, 0]
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        if copies is not None:
            copies.append((COPY[0] * 1e3, COPY[1]))
    return out


COPY = [0.0, 0]  # seconds and bytes of the host copy in the current call


@contextlib.contextmanager
def copy_timer(tm):
    """``tm.HostSignal.copy_into`` timed into ``COPY`` (nothing for None)."""
    if tm is None:
        yield
        return
    copy_into = tm.HostSignal.copy_into

    def timed(self, dst, *a, **k):
        t0 = time.perf_counter()
        copy_into(self, dst, *a, **k)
        COPY[0] += time.perf_counter() - t0
        COPY[1] += dst.numel() * dst.element_size()

    tm.HostSignal.copy_into = timed
    try:
        yield
    finally:
        tm.HostSignal.copy_into = copy_into


def profiled(label: str, fn, kmod, tmod, card: str) -> dict:
    """``chip_smoke.call_split`` of one call, and its device ms by name."""
    split = cs.call_split(label, fn, kmod, tmod, card, reps=1)
    for name, ms in sorted(split["by_name"].items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:8.3f} ms  {name[:90]}", flush=True)
    return split


def _patched(fn, patches):
    """``fn`` run with each (object, attribute, value) of ``patches`` set,
    then restored."""
    def run():
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        try:
            for obj, name, value in patches:
                setattr(obj, name, value)
            return fn()
        finally:
            for obj, name, value in saved:
                setattr(obj, name, value)
    return run


def variant(v: str) -> list:
    """The patches of this tree's ``--variants`` entry ``NAME=VALUE``."""
    name, _, value = v.partition("=")
    if (name, value) == ("RING", "mapped"):
        return [(transfer, "_LOCAL", mapped_rings())]
    return [(transfer, name, int(float(value)))]


def cell_calls(pkg, x, noise, clips, x64, clips64, callers):
    """Each cell's call through the package ``pkg``."""
    from_mesh = importlib.import_module(f"{pkg.__name__}.parallel.mesh")
    ck = dict(chunk_size=cs.CHUNK, padding=cs.PADDING)
    mesh = from_mesh.ChunkMesh((torch.device("cuda", 0),) * 2)
    return {
        "headline": lambda: pkg.reduce_noise(x, cs.SR, **ck),
        "stationary headline": lambda: pkg.reduce_noise(x, cs.SR, stationary=True,
                                                        y_noise=noise, **ck),
        "torch headline": lambda: pkg.reduce_noise(x, cs.SR, use_torch=True, **ck),
        "batch": lambda: pkg.reduce_noise_batch(clips, cs.SR, stationary=True, **ck),
        "bf16 headline": lambda: pkg.reduce_noise(x, cs.SR, compute_dtype=torch.bfloat16, **ck),
        "grouped headline": lambda: pkg.reduce_noise(x, cs.SR,
                                                     max_parallel_chunks=cs.GROUP_CHUNKS, **ck),
        "float64 headline": lambda: pkg.reduce_noise(x64, cs.SR, **ck),
        "float64 batch": lambda: pkg.reduce_noise_batch(clips64, cs.SR, stationary=True, **ck),
        **{f"{k} headline": (lambda y=y: pkg.reduce_noise(y, cs.SR, **ck))
           for k, y in callers.items()},
        "mesh headline": lambda: pkg.reduce_noise(x, cs.SR, mesh=mesh, **ck),
    }


def load_checkout(name: str, root: pathlib.Path):
    """Another checkout's package, copied under the name ``nrt_<name>`` into
    a temporary directory, its imports renamed, its kernels from this tree's
    build directory (the same sources: the same hash)."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="nrt_ab_"))
    pkg = f"nrt_{name}"
    dst = tmp / pkg
    shutil.copytree(root / "noisereduce_tpu_torch", dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for f in dst.rglob("*.py"):
        f.write_text(f.read_text().replace("noisereduce_tpu_torch", pkg))
    from noisereduce_tpu_torch.ops.cuda import build

    build.load()
    (dst / "_build").symlink_to(build.BUILD_ROOT)
    sys.path.insert(0, str(tmp))
    mod = importlib.import_module(pkg)
    importlib.import_module(f"{pkg}.ops.cuda.build").load()
    return mod


def numpy_pool_copy(hs, dst: torch.Tensor, a: int, b: int, pool) -> None:
    """``HostSignal.copy_into`` before the native copy: numpy copies of
    parts of at least 2 MiB spread over a ``ThreadPoolExecutor``."""
    out, w = dst.numpy(), b - a
    step = max(1, (2 << 20) // dst.element_size(), -(-w * len(hs.rows) // 8))
    parts = [(r, s, min(w, s + step)) for r in range(len(hs.rows)) for s in range(0, w, step)]

    def copy(part):
        r, s, e = part
        np.copyto(out[r, s:e], hs.rows[r][a + s : a + e], casting="no")

    for _ in pool.map(copy, parts):
        pass


class MappedSlot:
    """A slot of the ring as the native copy's library once made it, set
    against torch's pinned slot (``transfer._Slot``) that replaced it:
    anonymous memory at a 2 MiB boundary with huge pages asked for
    (``madvise``, a hint), first touched by the calling thread, then
    registered with CUDA (``cudaHostRegister``); ``transfer._Slot``'s
    interface, for ``--h2d`` and the ``RING=mapped`` variant. Lives as long
    as the process."""

    HUGE = 2 << 20

    def __init__(self, nbytes: int, pool):
        self.pool, self.event = pool, None
        size = -(-nbytes // self.HUGE) * self.HUGE
        self._map = mmap.mmap(-1, size + self.HUGE)
        self._export = ctypes.c_char.from_buffer(self._map)  # the map stays open
        base = ctypes.addressof(self._export)
        at = -base % self.HUGE
        if hasattr(mmap, "MADV_HUGEPAGE"):
            self._map.madvise(mmap.MADV_HUGEPAGE, at, size)
        arr = np.frombuffer(self._map, np.uint8, size, at)
        arr[:: mmap.PAGESIZE] = 0  # first touch
        err = int(torch.cuda.cudart().cudaHostRegister(base + at, size, 0))
        if err:
            raise RuntimeError(f"cudaHostRegister of a {size}-byte slot: error {err}")
        self.buf = torch.from_numpy(arr)
        self.ptr, self.nbytes = base + at, size

    def take(self, nbytes: int) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        if self.nbytes < nbytes:
            raise ValueError(f"a mapped slot of {self.nbytes} bytes, {nbytes} asked for")
        return self.buf


@functools.cache
def mapped_rings() -> threading.local:
    """A ``transfer._LOCAL`` whose ring (this thread's, for the card's copy
    pool) is of ``MappedSlot``s: set in its place, a staged call copies into
    and sends from mapped and registered memory. Made once: its slots stay
    registered for the life of the process."""
    local = threading.local()
    pool = transfer._copy_pool(torch.device("cuda"))
    local.rings = {pool: [MappedSlot(transfer.SLAB_BYTES, pool)
                          for _ in range(transfer.RING_SLABS)]}
    return local


def h2d_ways(x: np.ndarray, card: str, rounds: int) -> None:
    """The ways to bring ``x`` (float32, mono) to the card, interleaved
    over ``rounds`` rounds after a warm-up: ms min / median / max, and the
    host facts the copy depends on."""
    from concurrent.futures import ThreadPoolExecutor

    dev = torch.device("cuda")
    nbytes = x.nbytes
    bound_pool = transfer._copy_pool(dev)
    free_pool = host_copy.pool(transfer.COPY_THREADS)
    mapped_local = mapped_rings()
    rings = {"bound": transfer._ring(dev),
             "unbound": [transfer._Slot(transfer.SLAB_BYTES, free_pool)
                         for _ in range(transfer.RING_SLABS)],
             "mapped": next(iter(mapped_local.rings.values()))}
    ring = rings["unbound"]
    width = transfer.slab_width(1, 4)
    src = torch.from_numpy(x)
    threads = torch.get_num_threads()
    facts = host_copy.host_facts(dev, {
        "bound ring": [(s.ptr, s.nbytes) for s in rings["bound"]],
        "unbound ring": [(s.ptr, s.nbytes) for s in rings["unbound"]],
        "mapped ring": [(s.ptr, s.nbytes) for s in rings["mapped"]],
        "signal": [(x.ctypes.data, nbytes)]})
    print(f"host: {json.dumps(facts)}; bound copy threads on CPUs "
          f"{host_copy._span_text(bound_pool.cpus) if bound_pool.cpus else 'none (unbound)'}",
          flush=True)

    def slabs():
        return enumerate((a, min(len(x), a + width)) for a in range(0, len(x), width))

    def into_ring(n_threads):
        def run():
            torch.set_num_threads(n_threads)
            try:
                for i, (a, b) in slabs():
                    ring[i % len(ring)].buf[: (b - a) * 4].view(torch.float32).copy_(src[a:b])
            finally:
                torch.set_num_threads(threads)
        return run

    def numpy_into_ring():
        for i, (a, b) in slabs():
            np.copyto(ring[i % len(ring)].buf[: (b - a) * 4].view(torch.float32).numpy(), x[a:b])

    jobs, done = queue.SimpleQueue(), queue.SimpleQueue()

    def worker():
        while True:
            done.put(jobs.get()())

    threading.Thread(target=worker, daemon=True).start()

    def in_worker():
        jobs.put(into_ring(threads))
        done.get()

    hs = transfer.HostSignal(x[None], torch.float32)
    executor = ThreadPoolExecutor(8, thread_name_prefix="numpy-copy")

    def numpy_pool():
        for i, (a, b) in slabs():
            dst = ring[i % len(ring)].buf[: (b - a) * 4].view(torch.float32)[None]
            numpy_pool_copy(hs, dst, a, b, executor)

    def native(which):
        slots = rings[which]
        pool = bound_pool if which == "bound" else free_pool

        def run():
            for i, (a, b) in slabs():
                hs.copy_into(slots[i % len(slots)].buf[: (b - a) * 4].view(torch.float32)[None],
                             a, b, pool=pool)
        return run

    def sent_from(which):
        """Every slab sent from its slot of the ring, as staged, without the
        host's copy: the H2D alone, 16 MiB a copy."""
        slots = rings[which]
        out = torch.empty(len(x), dtype=torch.float32, device=dev)

        def run():
            for i, (a, b) in slabs():
                out[a:b].copy_(slots[i % len(slots)].buf[: (b - a) * 4].view(torch.float32),
                               non_blocking=True)
            torch.cuda.synchronize()
        return run

    def staged():
        transfer.HostSignal(x[None], torch.float32).stage(dev).tensor()
        torch.cuda.synchronize()

    def staged_mapped():
        saved = transfer._LOCAL
        transfer._LOCAL = mapped_local
        try:
            staged()
        finally:
            transfer._LOCAL = saved

    cudart = torch.cuda.cudart()
    regs = {}

    def registered():
        t0 = time.perf_counter()
        err = cudart.cudaHostRegister(x.ctypes.data, nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister: {err}")
        t1 = time.perf_counter()
        out = src.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cudart.cudaHostUnregister(x.ctypes.data)
        t3 = time.perf_counter()
        regs.setdefault("register", []).append((t1 - t0) * 1e3)
        regs.setdefault("h2d from registered", []).append((t2 - t1) * 1e3)
        regs.setdefault("unregister", []).append((t3 - t2) * 1e3)
        del out

    pinned = torch.empty(len(x), dtype=torch.float32, pin_memory=True)
    pinned.copy_(src)
    ways = {
        "host copy into the ring, intra-op threads": into_ring(threads),
        "host copy into the ring, one thread": into_ring(1),
        "host copy into the ring, numpy": numpy_into_ring,
        "host copy into the ring, numpy over 8 threads (the copy before the native one)":
            numpy_pool,
        "host copy into the ring, intra-op threads, from a second thread": in_worker,
        "host copy into the ring, native, unbound (HostSignal.copy_into)": native("unbound"),
        "host copy into the bound ring, native, bound to the card's node": native("bound"),
        "host copy into the mapped ring, native, unbound": native("mapped"),
        "H2D of every slab from the ring, no host copy": sent_from("unbound"),
        "H2D of every slab from the mapped ring, no host copy": sent_from("mapped"),
        "staged whole (the ring, H2D and events)": staged,
        "staged whole through the mapped ring": staged_mapped,
        "cudaHostRegister, H2D, unregister": registered,
        "pageable .to(cuda)": lambda: src.to(dev),
        "pinned .to(cuda)": lambda: pinned.to(dev, non_blocking=True),
    }
    times = collections.defaultdict(list)
    for r in range(rounds + 1):
        for name, fn in ways.items():
            regs_before = {k: len(v) for k, v in regs.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if r:
                times[name].append((time.perf_counter() - t0) * 1e3)
            else:
                for k in list(regs):
                    del regs[k][regs_before.get(k, 0):]
    times.update(regs)
    executor.shutdown()
    print(f"H2D ways for {nbytes / 1e6:.1f} MB (float32), {threads} intra-op threads, "
          f"{rounds} rounds, ms min / median / max, on {card}:", flush=True)
    for name, v in times.items():
        print(f"    {name}: {min(v):.2f} / {np.median(v):.2f} / {max(v):.2f} "
              f"({nbytes / min(v) / 1e6:.1f} GB/s at the min)", flush=True)


def kept_outputs(x: np.ndarray, label: str, card: str, rounds: int, calls: int = 8) -> None:
    """A loop of ``calls`` calls on ``x`` (the ``label`` headline) that
    keeps every result against one that drops each before the next,
    interleaved over ``rounds`` rounds after a warm-up: ms per loop min /
    median, and the pinned host bytes held after a kept loop (torch's host
    allocator, which rounds a block up; ``allocated_bytes`` counts its
    cached blocks too), and the pinned bytes in use that each kept result
    adds (``active_bytes``, read before the loop once the allocator has
    taken back the blocks whose copies have ended)."""
    ck = dict(chunk_size=cs.CHUNK, padding=cs.PADDING)
    got = collections.defaultdict(list)
    held = {}
    stats = getattr(torch.cuda, "host_memory_stats", dict)
    for r in range(rounds + 1):
        for mode in (("drop", "keep") if r % 2 else ("keep", "drop")):
            kept = []
            torch.cuda.synchronize()
            torch.empty(1, pin_memory=True)  # an allocation takes back freed blocks
            before = stats().get("active_bytes.current", 0)
            t0 = time.perf_counter()
            for _ in range(calls):
                out = nr.reduce_noise(x, cs.SR, **ck)
                if mode == "keep":
                    kept.append(out)
                del out
            torch.cuda.synchronize()
            if r:
                got[mode].append((time.perf_counter() - t0) * 1e3)
            if mode == "keep":
                now = stats()
                held = {k: v for k, v in now.items()
                        if k.startswith(("allocated_bytes", "reserved_bytes", "active_bytes"))
                        and k.endswith(("current", "peak"))}
                if "active_bytes.current" in now:
                    held["active_bytes_per_kept_result"] = (
                        now["active_bytes.current"] - before) / calls
            del kept
    for mode, v in got.items():
        print(f"{calls} {label} calls, results {'kept' if mode == 'keep' else 'dropped'}: "
              f"ms min {min(v):.2f} median {np.median(v):.2f} over {len(v)} loops "
              f"({np.median(v) / calls:.2f} ms a call at the median), on {card}", flush=True)
    print(f"pinned host memory after a kept loop ({calls} {x.dtype} outputs of "
          f"{x.nbytes / 1e6:.1f} MB): {json.dumps(held) if held else 'not reported by this torch'}",
          flush=True)


def output_casts(trees: dict, callers: dict, card: str, rounds: int) -> None:
    """For each tree and each caller ({label: signal}), what
    ``api._finalize_reduce_output`` takes on the host once the call's
    copies have ended (``_reduce_noise_deferred``, then a synchronize, then
    the finalize timed alone): the output cast, if any (numpy's ``astype``
    of the float32 result where a tree does not give the caller's dtype on
    the card: a float64 caller's before the card's widening, an int16,
    float16 or uint8 caller's before kernel H; none where it does), over
    ``rounds`` rounds after a warm-up."""
    ck = dict(chunk_size=cs.CHUNK, padding=cs.PADDING)
    for t, (pkg, _km, _tm, *patches) in trees.items():
        api = importlib.import_module(f"{pkg.__name__}.api")
        for label, y in callers.items():
            def one():
                kw = dict(api._REDUCE_DEFAULTS, y=y, sr=cs.SR, **ck)
                kw.pop("tmp_folder")
                out, meta = api._reduce_noise_deferred(**kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                arr = api._finalize_reduce_output(out, *meta)
                ms = (time.perf_counter() - t0) * 1e3
                return ms, arr.dtype, bool(torch.from_numpy(arr).is_pinned())

            run = _patched(one, patches[0]) if patches else one
            got = [run() for _ in range(rounds + 1)]
            ms = [g[0] for g in got[1:]]
            print(f"output cast, {label} [{t}]: api._finalize_reduce_output after the copies "
                  f"ms min {min(ms):.2f} median {np.median(ms):.2f} max {max(ms):.2f} after a "
                  f"first {got[0][0]:.2f}; output {got[0][1]}, the call's pinned memory: "
                  f"{got[0][2]}; on {card}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells, or none")
    ap.add_argument("--ab", default="", help="NAME=<checkout>: another tree in the same process")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--variants", default="",
                    help="comma-separated NAME=VALUE: this tree again with transfer.NAME "
                         "set, e.g. COPY_PART_BYTES=1e15; RING=mapped: the ring's slots "
                         "mapped and registered (MappedSlot)")
    ap.add_argument("--pieces", default="", help="comma-separated MAX_PIECES to time")
    ap.add_argument("--slabs", default="4", help="--pieces: comma-separated slab MiB")
    ap.add_argument("--staging", default="inline",
                    help="--pieces: comma-separated inline (the calling thread) or thread")
    ap.add_argument("--h2d", action="store_true")
    ap.add_argument("--keep", action="store_true",
                    help="8 headline calls (float32, float64, int16) keeping every result "
                         "against dropping each; the output cast of each tree")
    ap.add_argument("--no-training", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs one CUDA card")
    card = cs.card_line()
    print(card, flush=True)
    x = cs.headline_signal(cs.HEADLINE_SECONDS)
    noise = cs.noise_clip(cs.NOISE_SECONDS)
    clips = [x[i * cs.BATCH_SECONDS * cs.SR : (i + 1) * cs.BATCH_SECONDS * cs.SR]
             for i in range(cs.BATCH_CLIPS)]
    x64 = cs.float64_signal(x)
    clips64 = [x64[i * cs.BATCH_SECONDS * cs.SR : (i + 1) * cs.BATCH_SECONDS * cs.SR]
               for i in range(cs.BATCH_CLIPS)]
    narrow = {"int16": cs.int16_signal(x), "float16": cs.float16_signal(x),
              "uint8": cs.uint8_signal(x)}
    cells = [c for c in args.cells.split(",") if c and c != "none"]
    if args.h2d:
        h2d_ways(x, card, args.rounds)
    trees = {"change": (nr, K, transfer)}
    for v in (v for v in args.variants.split(",") if v):  # this tree, a setting changed
        trees[f"change, {v}"] = (nr, K, transfer, variant(v))
    if args.ab:
        name, _, root = args.ab.rpartition("=")
        name = name or "parent"
        pkg = load_checkout(name, pathlib.Path(root).resolve())
        tm = None
        try:
            tm = importlib.import_module(f"{pkg.__name__}.parallel.transfer")
        except ImportError:
            pass  # a tree without the staged path: no host copy into pinned memory
        trees = {name: (pkg, importlib.import_module(f"{pkg.__name__}.ops.cuda.kernels"), tm),
                 **trees}
    calls = {}
    for t, (pkg, km, tm, *patch) in trees.items():
        base = cell_calls(pkg, x, noise, clips, x64, clips64, narrow)
        calls[t] = {c: _patched(fn, patch[0]) if patch else fn for c, fn in base.items()}
    if args.keep:
        kept_outputs(x, "headline", card, args.rounds)
        kept_outputs(x64, "float64 headline", card, args.rounds)
        kept_outputs(narrow["int16"], "int16 headline", card, args.rounds)
        output_casts(trees, {"float32 headline": x, "float64 headline": x64,
                             **{f"{k} headline": y for k, y in narrow.items()}}, card,
                     args.rounds)
    order = list(trees)
    for cell in cells:
        got = {t: [] for t in trees}
        copies = {t: [] for t in trees}
        for t in trees:  # warm-up
            calls[t][cell]()
        for r in range(args.rounds if len(trees) > 1 else 1):
            for t in (order if r % 2 == 0 else order[::-1]):
                with copy_timer(trees[t][2]):
                    got[t] += walls(calls[t][cell], args.reps, copies[t])
        for t in trees:
            w = got[t]
            ms = [c for c, _ in copies[t]]
            rate = copies[t][0][1] / np.median(ms) / 1e6 if np.median(ms) else 0.0
            print(f"{cell} [{t}]: host wall ms min {min(w):.2f} median {np.median(w):.2f} "
                  f"max {max(w):.2f} over {len(w)} calls; host copy ms min {min(ms):.2f} "
                  f"median {np.median(ms):.2f} max {max(ms):.2f} ({copies[t][0][1] / 1e6:.1f} MB, "
                  f"{rate:.2f} GB/s at the median)", flush=True)
        for t, (pkg, km, tm, *_) in trees.items():
            profiled(f"{cell} [{t}]", calls[t][cell], km, tm, card)
        torch.cuda.empty_cache()
    if args.pieces:
        pieces_sweep([int(p) for p in args.pieces.split(",")],
                     [int(m) for m in args.slabs.split(",")], args.staging.split(","), x, card,
                     args)
    if not args.no_training:
        training(args.reps)


class _Threaded:
    """The slabs sent by a second, long-lived thread instead of the calling
    thread (``--staging thread``): the first ``wait_slab`` of a signal
    hands all of its slabs to that thread, which sends them in order while
    the calling thread launches the kernels of those already sent. The
    design tried before the calling thread's own staging was kept."""

    def __init__(self):
        self.jobs = queue.SimpleQueue()
        threading.Thread(target=self._run, daemon=True).start()
        self.saved = None

    def _run(self):
        while True:
            sig = self.jobs.get()
            with torch.cuda.device(sig.device):
                for i in range(sig._n_slabs):
                    sig._stage_next()  # its slot from this thread's ring
                    with sig._cond:
                        sig._sent = i + 1
                        sig._cond.notify_all()

    def __enter__(self):
        S, jobs = transfer.StagedSignal, self.jobs
        self.saved = S.wait_slab

        def wait_slab(sig, i):
            if not hasattr(sig, "_cond"):
                sig._cond, sig._sent = threading.Condition(), 0
                jobs.put(sig)
            with sig._cond:
                while sig._sent <= i:
                    sig._cond.wait()
            torch.cuda.current_stream(sig.device).wait_event(sig._events[i])

        S.wait_slab = wait_slab
        return self

    def __exit__(self, *exc):
        transfer.StagedSignal.wait_slab = self.saved


def pieces_sweep(counts, slabs, modes, x, card, args) -> None:
    """The headline with at most ``p`` pieces for each p of ``counts``,
    slabs of ``m`` MiB for each m of ``slabs``, staged by the calling
    thread or by a second thread (``modes``: inline, thread), interleaved
    over the rounds: host wall ms min / median / max, then one profiled
    call each."""
    import contextlib

    ck = dict(chunk_size=cs.CHUNK, padding=cs.PADDING)
    saved = (transfer.MAX_PIECES, transfer.MIN_PIECE_SAMPLES, transfer.SLAB_BYTES)
    variants = [(p, m, mode) for mode in modes for m in slabs for p in counts]
    got = collections.defaultdict(list)

    threaded = _Threaded() if "thread" in modes else None

    def ctx(mode):
        return threaded if mode == "thread" else contextlib.nullcontext()

    try:
        transfer.MIN_PIECE_SAMPLES = 1
        for r in range(args.rounds + 1):
            for p, m, mode in (variants if r % 2 == 0 else variants[::-1]):
                transfer.MAX_PIECES, transfer.SLAB_BYTES = p, m << 20
                with ctx(mode):
                    w = walls(lambda: nr.reduce_noise(x, cs.SR, **ck), args.reps)
                if r:
                    got[p, m, mode] += w
        for p, m, mode in variants:
            transfer.MAX_PIECES, transfer.SLAB_BYTES = p, m << 20
            with ctx(mode):
                K.reset_launch_counts()
                nr.reduce_noise(x, cs.SR, **ck)
                pieces = K.launch_counts()["istft_ola"]
                w = got[p, m, mode]
                label = f"headline, {pieces} pieces, slabs of {m} MiB, staged {mode}"
                print(f"{label} (at most {p} pieces): host wall ms min {min(w):.2f} median "
                      f"{np.median(w):.2f} max {max(w):.2f} over {len(w)} calls, on {card}",
                      flush=True)
                profiled(label, lambda: nr.reduce_noise(x, cs.SR, **ck), K, transfer, card)
    finally:
        transfer.MAX_PIECES, transfer.MIN_PIECE_SAMPLES, transfer.SLAB_BYTES = saved


def training(reps: int) -> None:
    """One training step of each gate family, as ``chip_smoke.py``'s
    gradient phase runs it."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        gate_nonstationary, gate_stationary, stationary_noise_threshold,
    )

    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n = cs.GRAD_SR * cs.GRAD_SECONDS
    gate = nr.TPUGate(sr=cs.GRAD_SR, nonstationary=True)
    ncfg = nr.GateConfig(sr=cs.GRAD_SR)
    scfg = nr.GateConfig(sr=cs.GRAD_SR, stationary=True)
    noise = 0.8 * torch.randn(cs.NOISE_SECONDS * cs.GRAD_SR, generator=gen, device="cuda")
    thr = stationary_noise_threshold(noise, scfg)
    families = (("TPUGate", gate), ("gate_nonstationary", lambda a: gate_nonstationary(a, ncfg)),
                ("gate_stationary", lambda a: gate_stationary(a, thr, scfg)))
    for batch in cs.GRAD_BATCHES:
        x = torch.randn((batch, n), generator=gen, device="cuda").requires_grad_()
        for name, fn in families:
            def step():
                x.grad = None
                (fn(x) ** 2).mean().backward()

            label = f"training step {name} (batch {batch} x {cs.GRAD_SECONDS} s)"
            step()
            w = walls(step, reps)
            print(f"{label}: host wall min {min(w):.1f} ms", flush=True)
            profiled(label, step, K, None, card)


if __name__ == "__main__":
    main()
