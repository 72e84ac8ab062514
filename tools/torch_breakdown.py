#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths on one CUDA card.

    python3 tools/torch_breakdown.py [--reps 3]
    python3 tools/torch_breakdown.py --ab parent=<checkout> --rounds 4 --no-training
    python3 tools/torch_breakdown.py --pieces 1,2,4,8,16 --cells headline --no-training
    python3 tools/torch_breakdown.py --h2d --cells none --no-training

For each cell (``--cells``, comma-separated, default all: the 960 s / 48
kHz headline, non-stationary, stationary with a 10 s noise clip and under
``use_torch=True``; a batch of 32 stationary 10 s clips; the bf16
headline; the headline with ``max_parallel_chunks=8``; the headline on a
mesh of ``(cuda:0,) * 2``), prints the host wall time of the call (numpy
in and out; minimum, median and maximum of ``--reps`` after a warm-up), then
one call split by ``chip_smoke.call_split``: the host's copy into pinned
memory (the time spent in ``HostSignal.copy_into``, the staged path's only
host copy; 0 where a tree has no staged path), the pieces (the launches of
kernel D), and from a ``torch.profiler`` trace the device's busy time and
share of the profiled wall (the union of its kernel and copy intervals),
the H2D, the kernels and the D2H (device time by operation kind), how long
kernels ran during an H2D and a D2H during a kernel, and the device time
of each kernel and copy by name. Then one
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
rounds (``COPY_PART_BYTES=1e15``: each row's run of a slab one part, so
one thread copies a mono signal).
``--pieces`` times the headline with at most that many pieces
(``transfer.MAX_PIECES``, the floor ``MIN_PIECE_SAMPLES`` taken away) over
slabs of each of ``--slabs`` MiB (``transfer.SLAB_BYTES``), staged by the
calling thread as each piece needs its slabs or by a second thread
(``--staging inline,thread``), the variants alternating over the rounds. ``--h2d`` measures the ways to bring
the headline's 184 MB to the card: the host's copy into a pinned ring
(torch's intra-op threads, one thread, numpy, numpy over the copy pool as
``HostSignal.copy_into`` runs it, and the intra-op threads from a second,
long-lived thread), the signal staged whole, the
caller's buffer registered in place (``cudaHostRegister``: registering,
the H2D, unregistering), one pageable copy and one pinned copy.

The inputs are ``chip_smoke.py``'s, made from its seed. Needs one card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import importlib
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
from noisereduce_tpu_torch.parallel import transfer  # noqa: E402

CELLS = ("headline", "stationary headline", "torch headline", "batch", "bf16 headline",
         "grouped headline", "mesh headline")


def walls(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def profiled(label: str, fn, kmod, tmod, card: str) -> dict:
    """``chip_smoke.call_split`` of one call, and its device ms by name."""
    split = cs.call_split(label, fn, kmod, tmod, card, reps=1)
    for name, ms in sorted(split["by_name"].items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:8.3f} ms  {name[:90]}", flush=True)
    return split


def _patched(fn, mod, settings: dict):
    """``fn`` run with the module's ``settings`` changed, then restored."""
    def run():
        saved = {k: getattr(mod, k) for k in settings}
        try:
            for k, v in settings.items():
                setattr(mod, k, v)
            return fn()
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
    return run


def cell_calls(pkg, x, noise, clips):
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


def h2d_ways(x: np.ndarray, card: str, rounds: int) -> None:
    """The ways to bring ``x`` (float32, mono) to the card, interleaved
    over ``rounds`` rounds after a warm-up: ms min / median / max."""
    dev = torch.device("cuda")
    nbytes = x.nbytes
    ring = [transfer._Slot(transfer.SLAB_BYTES) for _ in range(transfer.RING_SLABS)]
    width = transfer.slab_width(1, 4)
    src = torch.from_numpy(x)
    threads = torch.get_num_threads()

    def into_ring(n_threads):
        def run():
            torch.set_num_threads(n_threads)
            try:
                for i, a in enumerate(range(0, len(x), width)):
                    slot = ring[i % len(ring)]
                    b = min(len(x), a + width)
                    slot.buf[: (b - a) * 4].view(torch.float32).copy_(src[a:b])
            finally:
                torch.set_num_threads(threads)
        return run

    def numpy_into_ring():
        for i, a in enumerate(range(0, len(x), width)):
            b = min(len(x), a + width)
            np.copyto(ring[i % len(ring)].buf[: (b - a) * 4].view(torch.float32).numpy(), x[a:b])

    jobs, done = queue.SimpleQueue(), queue.SimpleQueue()

    def worker():
        while True:
            done.put(jobs.get()())

    threading.Thread(target=worker, daemon=True).start()

    def in_worker():
        jobs.put(into_ring(threads))
        done.get()

    def numpy_pool():
        hs = transfer.HostSignal(x[None], torch.float32)
        for i, a in enumerate(range(0, len(x), width)):
            b = min(len(x), a + width)
            hs.copy_into(ring[i % len(ring)].buf[: (b - a) * 4].view(torch.float32)[None], a, b)

    def staged():
        transfer.HostSignal(x[None], torch.float32).stage(dev).tensor()
        torch.cuda.synchronize()

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
        "host copy into the ring, numpy over the copy pool (HostSignal.copy_into)": numpy_pool,
        "host copy into the ring, intra-op threads, from a second thread": in_worker,
        "staged whole (the ring, H2D and events)": staged,
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
                for k, n in regs_before.items():
                    del regs[k][n:]
                if name.startswith("cudaHostRegister"):
                    regs.clear()
    times.update(regs)
    print(f"H2D ways for {nbytes / 1e6:.1f} MB (float32), {threads} intra-op threads, "
          f"{rounds} rounds, ms min / median / max, on {card}:", flush=True)
    for name, v in times.items():
        print(f"    {name}: {min(v):.2f} / {np.median(v):.2f} / {max(v):.2f} "
              f"({nbytes / min(v) / 1e6:.1f} GB/s at the min)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells, or none")
    ap.add_argument("--ab", default="", help="NAME=<checkout>: another tree in the same process")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--variants", default="",
                    help="comma-separated NAME=VALUE: this tree again with transfer.NAME "
                         "set, e.g. COPY_PART_BYTES=1e15")
    ap.add_argument("--pieces", default="", help="comma-separated MAX_PIECES to time")
    ap.add_argument("--slabs", default="4", help="--pieces: comma-separated slab MiB")
    ap.add_argument("--staging", default="inline",
                    help="--pieces: comma-separated inline (the calling thread) or thread")
    ap.add_argument("--h2d", action="store_true")
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
    cells = [c for c in args.cells.split(",") if c and c != "none"]
    if args.h2d:
        h2d_ways(x, card, args.rounds)
    trees = {"change": (nr, K, transfer)}
    for v in (v for v in args.variants.split(",") if v):  # this tree, a setting changed
        name, _, value = v.partition("=")
        trees[f"change, {v}"] = (nr, K, transfer, {name: int(float(value))})
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
        base = cell_calls(pkg, x, noise, clips)
        calls[t] = {c: _patched(fn, tm, patch[0]) if patch else fn for c, fn in base.items()}
    order = list(trees)
    for cell in cells:
        got = {t: [] for t in trees}
        for t in trees:  # warm-up
            calls[t][cell]()
        for r in range(args.rounds if len(trees) > 1 else 1):
            for t in (order if r % 2 == 0 else order[::-1]):
                got[t] += walls(calls[t][cell], args.reps)
        for t in trees:
            w = got[t]
            print(f"{cell} [{t}]: host wall ms min {min(w):.2f} median {np.median(w):.2f} "
                  f"max {max(w):.2f} over {len(w)} calls", flush=True)
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
