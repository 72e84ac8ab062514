"""PyTorch port: the staged host-to-card transfer and the pieces of the
chunked body (``parallel/transfer.py``, ``parallel/chunking.py::
staged_pieces``), without a card.

- ``transfer_plan`` (hypothesis over the signal's length, the chunk size,
  the padding, a mesh slice, the slab width and the piece size, with
  signals of at most one chunk, a last chunk of one sample and no padding
  among them): each chunk lies in exactly one piece, every sample a
  piece's views read lies at or before the end of the slab it waits for,
  and the slabs cover the source exactly once, in order.
- ``piece_chunks``: at most ``MAX_PIECES`` pieces, none below
  ``MIN_PIECE_SAMPLES`` but a whole signal's, and the headline's 4.
- The piece loop on the CPU: ``staged_pieces`` over a stand-in for the
  staged signal whose samples are NaN until the slab that holds them is
  waited for. Every engine's output is bitwise the one-call output and
  within 1e-9 x max|ref| of the JAX package's ``reduce_noise`` in float64
  (1e-8 for the torch engine), so no piece read a sample before its slab.
- ``HostSignal``: rows read straight from strided, transposed,
  negative-stride and read-only arrays and from lists of rows, in their
  own dtype, whole or in parts over the copy pool, equal to the host copy
  the CPU path makes.
- A float64 caller's output: ``HostSignal.out_dtype`` (float64 for
  float64 rows, whatever the compute dtype; int16 and float16 rows their
  own, float32 rows float32; ``tests/test_torch_output_cast.py`` has the
  rule for every dtype);
  ``staged_pieces`` into a float64 stand-in for ``PinnedCores``, bitwise
  the float32 output widened and within 5e-5 x max|ref| of the JAX
  package's ``reduce_noise`` on the float64 input; a CPU mesh's chunked
  body of a host signal (``process_chunked``, ``shard_cores``) in its
  ``out_dtype``; ``_finalize_reduce_output`` returning a float64 (or
  float32) host tensor's own memory, flat and 2-D, and casting other
  callers' dtypes with numpy.
- ``reduce_noise(..., device="cpu")`` (every engine, a CPU mesh, a batch,
  float64 callers) makes no pinned tensor, no stream and no event, and
  stages nothing.
- The native copy (``parallel/host_copy.py`` over ``native/nrcopy.cpp``)
  against ``np.copyto`` and numpy's ``astype``, bitwise: contiguous,
  strided, reversed, transposed and list-of-rows sources; int16, float32
  and float64, with NaN, +-inf, subnormals, -0.0, ties and overflow
  (float64 into float32 bitwise numpy's cast); slab edges and destination
  rows off 16-byte boundaries and on them; one part and many parts; a
  pool bound to this process's CPUs and a slot allocated on them; the
  card's copy pool bound to its node's CPUs (the node faked); several
  threads sharing the pool. Which dtype a slab crosses in
  (``wire_dtype``): a float64 signal headed for bfloat16 is not cast on
  the host. The host facts (``/sys`` and ``/proc/self/numa_maps``, read
  only).

The card side (the copy streams, the events, the pinned ring and output)
is held by ``tests/test_torch_cuda.py`` (marker ``gpu``).
"""
import os
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import noisereduce_tpu as jnr

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.api import _to_tensor
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.ops.cuda.dispatch import _gate_from_signal
from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _tpugate_from_signal
from noisereduce_tpu_torch.parallel import host_copy, transfer
from noisereduce_tpu_torch.parallel.chunking import n_chunks_for, staged_pieces
from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

torch.set_num_threads(2)

SR, CHUNK, PADDING, N = 16000, 4000, 1000, 21200  # 5.3 chunks


@st.composite
def _plans(draw):
    chunk = draw(st.integers(1, 64))
    n = draw(st.one_of(st.integers(1, chunk), st.integers(1, 40 * chunk),
                       st.just(3 * chunk + 1)))  # at most one chunk; a last chunk of one sample
    padding = draw(st.one_of(st.just(0), st.integers(0, 3 * chunk)))
    n_chunks = n_chunks_for(n, chunk)
    # a mesh device's range of chunks and the slice it receives
    first = draw(st.integers(0, n_chunks - 1))
    count = draw(st.integers(1, n_chunks - first))
    lo = max(0, first * chunk - padding)
    hi = min(n, (first + count) * chunk + padding)
    width = draw(st.integers(1, max(1, hi - lo + 3)))
    piece = draw(st.integers(1, count + 2))
    return n, chunk, padding, first, count, lo, hi, width, piece


@settings(max_examples=400, deadline=None)
@given(_plans())
def test_plan_covers_every_chunk_and_sample_once(plan):
    n, chunk, padding, first, count, lo, hi, width, piece = plan
    slabs, pieces = transfer.transfer_plan(hi - lo, chunk, padding, first, count, piece,
                                           width, lo)
    # the slabs cover [0, hi - lo) exactly once, in order
    covered = np.zeros(hi - lo, int)
    for a, b in slabs:
        assert 0 <= a < b <= hi - lo
        covered[a:b] += 1
    assert (covered == 1).all()
    assert [a for a, _ in slabs] == sorted(a for a, _ in slabs)
    # each chunk in exactly one piece
    seen = [c for c0, k, _ in pieces for c in range(c0, c0 + k)]
    assert sorted(seen) == list(range(first, first + count))
    for c0, k, slab in pieces:
        assert 0 <= slab < len(slabs)
        # the samples the piece's views read, [c0*cs - padding, (c0+k)*cs +
        # padding) cut to the signal, lie in the slice and end at or before
        # the end of the slab the piece waits for
        first_read = max(0, c0 * chunk - padding) - lo
        last_read = min(n, (c0 + k) * chunk + padding) - 1 - lo
        assert 0 <= first_read <= last_read < hi - lo
        assert last_read < slabs[slab][1]
        # and the slab is the first that reaches it: nothing waits longer
        assert slab == 0 or slabs[slab - 1][1] <= last_read


@pytest.mark.parametrize("n_chunks,chunk,rows,pieces", [
    (77, 600000, 1, 4),   # the headline: 4 pieces of 20 chunks
    (77, 600000, 2, 4),
    (6, 4000, 2, 1),      # a short signal: one piece
    (1, 600000, 1, 1),
    (5, 600000, 1, 1),    # 60 s at 48 kHz: 3.0M samples, below one piece's floor
    (20, 600000, 1, 3),   # a mesh device's 20 of the headline's chunks
    (39, 600000, 1, 4),   # the other device's 39 of a mesh of two
    (400, 100000, 1, 4),
])
def test_piece_rule(n_chunks, chunk, rows, pieces):
    k = transfer.piece_chunks(n_chunks, chunk, rows)
    assert -(-n_chunks // k) == pieces
    assert -(-n_chunks // k) <= transfer.MAX_PIECES
    assert k == n_chunks or k * chunk * rows >= transfer.MIN_PIECE_SAMPLES


class _ArrivingSignal:
    """A stand-in for ``StagedSignal`` on the CPU: ``buffer`` is NaN until
    ``wait_slab`` sends the slabs through the asked-for one."""

    def __init__(self, y: torch.Tensor, width: int):
        self.shape, self.start = tuple(y.shape), 0
        self.source, self.width = y, width
        self.buffer = torch.full_like(y, float("nan"))
        self.waits = []

    def wait_slab(self, i):
        self.waits.append(i)
        b = min(self.shape[1], (i + 1) * self.width)
        self.buffer[:, :b] = self.source[:, :b]


class _HostOut:
    def __init__(self, rows, n, dtype):
        self.host = torch.full((rows, n), float("nan"), dtype=dtype)

    def put(self, a, cores):
        b = min(self.host.shape[1], a + cores.shape[1])
        self.host[:, a:b] = cores[:, : b - a]


ENGINES = {
    "nonstationary": dict(),
    "stationary": dict(stationary=True),
    "torch": dict(use_torch=True),
    "torch-stationary": dict(use_torch=True, stationary=True),
}


@pytest.mark.parametrize("width", [700, 4001, 30000])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("group", [0, 1, 2])
def test_pieces_read_only_arrived_samples(engine, group, width, monkeypatch):
    """``staged_pieces`` in pieces of 1 (the rule forced), 1 and 2 chunks
    over a signal whose slabs arrive only when waited for: bitwise the
    one-call output of the same core function, and the JAX package's
    output within 1e-9 (1e-8 torch) x max|ref| in float64."""
    monkeypatch.setattr(transfer, "MIN_PIECE_SAMPLES", 1)
    monkeypatch.setattr(transfer, "MAX_PIECES", 16)
    kw = ENGINES[engine]
    y = np.random.default_rng(40).standard_normal((2, N))
    yt = torch.as_tensor(y)
    if kw.get("use_torch"):
        # no clip: the stationary gate takes each view's own statistics
        gate = nrt.api.torch_gate_for(SR, stationary=kw.get("stationary", False))

        def core(x, chunks):
            return _tpugate_from_signal(x, gate, None, CHUNK, PADDING, chunks=chunks)
    else:
        cfg = GateConfig(sr=SR, **kw)
        thr = None
        if kw.get("stationary"):
            from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold

            thr = stationary_noise_threshold(yt.mean(dim=0)[:CHUNK], cfg)

        def core(x, chunks):
            return _gate_from_signal(x, cfg, CHUNK, PADDING, thr, chunks)

    whole = core(yt, None).reshape(2, -1)[:, :N]
    sig = _ArrivingSignal(yt, width)
    out = _HostOut(2, N, yt.dtype)
    staged_pieces(lambda c: core(sig.buffer, c), sig, CHUNK, PADDING, 0,
                  n_chunks_for(N, CHUNK), group, False, out)
    assert torch.equal(out.host, whole)
    assert sig.waits == sorted(sig.waits) and sig.waits[-1] == (N - 1) // width
    ref = jnr.reduce_noise(y, SR, chunk_size=CHUNK, padding=PADDING, **kw)
    tol = 1e-8 if kw.get("use_torch") else 1e-9
    assert np.abs(out.host.numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("rows", [np.float64, np.float32, np.int16, np.float16])
def test_output_dtype_rule(rows, compute):
    """A host signal's output comes back float64 for float64 rows (widened
    on the card: exact), in the rows' own dtype for int16 and float16 rows
    (narrowed on the card by kernel H, numpy's cast; float64 under the
    float64 parity mode, whose output numpy casts) and float32 for float32
    rows."""
    hs = transfer.HostSignal(np.zeros((2, 10), dtype=rows), compute)
    want = {np.float64: torch.float64, np.float32: torch.float32, np.int16: torch.int16,
            np.float16: torch.float16}[rows]
    if compute == torch.float64 and rows in (np.int16, np.float16):
        want = torch.float64
    assert hs.out_dtype == want


@pytest.mark.parametrize("group", [0, 2])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_float64_output_is_the_float32_output_widened(engine, group, monkeypatch):
    """A float64 caller's staged signal gated in float32 (its rows cross as
    float32) into a stand-in for ``PinnedCores`` in the signal's
    ``out_dtype``: float64, bitwise the float32 one-call output widened, and
    within 5e-5 x max|ref| of the JAX package's ``reduce_noise`` on the same
    float64 input."""
    monkeypatch.setattr(transfer, "MIN_PIECE_SAMPLES", 1)
    kw = ENGINES[engine]
    y = np.random.default_rng(44).standard_normal((2, N))
    hs = transfer.HostSignal(y, torch.float32)
    assert hs.wire_dtype == torch.float32 and hs.out_dtype == torch.float64
    yt = hs.tensor()
    if kw.get("use_torch"):
        gate = nrt.api.torch_gate_for(SR, stationary=kw.get("stationary", False))

        def core(x, chunks):
            return _tpugate_from_signal(x, gate, None, CHUNK, PADDING, chunks=chunks)
    else:
        cfg = GateConfig(sr=SR, **kw)
        thr = None
        if kw.get("stationary"):
            from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold

            thr = stationary_noise_threshold(yt.mean(dim=0)[:CHUNK], cfg)

        def core(x, chunks):
            return _gate_from_signal(x, cfg, CHUNK, PADDING, thr, chunks)

    whole = core(yt, None).reshape(2, -1)[:, :N]
    assert whole.dtype == torch.float32
    sig = _ArrivingSignal(yt, 4001)
    out = _HostOut(2, N, hs.out_dtype)
    staged_pieces(lambda c: core(sig.buffer, c), sig, CHUNK, PADDING, 0,
                  n_chunks_for(N, CHUNK), group, False, out)
    assert out.host.dtype == torch.float64 and torch.equal(out.host, whole.double())
    ref = jnr.reduce_noise(y, SR, chunk_size=CHUNK, padding=PADDING, **kw)
    assert ref.dtype == np.float64
    assert np.abs(out.host.numpy() - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n", [N, 3000], ids=["chunks", "one-chunk"])
def test_mesh_of_a_host_signal_returns_its_out_dtype(n):
    """``process_chunked`` of a float64 host signal over a CPU mesh (the
    path a card mesh takes for the staged twins' geometry, and for a signal
    of one chunk): float64, bitwise the float32 signal's output widened."""
    from noisereduce_tpu_torch.models.spectral_gate import gate_nonstationary
    from noisereduce_tpu_torch.parallel.chunking import process_chunked

    cfg = GateConfig(sr=SR, hop_length=300)
    y = np.random.default_rng(45).standard_normal((2, n))
    mesh = ChunkMesh((torch.device("cpu"),) * 2)

    def run(sig):
        return process_chunked(lambda c: gate_nonstationary(c, cfg), sig, CHUNK, PADDING,
                               mesh=mesh)

    got = run(transfer.HostSignal(y, torch.float32))
    want = run(torch.as_tensor(y.astype(np.float32)))
    assert got.dtype == torch.float64 and want.dtype == torch.float32
    assert torch.equal(got, want.double())
    assert run(transfer.HostSignal(y.astype(np.float32), torch.float32)).dtype == torch.float32


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "2-D"])
@pytest.mark.parametrize("case", ["float64", "float32", "int16 caller", "float16 caller",
                                  "bfloat16 output"])
def test_finalize_keeps_the_host_tensor(case, flat):
    """``_finalize_reduce_output`` of a host tensor: a float64 caller's
    float64 output (and a float32 caller's float32 one) is returned as that
    tensor's own memory, flat and 2-D; an int16 or float16 caller's is
    numpy's cast; a bfloat16 output is widened to float32 first."""
    from noisereduce_tpu_torch.api import _finalize_reduce_output

    t = torch.as_tensor(np.random.default_rng(46).standard_normal((1 if flat else 2, 700)) * 9)
    dtype, caller = {"float64": (torch.float64, np.float64),
                     "float32": (torch.float32, np.float32),
                     "int16 caller": (torch.float32, np.int16),
                     "float16 caller": (torch.float32, np.float16),
                     "bfloat16 output": (torch.bfloat16, np.float64)}[case]
    t = t.to(dtype)
    arr = _finalize_reduce_output(t, np.dtype(caller), flat)
    assert arr.dtype == caller and arr.shape == ((700,) if flat else (2, 700))
    host = t.float() if dtype == torch.bfloat16 else t
    want = host.numpy().astype(caller).reshape(arr.shape)
    assert np.array_equal(arr, want)
    own = (t.view(torch.int16) if dtype == torch.bfloat16 else t).numpy()
    assert np.shares_memory(arr, own) == (case in ("float64", "float32"))


def _caller(name):
    """2 s at 16 kHz (a tone over noise, from a seed) as a caller of each
    dtype sends it: float16, int32 (a peak near 2e6), int16 (3000), uint8
    (8-bit PCM around 128), float64 stereo (2, n), and a list of 5,000
    float32 samples."""
    rng = np.random.default_rng(47)
    t = np.arange(2 * SR) / SR
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.3 * rng.standard_normal(len(t))
    return {
        "float16": x.astype(np.float16),
        "int32": np.round(x * 1e6).astype(np.int32),
        "int16": np.round(x * 3000).astype(np.int16),
        "uint8": np.clip(np.round(128 + 40 * x), 0, 255).astype(np.uint8),
        "float64 stereo": np.stack([x, x[::-1].copy()]),
        "float32 list": list(x[:5000].astype(np.float32)),
    }[name]


CALLERS = ["float16", "int32", "int16", "uint8", "float64 stereo", "float32 list"]


@pytest.mark.parametrize("engine", ["nonstationary", "stationary", "torch"])
@pytest.mark.parametrize("name", CALLERS)
def test_caller_dtypes_match_the_jax_package(name, engine):
    """Each caller's dtype on each engine on the CPU (the 18 calls of
    ROADMAP Queue 3): the JAX package's dtype and shape; an integer or
    float16 output within one step of its type of the JAX package's (the
    two float32 outputs round to either side of a step), plus 1e-6 x
    max|ref|; a float output within 1e-6 x max|ref|."""
    y = _caller(name)
    kw = ENGINES[engine]
    got = nrt.reduce_noise(y, SR, device="cpu", **kw)
    ref = jnr.reduce_noise(y, SR, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.dtype == np.asarray(y).dtype
    g, r = got.astype(np.float64), ref.astype(np.float64)
    if np.issubdtype(ref.dtype, np.integer):
        step = 1.0
    elif ref.dtype == np.float16:
        step = np.spacing(np.abs(ref)).astype(np.float64)
    else:
        step = 0.0
    assert (np.abs(g - r) <= step + 1e-6 * np.abs(r).max()).all()


def _strided_inputs():
    rng = np.random.default_rng(41)
    base = rng.standard_normal((N, 2))
    ro = rng.standard_normal((2, 3000))
    ro.setflags(write=False)
    return {
        "float64": rng.standard_normal((2, 3000)),
        "int16": (rng.standard_normal((2, 3000)) * 3000).astype(np.int16),
        "transposed": base.T,
        "float32 transposed": base.astype(np.float32).T,
        "slice": base[::3, 0][None],
        "reversed": base[::-1].T,
        "read-only": ro,
    }


@pytest.mark.parametrize("part_bytes", [64, transfer.COPY_PART_BYTES], ids=["parts", "whole"])
@pytest.mark.parametrize("name", list(_strided_inputs()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_host_signal_reads_rows_in_place(name, dtype, part_bytes, monkeypatch):
    """Each row read into a host tensor in parts of 64 bytes over the copy
    pool, or each row's run whole."""
    monkeypatch.setattr(transfer, "COPY_PART_BYTES", part_bytes)
    a = _strided_inputs()[name]
    want = _to_tensor(a, torch.device("cpu"), dtype)
    hs = transfer.HostSignal(a, dtype)
    assert hs.shape == tuple(a.shape) and hs.dtype == dtype
    assert hs.host_dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
    got = hs.tensor()
    assert got.dtype == dtype and torch.equal(got, want)
    rows = transfer.HostSignal(list(a), dtype).tensor()
    assert torch.equal(rows, want)
    # a slab of every row, as _stage_next copies it
    slab = torch.empty((a.shape[0], 700), dtype=hs.host_dtype)
    hs.copy_into(slab, 500, 1200)
    assert torch.equal(slab, torch.as_tensor(np.ascontiguousarray(a[:, 500:1200])))


def test_slab_width():
    assert transfer.slab_width(1, 4) == transfer.SLAB_BYTES // 4
    assert transfer.slab_width(32, 8) == transfer.SLAB_BYTES // 256
    assert transfer.slab_width(1 << 30, 8) == 1


def _no_card(monkeypatch):
    """Make every way to pin, to stream or to stage raise."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path touched the card's transfer")

    real_empty = torch.empty

    def empty(*a, **k):
        if k.get("pin_memory"):
            refuse()
        return real_empty(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for cls in (transfer.StagedSignal, transfer.PinnedCores, transfer._Slot):
        monkeypatch.setattr(cls, "__init__", refuse)
    monkeypatch.setattr(transfer, "_copy_stream", refuse)
    monkeypatch.setattr(transfer.HostSignal, "stage", refuse)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_cpu_path_makes_no_pinned_tensor_and_no_stream(engine, monkeypatch):
    kw = dict(ENGINES[engine], chunk_size=CHUNK, padding=PADDING, device="cpu")
    y = np.random.default_rng(42).standard_normal((2, N)).astype(np.float32)
    want = nrt.reduce_noise(y, SR, **kw)
    _no_card(monkeypatch)
    assert np.array_equal(nrt.reduce_noise(y, SR, **kw), want)
    nrt.reduce_noise(y[0, :3000], SR, **kw)  # one chunk
    nrt.reduce_noise(y, SR, max_parallel_chunks=2, **kw)
    nrt.reduce_noise(y, SR, mesh=ChunkMesh((torch.device("cpu"),) * 2), **kw)
    nrt.reduce_noise_batch([y[0], y[1]], SR, **kw)
    y64 = y.astype(np.float64)
    assert nrt.reduce_noise(y64, SR, **kw).dtype == np.float64
    assert nrt.reduce_noise(y64, SR, mesh=ChunkMesh((torch.device("cpu"),) * 2),
                            **kw).dtype == np.float64
    assert [o.dtype for o in nrt.reduce_noise_batch([y64[0], y[1]], SR, **kw)] == [
        np.float64, np.float32]


# ---------------------------------------------------------------------------
# the native copy (host_copy over native/nrcopy.cpp) against numpy
# ---------------------------------------------------------------------------
def _special(dtype):
    """Every row's samples with the values a cast gets wrong first."""
    rng = np.random.default_rng(43)
    if dtype == np.int16:
        rows = rng.integers(-32768, 32768, size=(3, 5003), dtype=np.int16)
        rows[:, :4] = [-32768, 32767, 0, -1]
        return rows
    rows = rng.standard_normal((3, 5003)) * 10.0 ** rng.integers(-45, 40, size=(3, 5003))
    f32 = np.finfo(np.float32)
    special = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, -5e-324, 1e-40, -1e-40,
               float(f32.smallest_subnormal) / 2, float(f32.smallest_subnormal) * 0.75,
               1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24, float(f32.max) * 1.0000001, 1e39, -1e39,
               float(f32.tiny), float(f32.tiny) * (1 - 2.0 ** -30)]
    for r in range(3):
        rows[r, 7 * r : 7 * r + len(special)] = special
    rows[1, 2000:2100] = np.frombuffer(  # NaNs with payloads
        (np.arange(100, dtype=np.uint64) * 0x1234567 + 0x7FF0000000000001).tobytes(),
        dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        return rows.astype(dtype)


def _sources(a):
    """The same rows as a contiguous array, every third sample, reversed,
    transposed (interleaved) and a list of rows."""
    wide = np.repeat(a, 3, axis=1)
    return {
        "contiguous": a,
        "strided": wide[:, ::3],
        "reversed": np.ascontiguousarray(a[:, ::-1])[:, ::-1],
        "transposed": np.ascontiguousarray(a.T).T,
        "rows": [r.copy() for r in a],
    }


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.itemsize])


COPY_CASES = {"int16": (np.int16, np.int16), "float32": (np.float32, np.float32),
              "float64": (np.float64, np.float64), "float64 into float32": (np.float64, np.float32)}


@pytest.mark.parametrize("layout", ["rows-off-16", "packed"])
@pytest.mark.parametrize("part_bytes", [64, 1 << 30], ids=["many-parts", "one-part"])
@pytest.mark.parametrize("kind", ["contiguous", "strided", "reversed", "transposed", "rows"])
@pytest.mark.parametrize("case", list(COPY_CASES))
def test_native_copy_is_numpys_copy(case, kind, part_bytes, layout, monkeypatch):
    """Every row's samples [a, b) of each source into a host tensor, at
    edges off 16 bytes, into rows that start off 16 bytes (``rows-off-16``:
    each row's head stored, the rest streamed) or packed from an aligned
    start, bitwise ``np.copyto`` (the same dtype) or numpy's ``astype``
    (float64 into float32)."""
    monkeypatch.setattr(transfer, "COPY_PART_BYTES", part_bytes)
    src_dt, dst_dt = COPY_CASES[case]
    a = _special(src_dt)
    src = _sources(a)[kind]
    hs = transfer.HostSignal(src, torch.float32)
    tdt = torch.from_numpy(np.empty(0, dst_dt)).dtype
    for lo, hi in [(0, 5003), (1, 4998), (3, 3), (5, 6), (13, 2000), (4990, 5003)]:
        w = hi - lo
        # rows-off-16: rows of w + 3 samples from one element in, so no row
        # starts at 16 bytes; packed: rows of w from element 0 (64-byte aligned)
        pad, at = (3, 1) if layout == "rows-off-16" else (0, 0)
        store = torch.full((3 * (w + pad) + at,), -7, dtype=tdt)
        dst = store[at:].view(3, w + pad)[:, :w]
        assert layout == "rows-off-16" or dst.data_ptr() % 64 == 0
        hs.copy_into(dst, lo, hi)
        want = np.empty((3, w), dtype=dst_dt)
        if src_dt == dst_dt:
            np.copyto(want, a[:, lo:hi], casting="no")
        else:
            with np.errstate(over="ignore", invalid="ignore"):
                want = a[:, lo:hi].astype(dst_dt)
        assert np.array_equal(_bits(dst.numpy()), _bits(want)), (lo, hi)
        assert (store[:at] == -7).all() and (store[at:].view(3, w + pad)[:, w:] == -7).all()


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
def test_native_copy_into_a_slot_of_every_size(dtype):
    """A slot made as the ring makes one (``host_copy.on_cpus`` of its
    pool's CPUs around the allocation; not pinned here, where no card pins)
    as the destination of slabs of odd widths, the pool bound to half this
    process's CPUs: the allocating thread ran on those CPUs only and got
    its own back after (after an error too), the copy is numpy's, and the
    slot's pages lie on nodes the host names."""
    allowed = sorted(os.sched_getaffinity(0))
    cpus = allowed[: max(1, len(allowed) // 2)]
    pool = host_copy.CopyPool(3, cpus)
    a = _special(dtype)
    for nbytes in (6000, 3 << 20):
        ran = []

        def alloc():
            ran.append(sorted(os.sched_getaffinity(0)))
            return torch.zeros(nbytes, dtype=torch.uint8)  # every page written

        slot = host_copy.on_cpus(pool.cpus, alloc)
        assert ran == [cpus] and sorted(os.sched_getaffinity(0)) == allowed
        w = min(a.shape[1], nbytes // (3 * a.itemsize)) - 1
        src = np.ascontiguousarray(a[:, :w])
        pool.copy(np.array([r.ctypes.data for r in src]), np.full(3, a.itemsize), a.itemsize,
                  slot.data_ptr(), w * a.itemsize, a.itemsize, w, 1000)
        got = slot[: 3 * w * a.itemsize].numpy().view(dtype).reshape(3, w)
        assert np.array_equal(_bits(got), _bits(src))
        assert not slot[3 * w * a.itemsize :].any()
        nodes = host_copy.numa_nodes()
        held = host_copy.pages_by_node([(slot.data_ptr(), nbytes)])
        assert not nodes or (held and set(held) <= set(nodes))
    with pytest.raises(ZeroDivisionError):
        host_copy.on_cpus(pool.cpus, lambda: 1 / 0)
    assert sorted(os.sched_getaffinity(0)) == allowed
    assert host_copy.on_cpus(None, lambda: sorted(os.sched_getaffinity(0))) == allowed


def test_native_copy_shared_by_threads(monkeypatch):
    """Eight Python threads (more than the pool's three native threads)
    copy their own signals through one pool at once, the interpreter
    switching threads every 10 us: each copy is its own."""
    import sys
    import threading

    monkeypatch.setattr(transfer, "COPY_PART_BYTES", 256)
    monkeypatch.setattr(transfer, "COPY_THREADS", 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((2, 3001))
        hs = transfer.HostSignal(a, torch.float32)
        try:
            for _ in range(60):
                lo = int(rng.integers(0, 3000))
                dst = torch.empty((2, 3001 - lo), dtype=torch.float32)
                hs.copy_into(dst, lo, 3001)
                if not np.array_equal(dst.numpy(), a[:, lo:].astype(np.float32)):
                    errors.append(seed)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors


def _allowed(tid: int):
    """The CPUs thread ``tid`` may run on, or None once it has ended."""
    try:
        return sorted(os.sched_getaffinity(tid))
    except OSError:
        return None


def test_card_copy_pool_is_bound_to_the_cards_node(monkeypatch):
    """Where the card has a NUMA node (faked: node 1, half of this
    process's CPUs and one it may not use), the card's copy pool is bound
    to the node's CPUs it may use: ``COPY_THREADS`` native threads of this
    process may run there only, the pool is made once, a host tensor's copy
    takes the unbound pool, and a slab copied through the bound pool (as
    ``_stage_next`` passes a slot's pool) is numpy's."""
    allowed = sorted(os.sched_getaffinity(0))
    node = allowed[: max(1, len(allowed) // 2)]
    monkeypatch.setattr(host_copy, "card_node", lambda device: 1)
    monkeypatch.setattr(host_copy, "numa_nodes",
                        lambda: {0: allowed[len(node):], 1: node + [max(allowed) + 1]})
    monkeypatch.setattr(transfer, "_NODE_CPUS", {})
    card = torch.device("cuda", 0)
    assert host_copy.node_cpus(card) == node
    pool = transfer._copy_pool(card)
    assert pool.cpus == tuple(node) and transfer._copy_pool(card) is pool
    assert transfer._copy_pool().cpus is None and transfer._copy_pool() is not pool
    before = {int(t) for t in os.listdir("/proc/self/task")}
    host_copy.CopyPool(2, node)  # two more threads, bound the same way
    after = {int(t) for t in os.listdir("/proc/self/task")}
    assert len(after - before) == 2 and all(_allowed(t) == node for t in after - before)
    bound = [t for t in after if _allowed(t) == node]
    assert len(bound) >= transfer.COPY_THREADS + 2
    a = _special(np.float64)
    dst = torch.empty((3, 4000), dtype=torch.float32)
    transfer.HostSignal(a, torch.float32).copy_into(dst, 1000, 5000, pool=pool)
    with np.errstate(over="ignore", invalid="ignore"):
        want = a[:, 1000:5000].astype(np.float32)
    assert np.array_equal(_bits(dst.numpy()), _bits(want))


def test_card_without_a_node_takes_the_unbound_pool(monkeypatch):
    """A card the host names no node for (``card_node`` None), or a node
    none of whose CPUs this process may use: the card's copy pool is the
    unbound one."""
    allowed = set(os.sched_getaffinity(0))
    monkeypatch.setattr(transfer, "_NODE_CPUS", {})
    monkeypatch.setattr(host_copy, "card_node", lambda device: None)
    card = torch.device("cuda", 0)
    assert host_copy.node_cpus(card) is None
    assert transfer._copy_pool(card) is transfer._copy_pool()
    monkeypatch.setattr(transfer, "_NODE_CPUS", {})
    monkeypatch.setattr(host_copy, "card_node", lambda device: 3)
    monkeypatch.setattr(host_copy, "numa_nodes", lambda: {3: [max(allowed) + 1]})
    assert host_copy.node_cpus(card) is None
    assert transfer._copy_pool(card) is transfer._copy_pool()


def test_wire_dtype_casts_only_float64_into_float32():
    """float64 rows cross as float32 only where the signal is float32 (the
    host's cast in the copy); a float64 signal headed for bfloat16 crosses
    as float64 and is cast on the card (float32 then bfloat16 would round
    twice on the host); int16 crosses as int16; float32 as float32."""
    x64 = _special(np.float64)
    assert transfer.HostSignal(x64, torch.float32).wire_dtype == torch.float32
    for dtype in (torch.bfloat16, torch.float64):
        hs = transfer.HostSignal(x64, dtype)
        assert hs.wire_dtype == torch.float64
        slab = torch.empty((3, 100), dtype=hs.wire_dtype)
        hs.copy_into(slab, 10, 110)
        assert np.array_equal(_bits(slab.numpy()), _bits(x64[:, 10:110]))
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        assert transfer.HostSignal(_special(np.int16), dtype).wire_dtype == torch.int16
    assert transfer.HostSignal(_special(np.float32), torch.bfloat16).wire_dtype == torch.float32
    finite = np.where(np.isfinite(x64), x64, 0.0)
    got = transfer.HostSignal(finite, torch.bfloat16).tensor()
    assert torch.equal(got.view(torch.int16), torch.as_tensor(finite).to(torch.bfloat16)
                       .view(torch.int16))


def test_host_copy_refuses_what_it_cannot_copy():
    a = np.zeros((2, 100), dtype=np.float32)
    hs = transfer.HostSignal(a, torch.float32)
    with pytest.raises(IndexError):
        hs.copy_into(torch.empty((2, 10)), 95, 105)
    with pytest.raises(ValueError):
        hs.copy_into(torch.empty((3, 10)), 0, 10)
    with pytest.raises(ValueError):
        hs.copy_into(torch.empty((10, 2)).T, 0, 10)  # rows of stride 2
    with pytest.raises(TypeError):
        hs.copy_into(torch.empty((2, 10), dtype=torch.float64), 0, 10)
    with pytest.raises(TypeError):  # only float64 rows are cast
        transfer.HostSignal(a.astype(np.int16), torch.float32).copy_into(
            torch.empty((2, 10)), 0, 10)
    with pytest.raises(ValueError):  # no widening: the card widens a float64 output
        host_copy.pool(2).copy(hs._addr, hs._stride, 4, torch.empty((2, 10), dtype=torch.float64)
                               .data_ptr(), 80, 8, 10, 10)
    with pytest.raises(ValueError):
        transfer.HostSignal([a[0], a[1, :99]], torch.float32)
    with pytest.raises(ValueError):
        transfer.HostSignal([a[0], a[1].astype(np.float64)], torch.float32)


def test_native_copy_builds_into_the_ports_build_directory():
    path = host_copy.library()._name
    assert pathlib.Path(path).parent.parent == pathlib.Path(transfer.__file__).resolve(
    ).parent.parent / "_build"
    assert pathlib.Path(path).name == "libnrcopy.so"


def test_host_facts_read_the_host():
    """CPU lists, the nodes of a mapping and the facts' fields (the card's
    node left out: no card here)."""
    assert host_copy._cpu_list("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert host_copy._span_text([11, 0, 1, 2, 3, 8, 10]) == "0-3,8,10-11"
    assert host_copy._span_text([]) == ""
    nodes = host_copy.numa_nodes()
    assert all(isinstance(n, int) and cpus for n, cpus in nodes.items())
    a = np.ones(1 << 20, dtype=np.float32)
    got = host_copy.pages_by_node([(a.ctypes.data, a.nbytes)])
    assert not nodes or (set(got) <= set(nodes) and sum(got.values()) >= a.nbytes // 4096)
