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
- ``reduce_noise(..., device="cpu")`` (every engine, a CPU mesh, a batch)
  makes no pinned tensor, no stream and no event, and stages nothing.

The card side (the copy streams, the events, the pinned ring and output)
is held by ``tests/test_torch_cuda.py`` (marker ``gpu``).
"""
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
from noisereduce_tpu_torch.parallel import transfer
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
