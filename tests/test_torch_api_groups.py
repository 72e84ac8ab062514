"""PyTorch port: the JAX signature's ``method``, ``mesh`` (its type; the
sharded paths in tests/test_torch_mesh.py),
``max_parallel_chunks`` and ``use_tqdm`` through ``reduce_noise`` and
``reduce_noise_batch``, against the JAX package (CPU); and kernel C's
launch plan (``geometry.freq_smooth_plan``) against a numpy model of the
kernel's span partition.

The signal: 16 kHz, ``chunk_size`` 4000, ``padding`` 1000, 5.3 chunks, on
the non-stationary, stationary and ``use_torch=True`` engines.

- Against the JAX ``reduce_noise`` with the same keywords, in float64
  (``device="cpu"``, the kernels' plain versions): 1e-9 x max|ref| for the
  scipy engines, 1e-8 x max|ref| for the torch engine (rank-1 against every
  SVD rank), the bounds of tests/test_torch_gate.py and
  tests/test_torch_torchgate_api.py.
- Grouped against ungrouped in the port: bitwise, in float32 and float64.
  A group's views are the same samples (kernel A's plain version slices
  them from one padded copy of the signal) and every later step is per
  view, frame or line, so the CPU plain path gives the same bits too.
- Kernel C's plan: every output is covered by exactly one span and one run,
  the 16-byte head, pieces and tail of each span cover it exactly for any
  4-byte phase of the plane, and the register windows' zero fill by index
  gives the plain version's 'same' correlation, taps wider than a line
  included.
"""
import numpy as np
import pytest
import torch

import noisereduce_tpu as jnr

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.geometry import (
    FS_GROUP, FS_RUN, FS_SPAN, FS_THREADS, freq_smooth_plan,
)
from noisereduce_tpu_torch.ops.dsp import tri_norm
from noisereduce_tpu_torch.parallel.mesh import ChunkMesh

torch.set_num_threads(2)

SR, CHUNK, PADDING, N = 16000, 4000, 1000, 21200  # 5.3 chunks
CK = dict(chunk_size=CHUNK, padding=PADDING)
F64 = dict(device="cpu", compute_dtype=torch.float64)
ENGINES = {
    "nonstationary": dict(),
    "stationary": dict(stationary=True),
    "torch": dict(use_torch=True),
}
TOL = {"nonstationary": 1e-9, "stationary": 1e-9, "torch": 1e-8}


def _signal(seed=30, n=N):
    return np.random.default_rng(seed).standard_normal(n)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("extra", [
    dict(max_parallel_chunks=0), dict(max_parallel_chunks=1), dict(max_parallel_chunks=2),
    dict(max_parallel_chunks=3), dict(max_parallel_chunks=10), dict(method="auto"),
    dict(method="fft"), dict(method="matmul"), dict(use_tqdm=True),
    dict(use_tqdm=True, max_parallel_chunks=4),
], ids=["mpc0", "mpc1", "mpc2", "mpc3", "mpc10", "auto", "fft", "matmul", "tqdm", "tqdm-mpc4"])
def test_jax_keywords_match_jax_and_the_ungrouped_call(engine, extra):
    y = _signal()
    kw = dict(CK, **ENGINES[engine])
    got = nrt.reduce_noise(y, SR, **kw, **extra, **F64)
    ref = np.asarray(jnr.reduce_noise(y, SR, **kw, **extra))
    assert got.shape == ref.shape == y.shape
    assert _rel(got, ref) <= TOL[engine]
    assert np.array_equal(got, nrt.reduce_noise(y, SR, **kw, **F64))


@pytest.mark.parametrize("engine", list(ENGINES) + ["torch-stationary-clip"])
def test_grouped_float32_is_bitwise_the_ungrouped_call(engine):
    """Float32 on the CPU, stereo, every group size and the bar; the
    stationary torch engine with a noise clip takes its threshold once."""
    y = _signal(31, 2 * N).reshape(2, N).astype(np.float32)
    kw = dict(CK, device="cpu", **ENGINES.get(engine, dict(use_torch=True, stationary=True)))
    if engine == "torch-stationary-clip":
        kw["y_noise"] = _signal(32, 6000)
    want = nrt.reduce_noise(y, SR, **kw)
    for extra in (dict(max_parallel_chunks=g) for g in (1, 2, 3, 6, 10)):
        assert np.array_equal(nrt.reduce_noise(y, SR, **kw, **extra), want)
    assert np.array_equal(nrt.reduce_noise(y, SR, **kw, use_tqdm=True), want)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_tqdm_shows_one_step_a_group(engine, capsys):
    """The bar counts groups (one chunk a group by default), as the JAX
    package's does; a signal of one chunk shows none."""
    nrt.reduce_noise(_signal(), SR, **CK, **ENGINES[engine], use_tqdm=True,
                     max_parallel_chunks=2, device="cpu")
    assert "3/3" in capsys.readouterr().err
    nrt.reduce_noise(_signal()[:CHUNK], SR, **CK, **ENGINES[engine], use_tqdm=True,
                     device="cpu")
    assert "group" not in capsys.readouterr().err


@pytest.mark.parametrize("engine", list(ENGINES))
def test_mesh_raises(engine):
    """A mesh that is not a ``ChunkMesh`` raises ``TypeError``; a
    ``ChunkMesh`` of CPU devices gives the unsharded output bitwise
    (tests/test_torch_mesh.py holds the rest)."""
    with pytest.raises(TypeError, match="ChunkMesh"):
        nrt.reduce_noise(_signal(), SR, **CK, **ENGINES[engine], mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="ChunkMesh"):
        nrt.reduce_noise_batch([_signal()], SR, **CK, **ENGINES[engine], mesh=object(),
                               device="cpu")
    mesh = ChunkMesh((torch.device("cpu"),) * 4)
    want = nrt.reduce_noise(_signal(), SR, **CK, **ENGINES[engine], device="cpu")
    assert np.array_equal(
        nrt.reduce_noise(_signal(), SR, **CK, **ENGINES[engine], mesh=mesh, device="cpu"), want)
    (got,) = nrt.reduce_noise_batch([_signal()], SR, **CK, **ENGINES[engine], mesh=mesh,
                                    device="cpu")
    assert np.array_equal(got, want)


def test_reduce_noise_takes_the_jax_signature():
    """The JAX ``reduce_noise``'s parameters, names and defaults, less
    ``device`` (the port's defaults to the card)."""
    import inspect

    port = inspect.signature(nrt.reduce_noise).parameters
    jax_ = inspect.signature(jnr.reduce_noise).parameters
    assert list(port) == list(jax_)
    for name in ("method", "mesh", "max_parallel_chunks", "use_tqdm"):
        assert port[name].default == jax_[name].default, name


@pytest.mark.parametrize("engine", list(ENGINES))
def test_reduce_noise_batch_takes_the_keywords(engine):
    """Each row of a grouped batch is the per-signal call, and the batch
    matches the JAX package's with the same keywords."""
    ys = [_signal(40 + i) for i in range(3)] + [_signal(50)[:15000]]
    kw = dict(CK, **ENGINES[engine], max_parallel_chunks=2, method="matmul", use_tqdm=True)
    got = nrt.reduce_noise_batch(ys, SR, **kw, **F64)
    ref = jnr.reduce_noise_batch(ys, SR, **kw)
    for g, r, y in zip(got, ref, ys):
        assert _rel(g, r) <= TOL[engine]
        assert np.array_equal(g, nrt.reduce_noise(y, SR, **CK, **ENGINES[engine], **F64))


# ---------------------------------------------------------------------------
# kernel C's plan: a numpy model of the span partition
# ---------------------------------------------------------------------------
def _model_c(m, taps, prop, word):
    """Kernel C as its plan lays it out (csrc/freq_smooth_blend.cu), in
    numpy: per span, the staged floats by head, 16-byte pieces and tail for
    a plane whose element 0 is ``word`` words past a 16-byte boundary;
    then the runs of FS_RUN outputs, each from a window zero filled by its
    index in the line, the taps in groups of FS_GROUP. Returns the output
    and how many times each output was written and each input staged."""
    n_rows, nb = m.shape
    plan = freq_smooth_plan(n_rows, nb, len(taps))
    dt = np.asarray(plan.device_taps(taps))
    assert len(dt) == plan.n_taps and plan.n_taps % FS_GROUP == 0
    assert plan.lines * nb <= max(FS_SPAN, nb)
    flat = m.reshape(-1)
    out = np.zeros(n_rows * nb)
    wrote = np.zeros(n_rows * nb, int)
    staged = np.zeros(n_rows * nb, int)
    for s in range(plan.spans):
        r0, nl = plan.span(s)
        g0, n = r0 * nb, nl * nb
        head, pieces, tail = plan.staging(s, word)
        assert head + 4 * pieces + tail == n and head < 4 and tail < 4
        assert (word + g0 + head) % 4 == 0 or pieces == 0
        staged[g0 : g0 + head] += 1
        for q in range(pieces):
            staged[g0 + head + 4 * q : g0 + head + 4 * q + 4] += 1
        staged[g0 + head + 4 * pieces : g0 + n] += 1
        span = flat[g0 : g0 + n]
        for r in range(nl * plan.runs_per_line):
            line, k0 = divmod(r, plan.runs_per_line)
            k0 *= FS_RUN
            row = span[line * nb : (line + 1) * nb]
            acc = np.zeros(FS_RUN)
            for d0 in range(0, plan.n_taps, FS_GROUP):
                p = k0 - plan.half + d0 + np.arange(FS_RUN + FS_GROUP - 1)
                w = np.where((p >= 0) & (p < nb), row[np.clip(p, 0, nb - 1)], 0.0)
                for d in range(FS_GROUP):
                    acc += dt[d0 + d] * w[d : d + FS_RUN]
            live = k0 + np.arange(FS_RUN) < nb
            at = g0 + line * nb + k0 + np.arange(FS_RUN)[live]
            out[at] = acc[live] * prop + (1 - prop)
            wrote[at] += 1
    return out.reshape(m.shape), wrote, staged


@pytest.mark.parametrize("nb,taps,rows", [
    (513, 5, 19), (513, 64, 9), (257, 320, 20), (21, 5, 600), (1, 3, 6200), (22, 30, 300),
], ids=["513-11taps", "513-129taps", "257-641taps", "21-nfft40", "1bin", "22-61taps"])
@pytest.mark.parametrize("word", [0, 1, 3])
def test_freq_smooth_plan_covers_every_output_once(nb, taps, rows, word):
    """Every output written once and every input staged once, for an
    aligned plane and one an odd number of words off; the windows' zero fill
    at each line's ends (and past them, for taps wider than the line) gives
    the plain version's correlation."""
    t = tri_norm(taps)
    m = np.random.default_rng(60 + nb).uniform(0, 1, (rows, nb))
    got, wrote, staged = _model_c(m, t, 0.8, word)
    assert (wrote == 1).all() and (staged == 1).all()
    ref = K.freq_smooth_blend_ref(torch.as_tensor(m), t, 0.8).numpy()
    assert np.abs(got - ref).max() <= 1e-12


@pytest.mark.parametrize("nb", [513, 257, 21, 1, 1025, 4097, 8193])
def test_freq_smooth_plan_keeps_the_threads_busy(nb):
    """A span holds whole lines, at most FS_SPAN floats (one line past
    that), and its runs leave no more threads idle on the last pass than
    any other number of lines that fits; taps past a line are dropped."""
    plan = freq_smooth_plan(100_000, nb, 11)
    assert plan.lines == 1 if nb > FS_SPAN else plan.lines * nb <= FS_SPAN

    def busy(lines):
        runs = lines * plan.runs_per_line
        return runs / (-(-runs // FS_THREADS) * FS_THREADS)

    assert all(busy(plan.lines) >= busy(f) for f in range(1, max(1, FS_SPAN // nb) + 1))
    wide = freq_smooth_plan(10, nb, 2 * nb + 41)
    assert wide.half == nb - 1 and wide.first == 21
    assert wide.n_taps == -(-(2 * nb - 1) // FS_GROUP) * FS_GROUP


def test_freq_smooth_plan_refuses_a_line_past_shared_memory():
    with pytest.raises(ValueError, match="does not fit a block"):
        freq_smooth_plan(4, 40_000, 11)
