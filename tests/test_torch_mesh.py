"""PyTorch port: chunk sharding over a ``ChunkMesh`` (``parallel/mesh.py``,
``parallel/chunking.py::shard_cores`` / ``shard_filter``, ``mesh=`` through
``reduce_noise``, ``reduce_noise_batch`` and ``reduce_noise_file``), the
counterpart of tests/test_multidevice.py and of the mesh cases of
tests/test_streaming.py, on the CPU.

The port's meshes name the CPU device 8 times (4 or 3 where stated), as
the JAX tests' eight fake CPU devices stand for eight chips. Each case is
held two ways:

- bitwise to the port's own ``mesh=None`` call (chunks are independent, a
  device's views are the same samples read from its own slice, and every
  later step is per view, frame or line);
- to the JAX package's mesh call on its CPU devices (``shard_map``, the
  staged engines) in float64: 1e-9 x max|ref| for the scipy engines and
  the combinators, 1e-8 for the torch engine (rank-1 against every SVD
  rank; tests/test_torch_api_groups.py's ``TOL``); the bf16 case within
  twice the bf16 envelope (tests/test_torch_bf16.py); the files within
  tests/test_streaming.py's 2e-7.

Signals are at most 60,000 samples, made from ``np.random.default_rng``
seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import noisereduce_tpu as jnr
from noisereduce_tpu.config import GateConfig as JGateConfig
from noisereduce_tpu.models.spectral_gate import gate_nonstationary as j_gate_ns
from noisereduce_tpu.models.spectral_gate import gate_stationary as j_gate_st
from noisereduce_tpu.parallel.chunking import process_chunked as j_process_chunked
from noisereduce_tpu.streaming import reduce_noise_file as jax_file

import noisereduce_tpu_torch as nrt
import noisereduce_tpu_torch.streaming as st
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.ops.cuda.dispatch import fused_gate_chunked
from noisereduce_tpu_torch.parallel.chunking import (
    extract_chunks,
    mesh_ranges,
    process_chunked,
    shard_filter,
)
from noisereduce_tpu_torch.parallel.mesh import ChunkMesh, chunk_mesh, distributed_chunks
from noisereduce_tpu_torch.utils import io as nrio

torch.set_num_threads(2)

CPU = torch.device("cpu")
ENGINES = {
    "nonstationary": dict(),
    "stationary": dict(stationary=True),
    "torch": dict(use_torch=True),
}
TOL = {"nonstationary": 1e-9, "stationary": 1e-9, "torch": 1e-8}
F64 = dict(device="cpu", compute_dtype=torch.float64)


def _mesh(n=8):
    return ChunkMesh((CPU,) * n)


def _jmesh(n=8, name="chunks"):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} virtual devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (name,))


def _rng(seed):
    return np.random.default_rng(seed)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# the combinators (test_multidevice.py:25-48)
# ---------------------------------------------------------------------------
def test_process_chunked_sharded_matches_single():
    y = _rng(5).standard_normal((2, 50000))

    def filt(c):
        return c * 2.0 + torch.cumsum(c, dim=-1) * 1e-3

    yt = torch.as_tensor(y)
    single = process_chunked(filt, yt, 4000, 500)
    for group in (0, 2):
        assert torch.equal(process_chunked(filt, yt, 4000, 500, group, mesh=_mesh()), single)
    ref = j_process_chunked(lambda c: c * 2.0 + jnp.cumsum(c, axis=-1) * 1e-3,
                            jnp.asarray(y), chunk_size=4000, padding=500, mesh=_jmesh(),
                            axis_name="chunks")
    assert _rel(single, ref) <= 1e-9


def test_process_chunked_sharded_pads_chunk_count():
    """5 chunks over 8 devices: devices 5-7 gate none (JAX pads them with
    all-zero chunks and trims them)."""
    y = _rng(6).standard_normal((1, 20000))
    single = process_chunked(lambda c: c + 1.0, torch.as_tensor(y), 4000, 100)
    sharded = process_chunked(lambda c: c + 1.0, torch.as_tensor(y), 4000, 100, mesh=_mesh())
    assert torch.equal(single, sharded)
    assert [(f, k) for _, f, k in mesh_ranges(5, _mesh())] == [(i, 1) for i in range(5)]
    ref = j_process_chunked(lambda c: c + 1.0, jnp.asarray(y), chunk_size=4000, padding=100,
                            mesh=_jmesh())
    assert _rel(sharded, ref) <= 1e-9


# ---------------------------------------------------------------------------
# reduce_noise (test_multidevice.py:51-74)
# ---------------------------------------------------------------------------
def _held(y, sr, kw, engine, mesh_n=8):
    """The port's mesh call bitwise its mesh=None call, in float32 and in
    float64, and the float64 one against the JAX mesh call."""
    f32 = dict(kw, device="cpu")
    y32 = y.astype(np.float32)
    assert np.array_equal(nrt.reduce_noise(y32, sr, mesh=_mesh(mesh_n), **f32),
                          nrt.reduce_noise(y32, sr, **f32))
    got = nrt.reduce_noise(y, sr, mesh=_mesh(mesh_n), **kw, **F64)
    assert np.array_equal(got, nrt.reduce_noise(y, sr, **kw, **F64))
    ref = np.asarray(jnr.reduce_noise(y=y, sr=sr, mesh=_jmesh(mesh_n), **kw))
    assert _rel(got, ref) <= TOL[engine]


@pytest.mark.parametrize("stationary", [True, False])
def test_reduce_noise_mesh_matches_unsharded(stationary):
    y = _rng(7).standard_normal(60000) * 1000
    _held(y, 44100, dict(stationary=stationary, chunk_size=8000, padding=1000),
          "stationary" if stationary else "nonstationary")


def test_reduce_noise_mesh_torch_path():
    y = _rng(8).standard_normal(60000) * 1000
    _held(y, 44100, dict(stationary=True, chunk_size=8000, padding=1000, use_torch=True),
          "torch")


def test_reduce_noise_mesh_multichannel():
    y = _rng(9).standard_normal((2, 40000)) * 1000
    _held(y, 44100, dict(stationary=False, chunk_size=5000, padding=800), "nonstationary")


def test_chunk_mesh_and_distributed_chunks():
    """``chunk_mesh`` takes CUDA devices only (raising without CUDA);
    ``ChunkMesh`` reads as a JAX mesh does; ``distributed_chunks`` places a
    block as contiguous ranges, which round-trip and which
    ``shard_filter`` takes as it takes the tensor."""
    from noisereduce_tpu.parallel.mesh import distributed_chunks as j_distributed

    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in chunk_mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            chunk_mesh(8)
    mesh = _mesh()
    assert mesh.shape["chunks"] == 8 and mesh.axis_names == ("chunks",)
    assert ChunkMesh(("cpu",) * 2, "shards").shape == {"shards": 2}
    with pytest.raises(ValueError):
        ChunkMesh(())
    local = np.asarray(_rng(10).standard_normal((1, 8, 500)), dtype=np.float32)
    blocks = distributed_chunks(local, mesh)
    assert len(blocks) == 8 and all(b.shape == (1, 1, 500) for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks, dim=-2).numpy(), local)
    ref = j_distributed(local, _jmesh())
    assert ref.shape == (1, 8, 500)
    np.testing.assert_array_equal(np.asarray(ref), local)
    uneven = distributed_chunks(local[:, :5], _mesh(3))  # 2, 2, 1 chunks
    assert [b.shape[-2] for b in uneven] == [2, 2, 1]

    def filt(c):
        return c * 3.0 - 1.0

    want = filt(torch.as_tensor(local))
    assert torch.equal(shard_filter(filt, blocks, mesh), want)
    assert torch.equal(shard_filter(filt, torch.as_tensor(local), _mesh(3),
                                    max_parallel_chunks=2), want)


# ---------------------------------------------------------------------------
# the whole-body fused chunked path (test_multidevice.py:84-189); the JAX
# side is its staged engine on the mesh, in float64
# ---------------------------------------------------------------------------
def _fused_signal(seed, k_chunks=6, chunk=4096, channels=1):
    n = chunk * k_chunks - 1000  # last chunk partial
    return _rng(seed).standard_normal((channels, n)) * 0.3


def _jax_staged(y, cfg_kw, mesh=None, mpc=0, thresh=None):
    jcfg = JGateConfig(**cfg_kw)
    if thresh is None:
        fn, extra = (lambda c: j_gate_ns(c, jcfg, use_pallas=False)), ()
    else:
        fn, extra = (lambda c, t: j_gate_st(c, t, jcfg, use_pallas=False)), (jnp.asarray(thresh),)
    return np.asarray(j_process_chunked(fn, jnp.asarray(y), 4096, 512, mesh=mesh, extra=extra,
                                        max_parallel_chunks=mpc))


def _fused_held(y, cfg_kw, mesh, group=0, thresh=None, jmesh=None, mpc=0):
    cfg = GateConfig(**cfg_kw)

    def run(a, dtype, m, g):
        t = None if thresh is None else torch.as_tensor(thresh, dtype=dtype)
        return fused_gate_chunked(torch.as_tensor(a, dtype=dtype), cfg, 4096, 512, t, g,
                                  mesh=m)

    assert torch.equal(run(y, torch.float32, mesh, group), run(y, torch.float32, None, 0))
    got = run(y, torch.float64, mesh, group)
    assert torch.equal(got, run(y, torch.float64, None, 0))
    assert _rel(got, _jax_staged(y, cfg_kw, jmesh, mpc, thresh)) <= 1e-9


def test_fused_chunked_mesh_matches_single():
    _fused_held(_fused_signal(20), dict(sr=48000), _mesh(), jmesh=_jmesh())


def test_fused_chunked_max_parallel_chunks_matches():
    _fused_held(_fused_signal(21, k_chunks=5), dict(sr=48000), None, group=2, mpc=2)


def test_fused_chunked_mesh_and_mpc_compose():
    # more than one chunk a device on 4 devices, in groups of 2
    _fused_held(_fused_signal(22, k_chunks=9, channels=2), dict(sr=48000), _mesh(4), group=2,
                jmesh=_jmesh(4), mpc=2)


def test_fused_chunked_stationary_mesh_matches():
    cfg_kw = dict(sr=48000, stationary=True)
    thresh = _rng(23).uniform(-60, -20, GateConfig(**cfg_kw).stft.n_bins)
    _fused_held(_fused_signal(24), cfg_kw, _mesh(), thresh=thresh, jmesh=_jmesh())


def test_fused_chunked_bf16_mesh_matches():
    """bf16 (the fast mode): the mesh output bitwise the unsharded bf16
    output, and within twice the non-stationary bf16 envelope (2.5e-2 rel
    max) of the JAX package's bf16 call on its mesh."""
    cfg = GateConfig(sr=48000)
    y = torch.as_tensor(_fused_signal(25), dtype=torch.float32).to(torch.bfloat16)
    single = fused_gate_chunked(y, cfg, 4096, 512)
    sharded = fused_gate_chunked(y, cfg, 4096, 512, mesh=_mesh())
    assert sharded.dtype == torch.bfloat16
    assert torch.equal(single, sharded)
    jy = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(j_process_chunked(
        lambda c: j_gate_ns(c, JGateConfig(sr=48000), use_pallas=False), jy, 4096, 512,
        mesh=_jmesh()), np.float32)
    assert _rel(sharded.float().numpy(), ref) <= 2 * 2.5e-2


@pytest.mark.parametrize("stationary", [False, True])
def test_public_api_mesh_hits_fused_path(stationary):
    """``reduce_noise(mesh=...)`` through the fused path (the plain
    versions here): bitwise the unsharded call, in float32 within the
    JAX test's 5e-3 x scale of the JAX staged mesh output, in float64
    within 1e-9."""
    y = (_rng(26).standard_normal(4096 * 5 - 777) * 0.3).astype(np.float32)
    kw = dict(sr=48000, stationary=stationary, chunk_size=4096, padding=512)
    if stationary:
        kw["y_noise"] = y[:8192]
    single = nrt.reduce_noise(y, device="cpu", **kw)
    sharded = nrt.reduce_noise(y, mesh=_mesh(), device="cpu", **kw)
    np.testing.assert_array_equal(single, sharded)
    staged = np.asarray(jnr.reduce_noise(y=y.astype(np.float64), mesh=_jmesh(), **kw))
    assert np.max(np.abs(sharded - staged)) < 5e-3 * np.max(np.abs(staged))
    f64 = nrt.reduce_noise(y.astype(np.float64), mesh=_mesh(), **kw, **F64)
    assert _rel(f64, staged) <= TOL["stationary" if stationary else "nonstationary"]


# ---------------------------------------------------------------------------
# beyond the JAX tests: uneven ranges, groups, bf16, the batch, gradients
# ---------------------------------------------------------------------------
SR, CHUNK, PADDING = 16000, 4000, 1000
CK = dict(chunk_size=CHUNK, padding=PADDING)


def _signal(seed, n=19000):  # 5 chunks
    return _rng(seed).standard_normal(n)


@pytest.mark.parametrize("n_dev", [8, 3])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_five_chunks_over_uneven_meshes(engine, n_dev):
    """5 chunks over 8 devices (one each, three idle) and over 3 (2, 2, 1),
    stereo: bitwise the unsharded call."""
    y = _signal(30, 2 * 19000).reshape(2, 19000).astype(np.float32)
    kw = dict(CK, device="cpu", **ENGINES[engine])
    assert [k for _, _, k in mesh_ranges(5, _mesh(n_dev))] == ([1] * 5 if n_dev == 8
                                                              else [2, 2, 1])
    np.testing.assert_array_equal(nrt.reduce_noise(y, SR, mesh=_mesh(n_dev), **kw),
                                  nrt.reduce_noise(y, SR, **kw))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_mesh_with_max_parallel_chunks(engine):
    """Groups walk each device's range (the bound is per device): bitwise
    the unsharded call for every group size, and the JAX package's mesh
    call with the same ``max_parallel_chunks`` in float64."""
    y = _signal(31, 30000)  # 8 chunks
    kw = dict(CK, **ENGINES[engine])
    want = nrt.reduce_noise(y.astype(np.float32), SR, device="cpu", **kw)
    for g in (1, 2, 3):
        np.testing.assert_array_equal(
            nrt.reduce_noise(y.astype(np.float32), SR, mesh=_mesh(3), max_parallel_chunks=g,
                             device="cpu", **kw), want)
    got = nrt.reduce_noise(y, SR, mesh=_mesh(4), max_parallel_chunks=1, **kw, **F64)
    ref = np.asarray(jnr.reduce_noise(y, SR, mesh=_jmesh(4), max_parallel_chunks=1, **kw))
    assert _rel(got, ref) <= TOL[engine]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_bf16_mesh_is_bitwise_the_unsharded_bf16_call(engine):
    y = _signal(32).astype(np.float32)
    kw = dict(CK, device="cpu", compute_dtype=torch.bfloat16, **ENGINES[engine])
    with pytest.warns(UserWarning) if engine == "stationary" else _no_warning():
        got = nrt.reduce_noise(y, SR, mesh=_mesh(), **kw)
    with pytest.warns(UserWarning) if engine == "stationary" else _no_warning():
        want = nrt.reduce_noise(y, SR, **kw)
    np.testing.assert_array_equal(got, want)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("engine", list(ENGINES))
def test_reduce_noise_batch_mesh(engine):
    """The mesh reaches every group of the batch: bitwise the unsharded
    batch, and the JAX batch on its mesh in float64."""
    ys = [_signal(40 + i) for i in range(3)] + [_signal(50, 15000)]
    kw = dict(CK, **ENGINES[engine])
    got = nrt.reduce_noise_batch(ys, SR, mesh=_mesh(4), **kw, **F64)
    want = nrt.reduce_noise_batch(ys, SR, **kw, **F64)
    ref = jnr.reduce_noise_batch(ys, SR, mesh=_jmesh(4), **kw)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        assert _rel(g, r) <= TOL[engine]


def test_short_signal_with_a_mesh_is_the_unchunked_call():
    """A signal of at most ``chunk_size`` samples keeps its exact unchunked
    view (n + 2 * padding) on the mesh's first device."""
    y = _signal(33, 3000)
    for engine in ENGINES:
        kw = dict(CK, device="cpu", **ENGINES[engine])
        np.testing.assert_array_equal(nrt.reduce_noise(y, SR, mesh=_mesh(), **kw),
                                      nrt.reduce_noise(y, SR, **kw))


@pytest.mark.parametrize("stationary", [False, True])
def test_mesh_under_grad_is_the_unsharded_gradient(stationary):
    """``fused_gate_chunked`` with a mesh under grad: the value bitwise the
    unsharded call's, and the cotangent (the staged twin, sharded the same
    way) within float64 rounding of it (1e-12 x max|g|): the twin's
    backward runs on each device's batch of views, and a batch of one view
    rounds its last bit differently on the CPU."""
    cfg = GateConfig(sr=SR, stationary=stationary)
    y = torch.as_tensor(_signal(34).reshape(1, -1), dtype=torch.float64)
    thr = None
    if stationary:
        thr = torch.as_tensor(_rng(35).uniform(-60, -20, cfg.stft.n_bins))
    cot = torch.as_tensor(_rng(36).standard_normal(tuple(y.shape)))

    def run(mesh):
        a = y.clone().requires_grad_()
        out = fused_gate_chunked(a, cfg, CHUNK, PADDING, thr, mesh=mesh)
        (g,) = torch.autograd.grad(out, a, cot)
        return out.detach(), g

    (value, grad), (want_value, want_grad) = run(_mesh(3)), run(None)
    assert torch.equal(value, want_value)
    assert (grad - want_grad).abs().max() <= 1e-12 * want_grad.abs().max()


# ---------------------------------------------------------------------------
# reduce_noise_file on a mesh (test_streaming.py:278-316)
# ---------------------------------------------------------------------------
FILE_SR, FILE_N = 22050, 60000


@pytest.fixture
def wav(tmp_path):
    rng = _rng(3)
    t = np.arange(FILE_N) / FILE_SR
    y = (0.4 * np.sin(2 * np.pi * 440 * t) + rng.standard_normal(FILE_N) * 0.1).astype(
        np.float32)
    p = str(tmp_path / "in.wav")
    nrio.write_wav(p, y, FILE_SR, as_float=True)
    return p


@pytest.mark.parametrize("engine", list(ENGINES))
def test_file_on_mesh_matches_single_device(tmp_path, wav, engine):
    """7 chunks over 4 devices (an uneven tail round): bitwise the port's
    single-device stream, and within 2e-7 of the JAX package's file on
    ``chunk_mesh(4)``."""
    from noisereduce_tpu.parallel.mesh import chunk_mesh as j_chunk_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    kw = dict(chunk_size=9000, padding=1500, as_float=True, **ENGINES[engine])
    base, sharded, ref = (str(tmp_path / f"{n}.wav") for n in ("base", "mesh", "jax"))
    nrt.reduce_noise_file(wav, base, device="cpu", **kw)
    nrt.reduce_noise_file(wav, sharded, mesh=_mesh(4), device="cpu", **kw)
    jax_file(wav, ref, mesh=j_chunk_mesh(4), **kw)
    got = nrio.read_wav(sharded, dtype="float32")[1]
    np.testing.assert_array_equal(got, nrio.read_wav(base, dtype="float32")[1])
    np.testing.assert_allclose(got, nrio.read_wav(ref, dtype="float32")[1], atol=2e-7)


@pytest.mark.parametrize("n_chunks", [1, 3, 4, 7])
def test_pipeline_rounds_over_devices(n_chunks):
    """Chunk i goes to device i % n and its core; the writes come back in
    order, a short last round included."""
    rng = _rng(n_chunks)
    chunks = [(i, rng.integers(-2000, 2000, (2, 50)).astype(np.int16))
              for i in range(n_chunks)]
    cores = [lambda x, d=d: x[:, 5:45].to(torch.float32) * 2.0 + d for d in range(3)]
    written = []
    st._pipeline(iter(chunks), cores, (2, 40), torch.float32,
                 lambda a: written.append(a.copy()), [CPU] * 3)
    assert len(written) == n_chunks
    for (i, c), w in zip(chunks, written):
        np.testing.assert_array_equal(w, c[:, 5:45].astype(np.float32) * 2.0 + i % 3)


def test_extract_chunks_round_trip_through_a_mesh():
    """``shard_filter`` over extracted chunks of several rows is the
    unsharded filter (the identity here), and assembles on the chunks'
    device."""
    y = torch.as_tensor(_signal(37, 2 * 21000).reshape(2, 21000))
    chunks = extract_chunks(y, CHUNK, PADDING)
    out = shard_filter(lambda c: c.clone(), chunks, _mesh(4))
    assert out.device == chunks.device and torch.equal(out, chunks)
