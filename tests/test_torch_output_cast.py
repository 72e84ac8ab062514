"""PyTorch port: kernel H's plain version and the output dtype rule, on the
CPU (``ops/cuda/kernels.py::output_cast_ref``,
``parallel/transfer.py::output_dtype`` and ``to_output``).

- ``output_cast_ref`` is bitwise numpy's ``astype`` of the float32 output,
  the cast the JAX package returns (``noisereduce_tpu/api.py:630``), for
  int8, uint8, int16, uint16, int32 and float16: over an edge grid (+-0,
  +-0.5, +-0.9, each type's bounds +-0.5 and +-1, 2^15, 2^16, 2^31 and
  their float32 neighbours, 1e10, +-inf, NaNs with payloads, subnormals,
  float16's overflow and rounding ties) and seeded random values and bit
  patterns, in rows of several widths, at row offsets and row strides,
  and from bfloat16 cores (widened, exactly, first).
- ``output_cast`` on a CPU tensor is its plain version, into ``out`` too;
  it refuses a dtype it does not write.
- A Python twin of the kernel's units (``csrc/output_cast.cu``: VEC
  outputs laid from the output's own address) writes each output of a row
  exactly once, at every phase and width, each full unit's store aligned.
- ``HostSignal.out_dtype`` (``output_dtype``), one case per dtype: the
  rows' own for float64 and the dtypes H writes, float64 for the latter
  under float64 compute, float32 for the rest; ``to_output`` on the CPU.
- ``_finalize_reduce_output`` of a host tensor in the caller's dtype
  already (a mesh's signal of one chunk) returns its own memory.

The card side (the kernel itself, bitwise numpy's cast on the machine that
runs it, and the entry points' pinned int16 and float16 outputs) is held by
``tests/test_torch_cuda.py`` (marker ``gpu``). This file imports neither
JAX nor the JAX package.
"""
import numpy as np
import pytest
import torch

from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.parallel import transfer

torch.set_num_threads(2)

NARROW = {"int8": (np.int8, torch.int8), "uint8": (np.uint8, torch.uint8),
          "int16": (np.int16, torch.int16), "uint16": (np.uint16, torch.uint16),
          "int32": (np.int32, torch.int32), "float16": (np.float16, torch.float16)}


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def edge_grid() -> np.ndarray:
    """float32 values where a cast to an integer or float16 goes wrong
    first, each with its float32 neighbours."""
    base = [0.0, 0.5, 0.9, 1.0, 1.5, 2.5]
    for dt in (np.int8, np.uint8, np.int16, np.uint16, np.int32):
        info = np.iinfo(dt)
        for b in (float(info.min), float(info.max)):
            base += [b - 1, b - 0.5, b, b + 0.5, b + 1]
    base += [2.0**15, 2.0**16, 2.0**31, 2.0**32, 3e9, 1e10, 2147483520.0, 40000.5, 65535.5]
    # float16: its largest value, the overflow edge and the rounding ties of
    # a normal and a subnormal result
    base += [65504.0, 65519.0, 65520.0, 65536.0, 1 + 2.0**-11, 1 + 3 * 2.0**-11, 2.0**-14,
             2.0**-24, 2.0**-25, 3 * 2.0**-25, 2.0**-26, 1e-5]
    f = np.array(base, dtype=np.float32)
    f = np.concatenate([f, -f])
    f = np.concatenate([f, np.nextafter(f, np.float32(np.inf)),
                        np.nextafter(f, np.float32(-np.inf))])
    special = _f32([0x80000000, 0x7F800000, 0xFF800000,  # -0, +-inf
                    0x7FC00000, 0xFFC00000, 0x7FC0DD1D, 0x7F800001, 0xFF800001, 0x7F802000,
                    0x7F801FFF, 0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000,  # NaNs with payloads
                    0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x00400000])  # subnormals
    return np.concatenate([f, special])


def random_values(n: int, seed: int) -> np.ndarray:
    """Seeded float32 values over many magnitudes, and random bit
    patterns (NaN payloads, subnormals and infinities among them)."""
    rng = np.random.default_rng(seed)
    mag = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 12, size=n)
    out = mag.astype(np.float32)
    out[::3] = rng.integers(0, 2**32, size=len(out[::3]), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return out


def _layouts(values: np.ndarray):
    """(name, (rows, w) float32 tensor view) over ``values``: contiguous,
    one row, rows at an odd element offset, strided rows (row stride past
    the width), widths of 1 to 17 and odd."""
    def fill(rows, w, stride, offset):
        store = torch.full((offset + rows * stride,), float("nan"))
        view = store[offset:].view(rows, stride)[:, :w]
        n = rows * w
        view.copy_(torch.from_numpy(np.resize(values, n).reshape(rows, w)))
        return view

    return {
        "contiguous": fill(3, 1031, 1031, 0),
        "one-row": fill(1, 4099, 4099, 0),
        "row-offset": fill(5, 257, 260, 1),
        "strided-rows": fill(4, 333, 2 * 333 + 5, 3),
        "narrow": fill(7, 17, 19, 2),
        "width-1": fill(9, 1, 4, 1),
    }


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _numpy_cast(x: np.ndarray, dt) -> np.ndarray:
    with np.errstate(invalid="ignore", over="ignore"):
        return x.astype(dt)


@pytest.mark.parametrize("layout", list(_layouts(np.zeros(1, np.float32))))
@pytest.mark.parametrize("name", list(NARROW))
def test_output_cast_ref_is_numpys_astype(name, layout):
    """The edge grid and seeded random values through ``output_cast_ref``
    in each layout: bitwise numpy's ``astype`` of the same float32
    values."""
    np_dt, dt = NARROW[name]
    for values in (edge_grid(), random_values(20011, 180 + len(layout))):
        x = _layouts(values)[layout]
        got = K.output_cast_ref(x, dt)
        assert got.dtype == dt and got.shape == x.shape
        want = _numpy_cast(x.contiguous().numpy(), np_dt)
        assert np.array_equal(_bits(got.numpy()), _bits(want)), layout


@pytest.mark.parametrize("name", list(NARROW))
def test_output_cast_ref_widens_bfloat16_cores_first(name):
    """bfloat16 cores (the bf16 mode's output): numpy's cast of their exact
    float32 widening, the edge grid's bf16 roundings included."""
    np_dt, dt = NARROW[name]
    x = torch.from_numpy(np.concatenate([edge_grid(), random_values(4001, 181)]))
    b = x.to(torch.bfloat16)[None, 1:]  # a row off its start
    got = K.output_cast_ref(b, dt)
    want = _numpy_cast(b.float().numpy(), np_dt)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_output_cast_ref_keeps_the_documented_values():
    """The values numpy gives on x86 (40000.5 wraps to -25536 as int16;
    3e9, 1e10, +-inf and NaN give INT32_MIN, so 0 as int16, where a cast
    through CUDA's clamping cvt gives INT32_MAX and -1) and float16's NaN
    bits."""
    x = torch.tensor([[40000.5, -40000.7, 65535.5, 2147483520.0, float("nan"), float("inf"),
                       1e10, 3e9, -0.9]])
    assert K.output_cast_ref(x, torch.int16).tolist() == [[-25536, 25536, -1, -128, 0, 0, 0,
                                                           0, 0]]
    assert K.output_cast_ref(x, torch.uint8).tolist() == [[64, 192, 255, 128, 0, 0, 0, 0, 0]]
    assert K.output_cast_ref(x, torch.int32).tolist() == [[40000, -40000, 65535, 2147483520]
                                                          + [-2**31] * 4 + [0]]
    nan = torch.from_numpy(_f32([0x7FC0DD1D, 0x7F800001, 0xFF802000])[None].copy())
    got = K.output_cast_ref(nan, torch.float16).view(torch.int16).numpy().view(np.uint16)
    assert got.tolist() == [[0x7E06, 0x7C01, 0xFC01]]


@pytest.mark.parametrize("name", list(NARROW))
def test_output_cast_on_the_cpu_is_its_plain_version(name):
    """The wrapper on a CPU tensor: the plain version, 1-D and 2-D, into a
    given ``out`` too; no launch counted."""
    _, dt = NARROW[name]
    x = torch.from_numpy(random_values(3001, 182))
    K.reset_launch_counts()
    assert torch.equal(K.output_cast(x, dt).view(torch.uint8),
                       K.output_cast_ref(x, dt).view(torch.uint8))
    rows = x[:3000].view(3, 1000)[:, 1:]
    out = torch.empty((3, 999), dtype=dt)
    assert K.output_cast(rows, dt, out) is out
    assert torch.equal(out.view(torch.uint8), K.output_cast_ref(rows, dt).view(torch.uint8))
    assert K.launch_counts()["output_cast"] == 0


def test_output_cast_refuses_a_dtype_it_does_not_write():
    x = torch.zeros(2, 8)
    for dt in (torch.float32, torch.float64, torch.int64, torch.uint32, torch.bfloat16):
        with pytest.raises(TypeError):
            K.output_cast(x, dt)
    assert set(K.CAST_DTYPES) == {dt for _, dt in NARROW.values()}


VEC = 8  # csrc/output_cast.cu


@pytest.mark.parametrize("out_bytes", [1, 2, 4])
def test_units_cover_each_output_once(out_bytes):
    """A twin of the kernel's units: row r's unit u covers outputs
    [u VEC - phase, (u + 1) VEC - phase), phase the row's start in
    elements past a multiple of VEC, (w + VEC - 1) / VEC + 1 units a row.
    At every phase and width each output is written once, every unit
    inside [0, w) stores VEC outputs at an address aligned to VEC bytes
    at least, and the units past the row's ends store nothing."""
    for w in list(range(1, 40)) + [1031, 4099]:
        units = (w + VEC - 1) // VEC + 1
        for start in range(0, 2 * VEC * out_bytes, out_bytes):  # the row's address
            phase = (start // out_bytes) % VEC
            seen = np.zeros(w, dtype=int)
            for u in range(units):
                j0 = u * VEC - phase
                if j0 >= 0 and j0 + VEC <= w:
                    assert (start + j0 * out_bytes) % min(16, VEC * out_bytes) == 0
                seen[max(0, j0) : max(0, min(w, j0 + VEC))] += 1
            assert (seen == 1).all(), (w, start)


@pytest.mark.parametrize("rows", [np.float64, np.float32, np.float16, np.int8, np.uint8, np.int16,
                                  np.uint16, np.int32, np.uint32, np.int64, np.uint64, np.bool_])
def test_out_dtype_rule(rows):
    """A host signal's output dtype: float64 rows and the dtypes kernel H
    writes come back in their own dtype (float64 for the latter under the
    float64 parity mode, whose output numpy casts), every other dtype
    float32, in every compute dtype."""
    own = rows in (np.float64, np.float16, np.int8, np.uint8, np.int16, np.uint16, np.int32)
    for compute in (torch.float32, torch.bfloat16, torch.float64):
        hs = transfer.HostSignal(np.zeros((2, 10), dtype=rows), compute)
        want = hs.host_dtype if own else torch.float32
        if compute == torch.float64 and own:
            want = torch.float64
        assert hs.out_dtype == want, compute
        assert transfer.output_dtype(np.dtype(rows), compute) == want


def test_to_output_on_the_cpu():
    """``to_output``: the tensor itself in its own dtype, kernel H's plain
    version for a dtype it writes, torch's widening otherwise."""
    x = torch.from_numpy(random_values(999, 183)).view(3, 333)
    assert transfer.to_output(x, torch.float32) is x
    assert torch.equal(transfer.to_output(x, torch.float16).view(torch.int16),
                       K.output_cast_ref(x, torch.float16).view(torch.int16))
    wide = transfer.to_output(x, torch.float64)
    assert wide.dtype == torch.float64
    with np.errstate(invalid="ignore"):  # a signalling NaN's widening
        assert np.array_equal(wide.numpy(), x.numpy().astype(np.float64), equal_nan=True)
    b = x.to(torch.bfloat16)
    assert torch.equal(transfer.to_output(b, torch.float32).view(torch.int32),
                       b.float().view(torch.int32))


@pytest.mark.parametrize("name", list(NARROW))
def test_finalize_returns_an_output_in_the_callers_dtype_as_it_is(name):
    """``_finalize_reduce_output`` of a host tensor already in the caller's
    dtype (a mesh's signal of one chunk, narrowed on its device): that
    tensor's own memory, flat and 2-D."""
    from noisereduce_tpu_torch.api import _finalize_reduce_output

    np_dt, dt = NARROW[name]
    t = K.output_cast_ref(torch.from_numpy(random_values(1400, 184)).view(2, 700), dt)
    for flat, rows in ((False, t), (True, t[:1])):
        arr = _finalize_reduce_output(rows, np.dtype(np_dt), flat)
        assert arr.dtype == np_dt and arr.shape == ((700,) if flat else (2, 700))
        assert np.shares_memory(arr, rows.numpy())
