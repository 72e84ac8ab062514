// Kernel H: output_cast — a call's gated output narrowed on the card to an
// integer or float16 caller's dtype, giving numpy's cast of the float32
// output on x86.
//
// Replaces no TPU kernel. The JAX package returns numpy's
// `out.astype(out_dtype)` of its float32 output, on the host
// (noisereduce_tpu/api.py:630). Run there on the host of an H100 80GB
// HBM3, that cast took 50-57 ms of the int16 headline's 68-88 ms wall
// (92.2 MB written on one thread, into a fresh array, first-touch faults
// included; PERF.md, section 5). Here the
// cores are narrowed where they are, so the D2H moves the narrow bytes
// (half of float32's for int16) straight into the call's pinned output
// and the host casts nothing.
//
// The rule, element by element, from x = the float32 output (a bfloat16
// core widened first, exactly):
//
//   int32                       x NaN, x >= 2^31 or x < -2^31: INT32_MIN
//                               (x86's "integer indefinite", which
//                               cvttss2si gives); else x truncated toward 0
//   int8, uint8, int16, uint16  the low 8 or 16 bits of that int32 (numpy
//                               casts float32 to these through a 32-bit
//                               truncation: 40000.5 gives -25536 as int16)
//   float16                     round to nearest even, overflow to +-inf; a
//                               NaN keeps its sign and the top 10 bits of
//                               its payload, with at least one bit set
//                               (numpy's npy_floatbits_to_halfbits)
//
// Nothing here relies on cvt's saturation. CUDA's float-to-integer
// conversion (cvt.rzi) clamps to its destination's range and takes NaN to
// 0, so a cast through it parts from numpy's past int32's range and at NaN
// and infinities: `tensor.to` on the card gives 3e9 as INT32_MAX (int32),
// -1 (int16) and 24064 (uint16), where numpy gives INT32_MIN, 0 and 0
// (PERF.md, section 6). So the range test and the wrap are written out,
// and cvt.rzi only ever sees a value in range.
//
// Bound on this card: bytes. Each element is read once (4 bytes, 2 for
// bfloat16) and written once (1-4 bytes) with a few integer operations in
// between; at the int16 headline that is 184.3 MB read and 92.2 MB written,
// about 0.083 ms at 3.35 TB/s. So the design only streams: a grid-stride
// pass over units of VEC = 8 consecutive outputs of one row, each thread
// loading 16 or 32 bytes and storing 8, 16 or 32. A row's units are laid
// from the output's own address, so every full unit's store is aligned
// (8 bytes for a 1-byte type, 16 otherwise); a unit whose input is
// aligned too loads 16 bytes at a time, any other loads element by
// element, and a row's first and last units (partly outside [0, w)) store
// element by element. So any row stride (the last piece's cores cut to the
// signal's length), odd widths and row offsets run through the same loop.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;             // outputs a unit
constexpr int BLOCKS_PER_SM = 8;   // a full SM of 2,048 threads

// the output types (kernels.py::_CAST_CODE)
enum Out { I8 = 0, U8 = 1, I16 = 2, U16 = 3, I32 = 4, F16 = 5 };

template <int OUT>
struct Width {
  static constexpr int bytes = OUT == I32 ? 4 : (OUT == I8 || OUT == U8) ? 1 : 2;
};

__device__ __forceinline__ int numpy_int32(float x) {
  // false for NaN too
  return (x >= -2147483648.0f && x < 2147483648.0f) ? __float2int_rz(x) : INT32_MIN;
}

__device__ __forceinline__ unsigned numpy_half(float x) {
  const unsigned f = __float_as_uint(x);
  if ((f & 0x7fffffffu) > 0x7f800000u) {
    unsigned h = 0x7c00u | ((f & 0x007fffffu) >> 13);
    h += (h == 0x7c00u);  // a payload only in the low 13 bits: still a NaN
    return ((f >> 16) & 0x8000u) | h;
  }
  return __half_as_ushort(__float2half_rn(x));
}

// the output element's bits, in the low Width<OUT>::bytes bytes
template <int OUT>
__device__ __forceinline__ unsigned bits_of(float x) {
  if (OUT == F16) return numpy_half(x);
  const unsigned i = (unsigned)numpy_int32(x);
  return Width<OUT>::bytes == 1 ? (i & 0xffu) : Width<OUT>::bytes == 2 ? (i & 0xffffu) : i;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// VEC inputs from p, aligned to 16 bytes: two float4 or one uint4 of bfloat16
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_vec(const planes::bf16* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = planes::widen(w[k] & 0xffffu);
    v[2 * k + 1] = planes::widen(w[k] >> 16);
  }
}

// VEC outputs' bits into p, aligned to 8 bytes (1-byte types) or 16
template <int OUT>
__device__ __forceinline__ void store_vec(unsigned char* p, const unsigned* b) {
  if (Width<OUT>::bytes == 1) {
    *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                                              b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
  } else if (Width<OUT>::bytes == 2) {
    *reinterpret_cast<uint4*>(p) = make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16,
                                              b[4] | b[5] << 16, b[6] | b[7] << 16);
  } else {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(b[4], b[5], b[6], b[7]);
  }
}

template <int OUT>
__device__ __forceinline__ void store_one(unsigned char* p, unsigned b) {
  if (Width<OUT>::bytes == 1) *p = (unsigned char)b;
  else if (Width<OUT>::bytes == 2) *reinterpret_cast<unsigned short*>(p) = (unsigned short)b;
  else *reinterpret_cast<unsigned*>(p) = b;
}

// (rows, w) inputs, row r at in + r * in_stride elements, into (rows, w)
// outputs at out + r * out_stride elements. Unit u of row r covers outputs
// [u VEC - phase_r, (u + 1) VEC - phase_r), phase_r the row's start in
// elements past a multiple of VEC of the output's bytes; `units` a row.
template <class In, int OUT>
__global__ void __launch_bounds__(THREADS)
output_cast_kernel(const In* __restrict__ in, long long in_stride,
                   unsigned char* __restrict__ out, long long out_stride, long long rows,
                   long long w, long long units) {
  constexpr int OB = Width<OUT>::bytes;
  const long long total = rows * units;
  for (long long t = blockIdx.x * (long long)THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * THREADS) {
    const long long r = t / units;
    const long long u = t - r * units;
    const In* src = in + r * in_stride;
    unsigned char* dst = out + r * out_stride * OB;
    const int phase = (int)((reinterpret_cast<uintptr_t>(dst) / OB) % VEC);
    const long long j0 = u * VEC - phase;
    unsigned b[VEC];
    if (j0 >= 0 && j0 + VEC <= w) {
      float v[VEC];
      if (aligned16(src + j0)) {
        load_vec(src + j0, v);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = planes::ld(src + j0 + k);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) b[k] = bits_of<OUT>(v[k]);
      store_vec<OUT>(dst + j0 * OB, b);
    } else {
      const long long lo = j0 < 0 ? 0 : j0;
      const long long hi = j0 + VEC < w ? j0 + VEC : w;
      for (long long j = lo; j < hi; ++j)
        store_one<OUT>(dst + j * OB, bits_of<OUT>(planes::ld(src + j)));
    }
  }
}

template <class In, int OUT>
int launch(const void* in, long long in_stride, void* out, long long out_stride, long long rows,
           long long w, cudaStream_t stream) {
  const long long units = (w + VEC - 1) / VEC + 1;  // any phase
  const long long total = rows * units;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long want = (total + THREADS - 1) / THREADS;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  const long long grid = want < most ? want : most;
  output_cast_kernel<In, OUT><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const In*>(in), in_stride, static_cast<unsigned char*>(out), out_stride, rows,
      w, units);
  return (int)cudaGetLastError();
}

}  // namespace

// plane: the input's type (planes.cuh: 0 float32, 1 bfloat16); out_code:
// the output's (Out); strides in elements between rows, each row's
// elements adjacent.
extern "C" int nr_output_cast(int plane, const void* in, long long in_stride, int out_code,
                              void* out, long long out_stride, long long rows, long long w,
                              void* stream) {
  if (rows <= 0 || w <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return planes::with_plane(plane, [&](auto tag) -> int {
    using In = typename decltype(tag)::type;
    switch (out_code) {
      case I8: return launch<In, I8>(in, in_stride, out, out_stride, rows, w, s);
      case U8: return launch<In, U8>(in, in_stride, out, out_stride, rows, w, s);
      case I16: return launch<In, I16>(in, in_stride, out, out_stride, rows, w, s);
      case U16: return launch<In, U16>(in, in_stride, out, out_stride, rows, w, s);
      case I32: return launch<In, I32>(in, in_stride, out, out_stride, rows, w, s);
      case F16: return launch<In, F16>(in, in_stride, out, out_stride, rows, w, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
