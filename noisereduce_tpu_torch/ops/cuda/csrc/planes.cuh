// Plane loads and stores of kernels A, B, D, E and F, in float32 or
// bfloat16 (the bf16 mode, ``compute_dtype=torch.bfloat16``).
//
// A plane element comes into registers as float32 and all the arithmetic
// stays float32 (float64 where a kernel carries in float64); a store rounds
// to the plane's type, to nearest even for bfloat16. So a bf16 kernel
// computes its float32 twin's function on the same (exactly widened)
// inputs and rounds once where it stores: kernel A's re/im planes, kernel
// D's output. The masks stay float32, as the JAX package keeps them.
//
// For float the load is the __ldg and the store the plain store the float32
// kernels always made, so their builds are the same code as before.
//
// with_plane(code, f): the entries take the plane type as an int
// (kernels.py::_PLANE_CODE: 0 float32, 1 bfloat16) and call f with a tag
// of the type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace planes {

using bf16 = __nv_bfloat16;

template <class T>
struct Of {
  using type = T;
};

template <class F>
int with_plane(int code, F f) {
  switch (code) {
    case 0: return f(Of<float>());
    case 1: return f(Of<bf16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// bfloat16 is the high half of a float32: widening is a shift, exact
__device__ __forceinline__ float widen(unsigned bits) { return __uint_as_float(bits << 16); }

// The bits of a bfloat16 element, not yet widened: a loop that loads a
// batch of elements before it uses any widens each one where it is used,
// so no instruction waits on a load before the batch's later loads have
// gone out (time_tiles.cuh::walk).
__device__ __forceinline__ unsigned ld_bits(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ float ld(const bf16* p) { return widen(ld_bits(p)); }

// The aligned 4-byte word that holds the bfloat16 element at p (cp.async
// copies 4, 8 or 16 bytes, not 2), and the element taken out of that word,
// widened: `high` is bit 1 of the element's address, which makes it the
// word's upper half (little-endian). At a plane's first or last element
// the word reaches 2 bytes outside the plane, but it lies in the element's
// own 32-byte sector and page, so the read never touches unmapped memory;
// element_of drops those bytes.
__device__ __forceinline__ const unsigned* word_of(const bf16* p) {
  return reinterpret_cast<const unsigned*>(reinterpret_cast<size_t>(p) & ~(size_t)3);
}

__device__ __forceinline__ float element_of(unsigned word, unsigned high) {
  // PRMT: bytes 0, 1 of the result zero (selector 4, the zero operand);
  // bytes 2, 3 the element's two bytes (0, 1 low half, 2, 3 high half)
  return __uint_as_float(__byte_perm(word, 0u, high ? 0x3244u : 0x1044u));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

}  // namespace planes
