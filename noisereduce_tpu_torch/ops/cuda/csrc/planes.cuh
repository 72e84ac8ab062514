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
__device__ __forceinline__ float ld(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

}  // namespace planes
