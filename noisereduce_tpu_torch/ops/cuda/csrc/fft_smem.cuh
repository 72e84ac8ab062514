// Shared-memory complex FFT core of the FFT route of kernels A (spectra_fft.cu)
// and D (istft_fft.cu), for a power-of-two real length N = 2M, 64 <= N <= 8192.
//
// A block holds up to ELEMS complex values in shared memory: n frames of M
// points each, frame f at logical index f*M, as float2 padded by one slot
// every 16 (pad()) against bank conflicts. Each segment of the block's
// threads (a warp, or the warps one frame needs) transforms its own frames.
// Each stage is a radix-R Stockham step
// (R = 8 while at least 8 points remain, then 4 or 2): a thread loads R
// points of one butterfly into registers, twiddles them, takes the R-point
// DFT in registers, and after a barrier stores them at the autosorted
// positions, so the output comes in natural order with no bit reversal.
// For sub-transform size ns and butterfly j < M/R:
//   load   v[r] = z[j + r*M/R]
//   twiddle v[r] *= e^{-+2 pi i (j mod ns) r / (ns R)}
//   store  z'[(j / ns) ns R + (j mod ns) + r ns] = DFT_R(v)[r]
// The twiddles come from a float32 table tw[k] = e^{-2 pi i k / N}, k < N,
// built in float64 on the host (no fast sincos intrinsics): a stage reads
// tw[2 q] with q = (j mod ns) r M / (ns R) < M; the inverse conjugates.
// FP32 throughout, no tensor cores: the FFT errs by about eps log2 N.
#pragma once

#include <cuda_runtime.h>

namespace nrf {

// must match noisereduce_tpu_torch/ops/cuda/geometry.py
constexpr int THREADS = 512;
// blocks an SM holds (at most 40 registers a thread; a few spill): more
// blocks in flight hide the global loads between a block's barriers
constexpr int MIN_BLOCKS = 3;
constexpr int ELEMS = 4096;  // complex values a block holds
constexpr int PADDED = ELEMS + ELEMS / 16;  // float2 slots after pad()

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
// a * (-i) for the forward transform, a * (+i) for the inverse
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = add(a0, a2), t1 = sub(a0, a2);
  const float2 t2 = add(a1, a3), t3 = rot<INV>(sub(a1, a3));
  a0 = add(t0, t2);
  a2 = sub(t0, t2);
  a1 = add(t1, t3);
  a3 = sub(t1, t3);
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = add(t, v[1]);
    v[1] = sub(t, v[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    constexpr float c = 0.70710678118654752440f;
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<INV>(e0, e1, e2, e3);
    dft4<INV>(o0, o1, o2, o3);
    // o_k *= W8^k, W8 = e^{-i pi/4} (conjugated for the inverse)
    o1 = INV ? make_float2(c * (o1.x - o1.y), c * (o1.x + o1.y))
             : make_float2(c * (o1.x + o1.y), c * (o1.y - o1.x));
    o2 = rot<INV>(o2);
    o3 = INV ? make_float2(-c * (o3.x + o3.y), c * (o3.x - o3.y))
             : make_float2(c * (o3.y - o3.x), -c * (o3.x + o3.y));
    v[0] = add(e0, o0);
    v[4] = sub(e0, o0);
    v[1] = add(e1, o1);
    v[5] = sub(e1, o1);
    v[2] = add(e2, o2);
    v[6] = sub(e2, o2);
    v[3] = add(e3, o3);
    v[7] = sub(e3, o3);
  }
}

// The threads of a block split into segments, each of which owns whole
// frames and runs their FFT alone: a segment of T threads owns T * PP
// consecutive points (PP = ELEMS / THREADS), T = one warp, or as many warps
// as one frame needs. A segment synchronises with __syncwarp or a named
// barrier of its own, so the FFT stages never wait for the whole block.
struct Seg {
  int log2t;  // log2 of the segment's threads
  int lane;   // thread index in the segment
  int id;     // segment index in the block
  int first;  // first point the segment owns
};

constexpr int PP = ELEMS / THREADS;  // points per thread
constexpr int LOG2PP = PP == 16 ? 4 : PP == 8 ? 3 : PP == 4 ? 2 : -1;
static_assert(LOG2PP > 0 && THREADS % 32 == 0, "4, 8 or 16 points a thread");

__device__ __forceinline__ Seg segment(int log2m) {
  Seg s;
  s.log2t = max(5, log2m - LOG2PP);
  s.lane = threadIdx.x & ((1 << s.log2t) - 1);
  s.id = threadIdx.x >> s.log2t;
  s.first = s.id << (s.log2t + LOG2PP);
  return s;
}

__device__ __forceinline__ void seg_sync(const Seg& s) {
  if (s.log2t == 5) {
    __syncwarp();
  } else {  // named barrier 1 + id (0 is __syncthreads'), 2^log2t threads
    asm volatile("bar.sync %0, %1;" ::"r"(1 + s.id), "r"(1 << s.log2t) : "memory");
  }
}

// One radix-R Stockham stage over the segment's frames among the first
// n_frames, in place: every thread loads its butterflies, then (after the
// segment's barrier) stores them. Called by every thread of the segment.
template <int R, bool INV>
__device__ __forceinline__ void stage(float2* z, int log2m, int ns, int n_frames,
                                      const float2* __restrict__ tw, const Seg& sg) {
  constexpr int P = PP / R;  // butterflies per thread
  constexpr int LOG2R = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int M = 1 << log2m;
  const int log2mr = log2m - LOG2R;
  const int mr = 1 << log2mr;
  const int n_bfly = n_frames << log2mr;
  const int bfly0 = sg.first >> LOG2R;  // the segment's first butterfly
  const int tstep = 2 * (M / (ns * R));  // tw index step per (j mod ns) * r
  float2 v[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = bfly0 + sg.lane + (p << sg.log2t);
    if (idx < n_bfly) {
      const int f = idx >> log2mr;
      const int j = idx & (mr - 1);
      const int base = f * M + j;
#pragma unroll
      for (int r = 0; r < R; ++r) v[p][r] = z[pad(base + r * mr)];
      const int jm = j & (ns - 1);
      if (jm) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          float2 w = __ldg(tw + jm * r * tstep);
          if (INV) w.y = -w.y;
          v[p][r] = cmul(v[p][r], w);
        }
      }
      dft<R, INV>(v[p]);
    }
  }
  seg_sync(sg);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = bfly0 + sg.lane + (p << sg.log2t);
    if (idx < n_bfly) {
      const int f = idx >> log2mr;
      const int j = idx & (mr - 1);
      const int jm = j & (ns - 1);
      const int d = f * M + (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) z[pad(d + r * ns)] = v[p][r];
    }
  }
  seg_sync(sg);
}

// The M-point complex DFT (INV: the unscaled inverse) of the segment's
// frames among the first n_frames, in place, natural order in and out. The
// caller has synchronised the segment after filling its frames; they are
// synchronised on return.
template <bool INV>
__device__ __forceinline__ void fft_frames(float2* z, int log2m, int n_frames,
                                           const float2* __restrict__ tw,
                                           const Seg& sg) {
  const int M = 1 << log2m;
  for (int ns = 1; ns < M;) {
    const int left = M / ns;
    if (left >= 8) {
      stage<8, INV>(z, log2m, ns, n_frames, tw, sg);
      ns *= 8;
    } else if (left == 4) {
      stage<4, INV>(z, log2m, ns, n_frames, tw, sg);
      ns *= 4;
    } else {
      stage<2, INV>(z, log2m, ns, n_frames, tw, sg);
      ns *= 2;
    }
  }
}

}  // namespace nrf
