// Asynchronous copies of contiguous runs of plane elements into shared
// memory, and the persistent grid's size: shared by kernel A's walking
// builds (spectra_fft.cu, spectra_cplx.cu: a tile's signal span) and
// kernel D's real-FFT kernel (istft_fft.cu: a group's re/im/mask slab).
//
// A run of len elements goes as 16-byte cp.async copies wherever both its
// source and its place in shared memory lie on 16 bytes: element i lands at
// buf[ph + i], ph the source's phase in 16 bytes, so the two phases agree;
// the few elements before and after the 16-byte pieces go by plain loads.
// The copies are one commit group, waited for (cp.async.wait_all and a
// barrier) before any thread reads the run. Elements keep their raw bits
// (Raw<P>) and are widened to float32 where they are read.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "planes.cuh"

namespace nrs {

// the raw bits of a plane element
template <class P>
using Raw = std::conditional_t<sizeof(P) == 4, unsigned, unsigned short>;

__device__ __forceinline__ float widen_raw(unsigned b) { return __uint_as_float(b); }
__device__ __forceinline__ float widen_raw(unsigned short b) { return planes::widen(b); }

__device__ __forceinline__ void cp16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g));
}

// Elements of a run buffer for runs of up to len elements: the run, 16
// bytes of slack for its phase, rounded up to 16 bytes
template <class P>
__host__ __device__ constexpr int run_elems(int len) {
  constexpr int V = 16 / sizeof(Raw<P>);
  return (len + 2 * V - 1) / V * V;
}

// A block's copy of g[0, len) into buf (16-byte aligned, run_elems<P>(len)
// elements): elements [lo, hi) from device memory, the rest zero; element
// i at buf[ph + i], ph (returned) the phase of g in 16 bytes. Every thread
// of the block calls it.
template <class P, int THREADS>
__device__ __forceinline__ int issue_copy(const P* g, int lo, int hi, int len, Raw<P>* buf) {
  using R = Raw<P>;
  constexpr int V = 16 / sizeof(R);  // elements in 16 bytes
  const R* src = reinterpret_cast<const R*>(g);
  const int ph = (int)((unsigned long long)(size_t)src % 16 / sizeof(R));
  R* sp = buf + ph;
  const int h0 = min(hi, lo + (V - (ph + lo) % V) % V);  // first 16-byte boundary
  const int pieces = (hi - h0) / V;
  const int tail = h0 + pieces * V;  // the tail's first
  for (int i = threadIdx.x; i < pieces; i += THREADS) cp16(sp + h0 + i * V, src + h0 + i * V);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = threadIdx.x; i < lo; i += THREADS) sp[i] = 0;
  for (int i = hi + threadIdx.x; i < len; i += THREADS) sp[i] = 0;
  const int edge = (h0 - lo) + (hi - tail);
  if ((int)threadIdx.x < edge) {
    const int i = (int)threadIdx.x < h0 - lo ? lo + threadIdx.x : tail + (threadIdx.x - (h0 - lo));
    sp[i] = __ldg(src + i);
  }
  return ph;
}

// A tile of kernel A: view b, first frame t0, fe frames, its span of len
// samples from view position p0 (source sample s0 of the view's row)
struct Tile {
  int b, t0, fe, len;
  long long p0, s0;
};

__device__ __forceinline__ Tile tile_of(int tile, int n_tiles, int n_chunks, int tile_frames,
                                        int n_frames, int hop, int bpad, int win,
                                        long long chunk_stride, long long view_start) {
  Tile t;
  t.b = tile / n_tiles;
  t.t0 = (tile - t.b * n_tiles) * tile_frames;
  t.fe = min(tile_frames, n_frames - t.t0);
  t.len = (t.fe - 1) * hop + win;
  const int c = t.b - (t.b / n_chunks) * n_chunks;
  t.p0 = (long long)t.t0 * hop - bpad;
  t.s0 = c * chunk_stride + view_start + t.p0;
  return t;
}

// The samples [lo, hi) of tile t's span that lie inside the view and the
// signal (row sample s0 + i for span sample i); the rest read as zero
__device__ __forceinline__ void span_bounds(const Tile& t, int view_len, long long n_src, int& lo,
                                            int& hi) {
  lo = (int)min((long long)t.len, max(max(0LL, -t.p0), -t.s0));
  hi = (int)max((long long)lo, min(min((long long)t.len, view_len - t.p0), n_src - t.s0));
}

// A block's copy of tile t's span of row xr into buf: the samples inside
// the view and the signal from device memory, zero outside (the one-tile
// kernels' guarded load); the sample at view position p0 + i lands at
// buf[ph + i], ph returned.
template <class P, int THREADS>
__device__ __forceinline__ int issue_span(const P* __restrict__ xr, const Tile& t, int view_len,
                                          long long n_src, Raw<P>* buf) {
  int lo, hi;
  span_bounds(t, view_len, n_src, lo, hi);
  return issue_copy<P, THREADS>(xr + t.s0, lo, hi, t.len, buf);
}

// Blocks of `kernel` with smem bytes of dynamic shared memory and
// `threads` threads the current device holds at once (SMs x blocks an SM),
// cached by kernel, size and device; a negative CUDA error code if the
// query fails.
template <class K>
int active_blocks(K kernel, size_t smem, int threads) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int>, int> known;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), smem, dev);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  known[key] = sms * per_sm;
  return sms * per_sm;
}

}  // namespace nrs
