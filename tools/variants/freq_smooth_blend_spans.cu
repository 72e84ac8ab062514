// Kernel C: freq_smooth_blend, design (a): one block a span, no
// asynchronous copies, occupancy hiding the latency. A variant for
// tools/mask_tiles_variants.py (`c_span_blocks`), which copies it over
// csrc/freq_smooth_blend.cu in a copy of the package. The package ships
// design (b), persistent blocks with a cp.async pipeline, which took
// 0.301-0.303 ms at the headline on an H100 80GB HBM3 (700 W) where this
// one took 0.353 (PERF.md, PR 11). Its smooth_runs is the same as (b)'s.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_freq_smooth_blend_phase
// (:906), with the band of geometry.py::_tile_band_np (:187).
//
//   s[t, k]   = sum_d taps[d] m[t, k + d - half],  zero outside [0, n_bins)
//   out[t, k] = s[t, k] * prop + (1 - prop)       (blend AFTER smoothing)
//
// Bound on this card: bytes. The function reads the plane once and writes
// it once; its FP32 work (11 taps at the headline) is a seventh of that
// time, so the design streams: every byte moves in 16-byte accesses and
// each output costs about one FMA a tap and little else.
//
// Design (geometry.py::freq_smooth_plan). A block takes a span of `lines`
// whole lines, consecutive (row, frame) lines of the flat plane, about
// 16 KB. It stages the span in shared memory in 16-byte loads along the
// flat plane; a line of 513 floats is 2,052 bytes, so the span's first
// 16-byte boundary is taken from the tensor's own address, and the few
// floats before it and after the last go one a thread. The shared plane
// starts the same number of words past a 16-byte boundary as the span, so
// 16-byte pieces of the span are 16-byte pieces of shared memory.
//
// Each thread then computes runs of RUN consecutive outputs of one line,
// the runs numbered along the span (a line's last run may be short; no
// other lane idles). A run holds its outputs in registers and walks the
// taps in groups of GROUP: for each group a window of RUN + GROUP - 1
// inputs comes from shared memory into registers, zero outside
// [0, n_bins) by its index in the line (the halo never reaches into the
// next line), and takes RUN x GROUP FMAs; so shared memory is read about
// (RUN + GROUP - 1) / RUN times an output, not once a tap. RUN is odd, so
// the 32 runs of a warp start in 32 different banks. The taps sit in
// shared memory, zero padded to a multiple of GROUP, and are read four at
// a time as a broadcast. Any number of taps works in the same loop; the
// host drops the taps that reach past a whole line on either side (they
// only ever meet the zero fill), so 641 taps on 257 bins run as 513.
// Outputs go to a second shared plane, aligned to the output's address,
// and leave in 16-byte stores once the block is done.
//
// Every output sums its products in tap order from a zero accumulator,
// whatever span or run it lands in (a padded tap adds an exact zero), so
// the output is the same bits from run to run and under any grouping of
// the rows.
//
// The TPU kernel did this as a banded 128 x 128 MXU dot per lane tile;
// tensor cores would round the mask to TF32 and save time the memory
// already hides.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // a block (geometry.py's FS_THREADS)
constexpr int RUN = 9;         // outputs a run (geometry.py's FS_RUN; odd)
constexpr int GROUP = 12;      // taps a group (geometry.py's FS_GROUP; a multiple of 4)
constexpr int UNROLL = 4;      // 16-byte loads a thread issues before it stores any
constexpr int MIN_BLOCKS = 4;  // blocks an SM must hold: at most 64 registers

// Words from p back to the 16-byte boundary at or before it.
__device__ __forceinline__ int phase(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The floats of [0, n) before g's first 16-byte boundary, and after its last.
__device__ __forceinline__ int head_of(const float* g, int n) { return min(n, (4 - phase(g)) & 3); }

// n floats from device memory g to shared memory s, s and g at the same
// phase: 16-byte loads, UNROLL of them in flight a thread; the head and
// tail one a thread.
__device__ __forceinline__ void stage(const float* __restrict__ g, float* s, int n) {
  const int head = head_of(g, n), pieces = (n - head) / 4;
  const float4* gv = reinterpret_cast<const float4*>(g + head);
  float4* sv = reinterpret_cast<float4*>(s + head);
  for (int i0 = threadIdx.x; i0 < pieces; i0 += THREADS * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * THREADS < pieces) v[u] = __ldcs(gv + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * THREADS < pieces) sv[i0 + u * THREADS] = v[u];
  }
  const int t = threadIdx.x;
  if (t < n - 4 * pieces) {
    const int i = t < head ? t : t + 4 * pieces;
    s[i] = __ldcs(g + i);
  }
}

// n floats from shared memory s to device memory g, at the same phase.
__device__ __forceinline__ void unstage(const float* s, float* __restrict__ g, int n) {
  const int head = head_of(g, n), pieces = (n - head) / 4;
  const float4* sv = reinterpret_cast<const float4*>(s + head);
  float4* gv = reinterpret_cast<float4*>(g + head);
  for (int i = threadIdx.x; i < pieces; i += THREADS) __stcs(gv + i, sv[i]);
  const int t = threadIdx.x;
  if (t < n - 4 * pieces) {
    const int i = t < head ? t : t + 4 * pieces;
    __stcs(g + i, s[i]);
  }
}

// Runs [first, runs) by `step` of the span staged at si (lines of n_bins),
// their blended outputs to so.
__device__ __forceinline__ void smooth_runs(const float* si, float* so, const float* taps,
                                            int n_taps, int half, int n_bins, int runs,
                                            int first, int step, float prop) {
  const int per_line = (n_bins + RUN - 1) / RUN;
  for (int r = first; r < runs; r += step) {
    const int line = r / per_line;
    const int k0 = (r - line * per_line) * RUN;
    const float* row = si + line * n_bins;
    float acc[RUN];
#pragma unroll
    for (int v = 0; v < RUN; ++v) acc[v] = 0.f;
    for (int d0 = 0; d0 < n_taps; d0 += GROUP) {
      const int p0 = k0 - half + d0;
      float w[RUN + GROUP - 1];
#pragma unroll
      for (int i = 0; i < RUN + GROUP - 1; ++i) {
        const int p = p0 + i;
        float x = 0.f;
        if ((unsigned)p < (unsigned)n_bins) x = row[p];
        w[i] = x;
      }
#pragma unroll
      for (int q = 0; q < GROUP; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(taps + d0 + q);
#pragma unroll
        for (int v = 0; v < RUN; ++v) {
          acc[v] = fmaf(t.x, w[v + q], acc[v]);
          acc[v] = fmaf(t.y, w[v + q + 1], acc[v]);
          acc[v] = fmaf(t.z, w[v + q + 2], acc[v]);
          acc[v] = fmaf(t.w, w[v + q + 3], acc[v]);
        }
      }
    }
    float* o = so + line * n_bins + k0;
    const float keep = 1.f - prop;
#pragma unroll
    for (int v = 0; v < RUN; ++v)
      if (k0 + v < n_bins) o[v] = fmaf(acc[v], prop, keep);
  }
}

// One block a span of `lines` lines. Shared memory: the taps (n_taps, a
// multiple of GROUP), then the input plane and the output plane, `cap`
// words each (a span plus the phase slack).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    freq_smooth_blend_kernel(const float* __restrict__ in, float* __restrict__ out,
                             const float* __restrict__ taps, int n_taps, int half,
                             long long n_rows, int n_bins, int lines, int cap, float prop) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);
  const long long r0 = (long long)blockIdx.x * lines;
  const int nl = (int)min((long long)lines, n_rows - r0);
  const int n = nl * n_bins;
  const long long g0 = r0 * n_bins;
  float* si = st + n_taps + phase(in + g0);
  float* so = st + n_taps + cap + phase(out + g0);
  for (int i = threadIdx.x; i < n_taps; i += THREADS) st[i] = taps[i];
  stage(in + g0, si, n);
  __syncthreads();
  smooth_runs(si, so, st, n_taps, half, n_bins, nl * ((n_bins + RUN - 1) / RUN), threadIdx.x,
              THREADS, prop);
  __syncthreads();
  unstage(so, out + g0, n);
}

}  // namespace

// in/out: (n_rows, n_bins) f32 (n_rows = rows * n_frames), any 4-byte
// alignment; taps: (n_taps,) f32, n_taps a multiple of GROUP, zero padded
// past the 2 half + 1 live taps; lines: the plan's lines a span. Returns
// cudaGetLastError() after the launch.
extern "C" int nr_freq_smooth_blend(const float* in, float* out, const float* taps, int n_taps,
                                    int half, long long n_rows, int n_bins, int lines,
                                    float prop, void* stream) {
  const int cap = (lines * n_bins + 3) / 4 * 4 + 4;
  const size_t smem = (size_t)(n_taps + 2 * cap) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        freq_smooth_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_rows <= 0) return (int)cudaGetLastError();
  const long long spans = (n_rows + lines - 1) / lines;
  freq_smooth_blend_kernel<<<(unsigned)spans, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      in, out, taps, n_taps, half, n_rows, n_bins, lines, cap, prop);
  return (int)cudaGetLastError();
}
