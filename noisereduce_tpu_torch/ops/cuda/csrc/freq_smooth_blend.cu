// Kernel C: freq_smooth_blend — frequency smoothing of the mask, then the
// non-stationary prop_decrease blend.
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
// Design (geometry.py::freq_smooth_plan). The plane is cut into spans of
// `lines` whole lines, consecutive (row, frame) lines of the flat plane,
// about 16 KB each. Persistent blocks, as many as the SMs hold at once,
// walk the spans (block b takes spans b, b + grid, ...) through a
// two-stage pipeline: a block issues span s + 1's copies into its second
// input plane (cp.async, 16 bytes each, L2 only) before it smooths span s
// from the first, so the next span's loads are in flight while this one
// is computed. A line of 513 floats is 2,052 bytes, so a span's first
// 16-byte boundary is taken from the tensor's own address, and the few
// floats before it and after the last go as 4-byte copies. An input plane
// starts the same number of words past a 16-byte boundary as its span, so
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
// Outputs go to an output plane in shared memory, aligned to the output's
// address, and leave in 16-byte streaming stores once the span is done.
//
// Measured on an H100 80GB HBM3 (700 W; PERF.md, PR 11): 0.301-0.303 ms at
// the headline (77 x 2,579 x 513), 80% of the memory rate, where one block
// a span with no asynchronous copies (design (a),
// tools/variants/freq_smooth_blend_spans.cu) took 0.353: there a block
// loads, waits, computes and stores in turn, and four blocks an SM (63
// registers) do not hide that.
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
constexpr int MIN_BLOCKS = 4;  // blocks an SM must hold: at most 64 registers

// Words from p back to the 16-byte boundary at or before it.
__device__ __forceinline__ int phase(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The floats of [0, n) before g's first 16-byte boundary, and after its last.
__device__ __forceinline__ int head_of(const float* g, int n) { return min(n, (4 - phase(g)) & 3); }

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

__device__ __forceinline__ void cp16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g));
}

__device__ __forceinline__ void cp4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g));
}

// Issue n floats from g to s (same phase) as cp.async copies.
__device__ __forceinline__ void issue(const float* __restrict__ g, float* s, int n) {
  const int head = head_of(g, n), pieces = (n - head) / 4;
  for (int i = threadIdx.x; i < pieces; i += THREADS) cp16(s + head + 4 * i, g + head + 4 * i);
  const int t = threadIdx.x;
  if (t < n - 4 * pieces) {
    const int i = t < head ? t : t + 4 * pieces;
    cp4(s + i, g + i);
  }
}

// Persistent blocks: block b takes spans b, b + gridDim.x, ... Shared
// memory: the taps, two input planes and the output plane, `cap` words each.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    freq_smooth_blend_kernel(const float* __restrict__ in, float* __restrict__ out,
                             const float* __restrict__ taps, int n_taps, int half,
                             long long n_rows, int n_bins, int lines, int cap,
                             long long spans, float prop) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);
  float* const planes[2] = {st + n_taps, st + n_taps + cap};
  float* const sout = st + n_taps + 2 * cap;
  for (int i = threadIdx.x; i < n_taps; i += THREADS) st[i] = taps[i];
  const int per_line = (n_bins + RUN - 1) / RUN;
  auto issue_span = [&](long long s, float* plane) {
    const long long r0 = s * lines;
    const int n = (int)min((long long)lines, n_rows - r0) * n_bins;
    const float* g = in + r0 * n_bins;
    issue(g, plane + phase(g), n);
  };
  int b = 0;
  if (blockIdx.x < spans) issue_span(blockIdx.x, planes[0]);
  asm volatile("cp.async.commit_group;\n" ::);
  for (long long s = blockIdx.x; s < spans; s += gridDim.x, b ^= 1) {
    if (s + gridDim.x < spans) issue_span(s + gridDim.x, planes[b ^ 1]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const long long r0 = s * lines;
    const int nl = (int)min((long long)lines, n_rows - r0);
    const long long g0 = r0 * n_bins;
    float* so = sout + phase(out + g0);
    smooth_runs(planes[b] + phase(in + g0), so, st, n_taps, half, n_bins, nl * per_line,
                threadIdx.x, THREADS, prop);
    __syncthreads();
    unstage(so, out + g0, nl * n_bins);
  }
}

}  // namespace

// in/out: (n_rows, n_bins) f32 (n_rows = rows * n_frames), any 4-byte
// alignment; taps: (n_taps,) f32, n_taps a multiple of GROUP, zero padded
// past the 2 half + 1 live taps; lines: the plan's lines a span. The grid
// is the blocks every SM holds at once. Returns cudaGetLastError() after
// the launch.
extern "C" int nr_freq_smooth_blend(const float* in, float* out, const float* taps, int n_taps,
                                    int half, long long n_rows, int n_bins, int lines,
                                    float prop, void* stream) {
  const int cap = (lines * n_bins + 3) / 4 * 4 + 4;
  const size_t smem = (size_t)(n_taps + 3 * cap) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        freq_smooth_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_rows <= 0) return (int)cudaGetLastError();
  const long long spans = (n_rows + lines - 1) / lines;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, freq_smooth_blend_kernel, THREADS,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = min(spans, (long long)sms * (per_sm > 0 ? per_sm : 1));
  freq_smooth_blend_kernel<<<(unsigned)grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      in, out, taps, n_taps, half, n_rows, n_bins, lines, cap, spans, prop);
  return (int)cudaGetLastError();
}
