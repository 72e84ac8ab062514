// Kernel C: freq_smooth_blend — frequency smoothing of the mask, then the
// non-stationary prop_decrease blend.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_freq_smooth_blend_phase
// (:906), with the band of geometry.py::_tile_band_np (:187).
//
//   s[t, k]   = sum_d taps[d] m[t, k + d - n],  zero outside [0, n_bins)
//   out[t, k] = s[t, k] * prop + (1 - prop)       (blend AFTER smoothing)
//
// Bound on this card: bytes (one plane read, one written; 2n+1 FMAs per
// element). Design: one block per (row, frame): the frame's bins plus an
// n-bin zero halo each side are staged once in shared memory, so every tap
// reads shared memory and the row is read from device memory once. The TPU
// kernel did this as a banded 128 x 128 MXU dot per lane tile, with halo
// lanes to keep the support tile-local; the exact plane here has no tiles
// and no padded frames, so nothing is re-zeroed afterwards.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
    freq_smooth_blend_kernel(const float* __restrict__ in,
                             float* __restrict__ out,
                             const float* __restrict__ taps, int n_taps,
                             int n_bins, float prop) {
  extern __shared__ float srow[];  // n_bins + n_taps - 1
  const int half = n_taps / 2;
  const long long base = (long long)blockIdx.x * n_bins;
  for (int i = threadIdx.x; i < n_bins + 2 * half; i += blockDim.x) {
    const int k = i - half;
    srow[i] = (k >= 0 && k < n_bins) ? in[base + k] : 0.f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < n_taps; ++d) acc = fmaf(__ldg(taps + d), srow[k + d], acc);
    out[base + k] = fmaf(acc, prop, 1.f - prop);
  }
}

}  // namespace

// in/out: (n_rows, n_bins) f32 (n_rows = rows * n_frames); taps: (n_taps,)
// f32, n_taps odd. Returns cudaGetLastError() after the launch.
extern "C" int nr_freq_smooth_blend(const float* in, float* out,
                                    const float* taps, int n_taps,
                                    long long n_rows, int n_bins, float prop,
                                    void* stream) {
  const size_t smem = (size_t)(n_bins + n_taps - 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        freq_smooth_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_rows <= 0) return (int)cudaGetLastError();
  freq_smooth_blend_kernel<<<(unsigned)n_rows, 128, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      in, out, taps, n_taps, n_bins, prop);
  return (int)cudaGetLastError();
}
