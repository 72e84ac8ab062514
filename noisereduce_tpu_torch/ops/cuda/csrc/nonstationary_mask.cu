// Kernel B: nonstationary_mask — filtfilt noise floor, sigmoid mask and
// time smoothing.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_am_kernel phase 3
// (:443-525, IIR floor + sigmoid) and ::_time_smooth_phase (:375).
//
// Per (row, bin) column of the time-major spectra:
//   |Z|[t]  = sqrt(re^2 + im^2)
//   y[0] = |Z|[0],      y[t] = b |Z|[t] + (1-b) y[t-1]      (forward)
//   w[T-1] = y[T-1],    w[t] = b y[t] + (1-b) w[t+1]         (backward)
//   raw[t] = sigmoid(((|Z|[t] - w[t]) / w'[t] - thresh) * slope),
//            w' = w with zeros replaced by 1 (silence gives finite zeros)
//   out[t] = sum_d taps[d] raw[t + d - n],  zero outside [0, n_frames)
//
// Bound on this card: bytes. Each element is a handful of FLOPs; the kernel
// reads re/im twice and streams the floor and the raw mask through a scratch
// plane (9 plane passes, about 3.7 GB at the 960 s headline shape).
// Design: one thread per (row, bin), neighbouring threads on neighbouring
// bins so every warp access is one coalesced 128-byte row segment, and the
// IIR carry runs down the column in a register. The TPU kernel keeps the whole
// column tile in 5.5 MB of VMEM and runs the recurrence as lower-triangular
// block dots; 227 KB of shared memory cannot hold a column tile, and a column
// per thread needs no cross-block carry at all. The columns are independent,
// so there is no cap on the time-smoothing width.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(128)
    nonstationary_mask_kernel(const float* __restrict__ re,
                              const float* __restrict__ im,
                              float* __restrict__ scratch,
                              float* __restrict__ out,
                              const float* __restrict__ taps, int n_taps,
                              int rows, int n_frames, int n_bins, float b,
                              float thresh, float slope) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * n_bins) return;
  const int row = (int)(idx / n_bins);
  const int f = (int)(idx - (long long)row * n_bins);
  const long long base = (long long)row * n_frames * n_bins + f;
  const float a = 1.f - b;

  // forward pass: the floor y goes to the scratch plane
  float y = 0.f;
  for (int t = 0; t < n_frames; ++t) {
    const long long o = base + (long long)t * n_bins;
    const float zr = __ldg(re + o);
    const float zi = __ldg(im + o);
    const float mag = sqrtf(zr * zr + zi * zi);
    y = (t == 0) ? mag : fmaf(a, y, b * mag);
    scratch[o] = y;
  }

  // backward pass: the zero-phase floor w, then the raw mask over y in place
  float w = 0.f;
  for (int t = n_frames - 1; t >= 0; --t) {
    const long long o = base + (long long)t * n_bins;
    const float yt = scratch[o];
    w = (t == n_frames - 1) ? yt : fmaf(a, w, b * yt);
    const float zr = __ldg(re + o);
    const float zi = __ldg(im + o);
    const float mag = sqrtf(zr * zr + zi * zi);
    const float ratio = (mag - w) / (w == 0.f ? 1.f : w);
    const float z = (ratio - thresh) * slope;
    scratch[o] = 1.f / (1.f + expf(-z));
  }

  // time smoothing: 'same' correlation with the normalized triangular taps
  const int half = n_taps / 2;
  for (int t = 0; t < n_frames; ++t) {
    const int d0 = max(0, half - t);
    const int d1 = min(n_taps, n_frames + half - t);
    float acc = 0.f;
    for (int d = d0; d < d1; ++d)
      acc = fmaf(__ldg(taps + d),
                 scratch[base + (long long)(t + d - half) * n_bins], acc);
    out[base + (long long)t * n_bins] = acc;
  }
}

}  // namespace

// re/im/scratch/out: (rows, n_frames, n_bins) f32; taps: (n_taps,) f32,
// n_taps odd. Returns cudaGetLastError() after the launch.
extern "C" int nr_nonstationary_mask(const float* re, const float* im,
                                     float* scratch, float* out,
                                     const float* taps, int n_taps, int rows,
                                     int n_frames, int n_bins, float b,
                                     float thresh, float slope, void* stream) {
  const long long n = (long long)rows * n_bins;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  if (n <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  nonstationary_mask_kernel<<<(unsigned)blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      re, im, scratch, out, taps, n_taps, rows, n_frames, n_bins, b, thresh,
      slope);
  return (int)cudaGetLastError();
}
