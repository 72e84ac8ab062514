// Kernel G: fm_nonstationary_mask — filtfilt noise floor and sigmoid mask
// of a frequency-major spectrogram, no time smoothing.
//
// Replaces: noisereduce_tpu/ops/pallas_mask.py::_mask_kernel (:84-149),
// launched by ::_fused_mask_cvjp (pallas_call at :229).
//
// Per column (row, bin) of a (rows, n_bins, n_frames) plane, time
// contiguous:
//   |Z|[t]  = sqrt(re^2 + im^2)   (interleaved complex64), or the input
//             itself (a float32 magnitude plane)
//   y[0] = |Z|[0],      y[t] = b |Z|[t] + (1-b) y[t-1]      (forward)
//   w[T-1] = y[T-1],    w[t] = b y[t] + (1-b) w[t+1]         (backward)
//   mask[t] = sigmoid(((|Z|[t] - w[t]) / w'[t] - thresh) * slope),
//             w' = w with zeros replaced by 1 (silence gives finite values)
// The carries y and w are doubles, as in kernel B: a float carry takes about
// 1/b roundings into each value. y is stored once as float between passes.
//
// Bound on this card: bytes. A handful of FLOPs per element; the function
// reads Z once (8 B) and writes the mask once (4 B); the kernel also writes
// and reads y through a scratch plane and reads Z a second time (28 B per
// element in all).
//
// Design: a column is contiguous in time, so a warp that walks 32 columns
// with one thread each would issue 32 loads 4*T bytes apart, none of them
// coalesced. A block owns 32 columns instead and moves time tiles of them
// through shared memory: all warps load a (32 columns x TT frames) slab
// with each warp reading consecutive frames of one column (coalesced), one
// warp then walks the slab with one thread per column and the carry in a
// register, and all warps write the slab back, again along time. The rows
// of the slab are padded to TT+1 words so the walking threads hit 32
// different banks. The backward pass runs the tiles in reverse: it stages y
// and |Z|, the walk writes w over y, and the sigmoid runs on every thread
// while the mask tile is written. The other resident blocks (about 13 an
// SM) load and store while one walks. The TPU kernel's 128x128
// lower-triangular MXU blocks and VMEM column tiles have no counterpart: the
// scalar recurrence costs one double FMA a step.
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;
constexpr int TT = 64;
constexpr int LD = TT + 1;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <bool CPLX>
__device__ __forceinline__ float magnitude(const float* __restrict__ z,
                                           long long o) {
  if (CPLX) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(z) + o);
    return sqrtf(v.x * v.x + v.y * v.y);
  }
  return __ldg(z + o);
}

template <bool CPLX>
__global__ void __launch_bounds__(THREADS)
    fm_nonstationary_mask_kernel(const float* __restrict__ z,
                                 float* __restrict__ scratch,
                                 float* __restrict__ out, long long n_cols,
                                 int n_frames, double b, float thresh,
                                 float slope) {
  __shared__ float s_a[COLS * LD];  // |Z| tile (forward: then y)
  __shared__ float s_b[COLS * LD];  // y tile, then w (backward)
  const long long col0 = (long long)blockIdx.x * COLS;
  const int ncol = (int)min((long long)COLS, n_cols - col0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const double a = 1.0 - b;
  const int n_tiles = (n_frames + TT - 1) / TT;
  double carry = 0.0;  // warp 0: the carry of column `lane`

  // forward IIR: y tile by tile into the scratch plane
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * TT;
    const int len = min(TT, n_frames - t0);
    for (int c = warp; c < ncol; c += WARPS) {
      const long long base = (col0 + c) * n_frames + t0;
      for (int t = lane; t < len; t += 32)
        s_a[c * LD + t] = magnitude<CPLX>(z, base + t);
    }
    __syncthreads();
    if (warp == 0 && lane < ncol) {
      float* col = s_a + lane * LD;
      int t = 0;
      if (k == 0) {
        carry = col[0];  // y[0] = |Z|[0], stored as it is
        t = 1;
      }
      for (; t < len; ++t) {
        carry = fma(a, carry, b * (double)col[t]);
        col[t] = (float)carry;
      }
    }
    __syncthreads();
    for (int c = warp; c < ncol; c += WARPS) {
      const long long base = (col0 + c) * n_frames + t0;
      for (int t = lane; t < len; t += 32) scratch[base + t] = s_a[c * LD + t];
    }
    __syncthreads();
  }

  // backward IIR over y, then the mask, tiles in reverse
  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * TT;
    const int len = min(TT, n_frames - t0);
    for (int c = warp; c < ncol; c += WARPS) {
      const long long base = (col0 + c) * n_frames + t0;
      for (int t = lane; t < len; t += 32) {
        s_a[c * LD + t] = magnitude<CPLX>(z, base + t);
        s_b[c * LD + t] = scratch[base + t];
      }
    }
    __syncthreads();
    if (warp == 0 && lane < ncol) {
      float* col = s_b + lane * LD;
      int t = len - 1;
      if (k == n_tiles - 1) {
        carry = col[t];  // w[T-1] = y[T-1]
        --t;
      }
      for (; t >= 0; --t) {
        carry = fma(a, carry, b * (double)col[t]);
        col[t] = (float)carry;
      }
    }
    __syncthreads();
    for (int c = warp; c < ncol; c += WARPS) {
      const long long base = (col0 + c) * n_frames + t0;
      for (int t = lane; t < len; t += 32) {
        const float w = s_b[c * LD + t];
        const float ratio = (s_a[c * LD + t] - w) / (w == 0.f ? 1.f : w);
        const float x = (ratio - thresh) * slope;
        out[base + t] = 1.f / (1.f + expf(-x));
      }
    }
    __syncthreads();
  }
}

}  // namespace

// z: (n_cols, n_frames) interleaved complex64 (is_complex 1) or float32
// magnitudes (0); scratch, out: (n_cols, n_frames) f32. Returns
// cudaGetLastError() after the launch.
extern "C" int nr_fm_nonstationary_mask(const float* z, int is_complex,
                                        float* scratch, float* out,
                                        long long n_cols, int n_frames,
                                        double b, float thresh, float slope,
                                        void* stream) {
  if (n_cols <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const long long blocks = (n_cols + COLS - 1) / COLS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex)
    fm_nonstationary_mask_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        z, scratch, out, n_cols, n_frames, b, thresh, slope);
  else
    fm_nonstationary_mask_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        z, scratch, out, n_cols, n_frames, b, thresh, slope);
  return (int)cudaGetLastError();
}
