// Kernel E: stationary_mask — dB spectrogram, per-bin dynamic-range floor,
// binary threshold mask, prop_decrease blend and time smoothing.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_as_kernel passes A and B
// and its self-statistics pass (:565-628) and its ::_time_smooth_phase
// (:630): the stationary variant of the merged TPU gate kernel
// (dispatch.py::_merged_gate_from_blocks, :242) and of the torch-convention
// gate (torch_dispatch.py::_merged_torch_impl, :382; _fused_torch_impl, :526).
//
// Per (view, bin) column of the time-major spectra:
//   dB[t]  = log(sqrt(re^2 + im^2) + eps) * (20 / ln 10)   (kernels.py:573)
//   mx     = max over t < n_frames of dB[t]
//   c[t]   = max(dB[t], mx - top_db)     (top_db 80 scipy engine, 40 torch)
//   m[t]   = prop * 1[c[t] > thr] + (1 - prop)
//            (blend BEFORE smoothing: the stationary order)
//   out[t] = sum_d taps[d] m[t + d - n],  zero outside [0, n_frames)
// thr is row (view / views_per_row) of a (rows, n_bins) plane, or one
// (n_bins,) row shared by every view (thr_stride 0), or, with thr null, the
// column's own statistics (TorchGate with no noise clip):
//   thr = mean(c) + n_std * std(c), std with ddof 1,
// from double sums of c - mx and its square (the shift keeps the one-pass
// variance from cancelling: a float one-pass sum of squares of dB values
// near -100 loses most of its digits), compared in double.
//
// Bound on this card: bytes. It must read re and im once and write the mask
// once: 1.22 GB for 960 s of 48 kHz audio (77 views x 2,579 frames x 513
// bins), 0.36 ms at 3.35 TB/s; a few FLOPs per element. Design: one thread
// per (view, bin), neighbouring threads on neighbouring bins so each warp
// access is one coalesced row segment. The TPU kernel holds the column tile
// in VMEM; here the column is walked three times: once for the max (re/im
// read), once for the compare and blend (re/im read again, m to a scratch
// plane), once for the correlation (scratch read, out written); the self
// statistics add one more walk over re/im after the max. With one tap the
// correlation walk is skipped and m goes straight to out. The extra reads
// are the price of a kernel that is simple and right first.
//
// The products and the sum of the squared magnitude round separately
// (__fmul_rn / __fadd_rn, no FMA contraction), as the plain version's
// elementwise ops do, so the binary compare flips only where logf itself
// differs by an ulp.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float db_of(float zr, float zi, float eps,
                                       float k20) {
  const float p = __fadd_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi));
  return __fmul_rn(logf(__fadd_rn(sqrtf(p), eps)), k20);
}

__global__ void __launch_bounds__(128)
    stationary_mask_kernel(const float* __restrict__ re,
                           const float* __restrict__ im,
                           const float* __restrict__ thr, long long thr_stride,
                           int views_per_row, float* __restrict__ scratch,
                           float* __restrict__ out,
                           const float* __restrict__ taps, int n_taps,
                           int views, int n_frames, int n_bins, float prop,
                           float one_minus_prop, float eps, float k20,
                           float top_db, double n_std) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)views * n_bins) return;
  const int v = (int)(idx / n_bins);
  const int f = (int)(idx - (long long)v * n_bins);
  const long long base = (long long)v * n_frames * n_bins + f;

  // walk 1: per-bin max of the dB column
  float mx = db_of(__ldg(re + base), __ldg(im + base), eps, k20);
  for (int t = 1; t < n_frames; ++t) {
    const long long o = base + (long long)t * n_bins;
    mx = fmaxf(mx, db_of(__ldg(re + o), __ldg(im + o), eps, k20));
  }
  const float floor_db = __fsub_rn(mx, top_db);

  // the threshold: given, or the column's own statistics (one more walk)
  double th;
  if (thr != nullptr) {
    th = __ldg(thr + (long long)(v / views_per_row) * thr_stride + f);
  } else {
    double s1 = 0.0, s2 = 0.0;
    for (int t = 0; t < n_frames; ++t) {
      const long long o = base + (long long)t * n_bins;
      const double d =
          (double)fmaxf(db_of(__ldg(re + o), __ldg(im + o), eps, k20),
                        floor_db) -
          (double)mx;
      s1 += d;
      s2 = fma(d, d, s2);
    }
    const double n = (double)n_frames;
    const double var = fmax(s2 - s1 * s1 / n, 0.0) / fmax(n - 1.0, 1.0);
    th = (double)mx + s1 / n + sqrt(var) * n_std;
  }

  // walk 2: floor, compare, blend
  float* m = n_taps == 1 ? out : scratch;
  const float scale = n_taps == 1 ? __ldg(taps) : 1.f;
  for (int t = 0; t < n_frames; ++t) {
    const long long o = base + (long long)t * n_bins;
    const float db = fmaxf(db_of(__ldg(re + o), __ldg(im + o), eps, k20),
                           floor_db);
    const float mt = ((double)db > th) ? prop : 0.f;
    m[o] = __fmul_rn(__fadd_rn(mt, one_minus_prop), scale);
  }
  if (n_taps == 1) return;

  // walk 3: 'same' correlation with the normalized triangular taps
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

// re/im/scratch/out: (views, n_frames, n_bins) f32; thr: f32, row r at
// thr + r * thr_stride (thr_stride 0: one shared row), or null for each
// column's own statistics with n_std; taps: (n_taps,) f32, n_taps odd.
// Returns cudaGetLastError() after the launch.
extern "C" int nr_stationary_mask(const float* re, const float* im,
                                  const float* thr, long long thr_stride,
                                  int views_per_row, float* scratch,
                                  float* out, const float* taps, int n_taps,
                                  int views, int n_frames, int n_bins,
                                  float prop, float one_minus_prop, float eps,
                                  float k20, float top_db, double n_std,
                                  void* stream) {
  const long long n = (long long)views * n_bins;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  if (n <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  stationary_mask_kernel<<<(unsigned)blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      re, im, thr, thr_stride, views_per_row, scratch, out, taps, n_taps,
      views, n_frames, n_bins, prop, one_minus_prop, eps, k20, top_db, n_std);
  return (int)cudaGetLastError();
}
