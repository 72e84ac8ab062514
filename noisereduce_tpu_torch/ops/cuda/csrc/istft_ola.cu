// Kernel D: istft_ola — mask apply, inverse DFT, overlap-add, envelope
// division and the output window; the product route, for an n_fft that
// neither the FFT nor the chirp-z route takes (fft_route.cuh; istft_fft.cu
// and istft_cplx.cu serve those).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331).
//
// With Y = Z * mask, the full overlap-add signal at p = j*hop + q is
//   x[p] = sum_{i < r, 0 <= j-i < T} w[u] (sum w) irfft_N(Y_{j-i})[u],  u = i*hop + q
// (irfft with Hermitian weights 2, except 1 at DC and Nyquist, and 1/N),
// divided by the window-square envelope env[p] = sum w[u]^2 over the same
// frames (entries <= env_floor count as 1: scipy 1e-10, torch 1e-11). The
// kernel writes only trimmed samples s = p - bpad in
// [out_off, out_off + out_len), as out[b, s - out_off], and zero where s is
// past the istft length (scipy's, or torch's natural (T-1)*hop). The scipy
// and torch conventions differ only in the table (scipy folds sum w into
// it, torch does not), bpad, the length and the floor.
//
// Bound on this card: FP32 FMAs, r * 2 * n_bins * hop per output hop block
// (0.38 TFLOP at the 960 s headline shape, about kernel A's 0.42). Design: the
// gather form of the OLA as one implicit product per output hop block,
// out_block[j] (hop) = [Y_j, Y_{j-1}, ..., Y_{j-r+1}] (r * 2 n_bins)
//                      @ table (r * 2 n_bins x hop),
// tiled by gemm_tile.cuh; the loader multiplies spectra and mask as it stages
// them, and the synthesis window, sum w, Hermitian weights and 1/N are folded
// into the table. Every output sample is owned by exactly one thread: no
// atomics, so the output is the same from run to run.
#include "gemm_tile.cuh"

namespace {

struct IstftLoader {
  const float* re;
  const float* im;
  const float* mask;
  int n_frames;
  int n_bins;
  int f2;      // per-shift contraction width (2 n_bins padded)
  int n_out;   // output hop blocks per row
  int j0;      // first output hop block
  int M;

  struct Row {
    long long base;  // (b * n_frames) * n_bins
    int j;           // hop block index in the full OLA signal
    bool valid;
  };

  __device__ Row row(int m) const {
    Row r;
    r.valid = m < M;
    r.base = 0;
    r.j = 0;
    if (!r.valid) return r;
    const int b = m / n_out;
    r.j = j0 + (m - b * n_out);
    r.base = (long long)b * n_frames * n_bins;
    return r;
  }

  __device__ float at(const Row& r, int k) const {
    const int i = k / f2;
    const int kf = k - i * f2;
    const int t = r.j - i;
    if (!r.valid || t < 0 || t >= n_frames || kf >= 2 * n_bins) return 0.f;
    const bool imag = kf >= n_bins;
    const long long o = r.base + (long long)t * n_bins + (imag ? kf - n_bins : kf);
    return __ldg((imag ? im : re) + o) * __ldg(mask + o);
  }
};

struct IstftEpilogue {
  float* out;
  const float* win;
  int n_frames;
  int hop;
  int r;
  int bpad;
  int n_out;
  int j0;
  long long out_off;
  long long out_len;
  long long istft_len;
  float env_floor;
  int M;

  __device__ void operator()(int m, int q, float v) const {
    if (m >= M || q >= hop) return;
    const int b = m / n_out;
    const int j = j0 + (m - b * n_out);
    const long long s = (long long)j * hop + q - bpad;
    const long long o = s - out_off;
    if (o < 0 || o >= out_len) return;
    float y = 0.f;
    if (s < istft_len) {
      float env = 0.f;
      for (int i = 0; i < r; ++i) {
        const int t = j - i;
        if (t >= 0 && t < n_frames) {
          const float wu = __ldg(win + i * hop + q);
          env = fmaf(wu, wu, env);
        }
      }
      y = v / (env > env_floor ? env : 1.f);
    }
    out[(long long)b * out_len + o] = y;
  }
};

__global__ void __launch_bounds__(nrt::THREADS)
    istft_ola_kernel(IstftLoader ld, IstftEpilogue epi,
                     const float* __restrict__ tab, int ldb, int k_d,
                     int n_tiles_n) {
  const int nt = blockIdx.x % n_tiles_n;
  const int mt = blockIdx.x / n_tiles_n;
  nrt::gemm_tile(ld, tab, ldb, k_d, mt * nrt::BM, nt * nrt::BN, epi);
}

}  // namespace

// re/im/mask: (rows, n_frames, n_bins) f32; win: (r * hop,) f32;
// tab: (r * f2, ldb) f32; out: (rows, out_len) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int nr_istft_ola(const float* re, const float* im,
                            const float* mask, const float* win,
                            const float* tab, int ldb, int f2, int rows,
                            int n_frames, int n_bins, int hop, int r, int bpad,
                            int j0, int n_out, long long out_off,
                            long long out_len, long long istft_len,
                            float env_floor, float* out, void* stream) {
  const int M = rows * n_out;
  IstftLoader ld{re, im, mask, n_frames, n_bins, f2, n_out, j0, M};
  IstftEpilogue epi{out,     win,       n_frames,  hop, r,
                    bpad,    n_out,     j0,        out_off, out_len,
                    istft_len, env_floor, M};
  const int n_tiles_n = ldb / nrt::BN;
  const int n_tiles_m = (M + nrt::BM - 1) / nrt::BM;
  const long long blocks = (long long)n_tiles_m * n_tiles_n;
  if (M <= 0) return (int)cudaGetLastError();
  istft_ola_kernel<<<(unsigned)blocks, nrt::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(ld, epi, tab, ldb,
                                                          r * f2, n_tiles_n);
  return (int)cudaGetLastError();
}
