// Kernel A: spectra — windowed frame spectra of every chunk view; the
// product route, for an n_fft that neither the FFT nor the chirp-z route
// takes (fft_route.cuh; spectra_fft.cu and spectra_cplx.cu serve those).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// the analysis phase of the merged TPU gate kernel
// (noisereduce_tpu/ops/pallas/dispatch.py::_merged_gate_from_blocks).
//
// Computes, for view c of signal row h and frame t,
//   Z[b, t, k] = (1/sum w) * sum_{n < win} w[n] x_c[t*hop + n - win/2] e^{-2 pi i k n / N}
// with b = h * n_chunks + c, time-major (rows, n_frames, n_bins) re/im planes.
// View c covers source samples [c*chunk_stride + view_start, + view_len) and
// reads zero outside [0, n_src) (the chunk halo zero fill) and outside
// [0, view_len) (scipy's win//2 boundary extension), so the chunk views are
// never materialized: the kernel gathers them straight from the signal.
//
// Bound on this card: FP32 FMAs, win * 2 * n_bins per frame (about 1.05 M at
// n_fft 1024: 0.42 TFLOP for 960 s of 48 kHz audio), against 67 TFLOP/s of
// non-tensor FP32 (its bf16 build widens the signal as it lands in shared
// memory and rounds the planes as it stores them, planes.cuh). Design: one
// implicit product frames (M x win) @ table
// (win x 2 n_bins) through the shared-memory tiling of gemm_tile.cuh; the
// window and 1/sum w are folded into the table, so the TPU kernel's
// hop-block twiddles, Hermitian fix and Hann stencil (artifacts of its
// 128-lane layout) have no counterpart here.
#include "gemm_tile.cuh"
#include "planes.cuh"

namespace {

template <class T>  // the signal's type (planes.cuh), widened as it lands in shared memory
struct SpectraLoader {
  const T* x;
  long long n_src;
  int n_chunks;
  long long chunk_stride;
  long long view_start;
  int view_len;
  int n_frames;
  int hop;
  int bpad;
  int win;
  int M;

  struct Row {
    const T* base;
    long long pos0;  // view position of frame sample 0
    long long src0;  // source index of frame sample 0
    bool valid;
  };

  __device__ Row row(int m) const {
    Row r;
    r.valid = m < M;
    r.base = x;
    r.pos0 = 0;
    r.src0 = 0;
    if (!r.valid) return r;
    const int b = m / n_frames;
    const int t = m - b * n_frames;
    const int h = b / n_chunks;
    const int c = b - h * n_chunks;
    r.base = x + (long long)h * n_src;
    r.pos0 = (long long)t * hop - bpad;
    r.src0 = (long long)c * chunk_stride + view_start + r.pos0;
    return r;
  }

  __device__ float at(const Row& r, int k) const {
    const long long p = r.pos0 + k;
    const long long s = r.src0 + k;
    const bool ok = r.valid && k < win && p >= 0 && p < view_len && s >= 0 &&
                    s < n_src;
    return ok ? planes::ld(r.base + s) : 0.f;
  }
};

template <class T>  // the planes' type (planes.cuh), rounded to on store
struct SpectraEpilogue {
  T* re;
  T* im;
  int M;
  int n_bins;

  __device__ void operator()(int m, int n, float v) const {
    if (m >= M) return;
    if (n < n_bins)
      planes::st(re + (long long)m * n_bins + n, v);
    else if (n < 2 * n_bins)
      planes::st(im + (long long)m * n_bins + (n - n_bins), v);
  }
};

template <class T>
__global__ void __launch_bounds__(nrt::THREADS)
    spectra_kernel(SpectraLoader<T> ld, SpectraEpilogue<T> epi,
                   const float* __restrict__ tab, int ldb, int k_a,
                   int n_tiles_n) {
  const int nt = blockIdx.x % n_tiles_n;
  const int mt = blockIdx.x / n_tiles_n;
  nrt::gemm_tile(ld, tab, ldb, k_a, mt * nrt::BM, nt * nrt::BN, epi);
}

}  // namespace

// plane: the type of x, re and im (planes.cuh: 0 float32, 1 bfloat16); x:
// (rows, n_src); tab: (k_a, ldb) f32; re/im: (rows*n_chunks, n_frames,
// n_bins). Returns cudaGetLastError() after the launch.
extern "C" int nr_spectra(int plane, const void* x, long long n_src, int rows,
                          int n_chunks, long long chunk_stride,
                          long long view_start, int view_len, int n_frames,
                          int hop, int bpad, int win, int n_bins,
                          const float* tab, int ldb, int k_a, void* re,
                          void* im, void* stream) {
  const int M = rows * n_chunks * n_frames;
  const int n_tiles_n = ldb / nrt::BN;
  const int n_tiles_m = (M + nrt::BM - 1) / nrt::BM;
  const long long blocks = (long long)n_tiles_m * n_tiles_n;
  if (M <= 0) return (int)cudaGetLastError();
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    SpectraLoader<T> ld{static_cast<const T*>(x), n_src, n_chunks, chunk_stride, view_start,
                        view_len, n_frames, hop, bpad, win, M};
    SpectraEpilogue<T> epi{static_cast<T*>(re), static_cast<T*>(im), M, n_bins};
    spectra_kernel<T><<<(unsigned)blocks, nrt::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(ld, epi, tab, ldb, k_a,
                                                             n_tiles_n);
    return (int)cudaGetLastError();
  });
}
