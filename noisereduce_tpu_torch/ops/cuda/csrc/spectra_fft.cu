// Kernel A, FFT route: spectra of every chunk view for a power-of-two n_fft
// (64 to 8192). spectra.cu (the DFT product) serves the other n_fft.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// the analysis phase of the merged TPU gate kernel
// (noisereduce_tpu/ops/pallas/dispatch.py::_merged_gate_from_blocks), and the
// noise-clip spectra of dispatch.py::_fused_stft_planes (:556).
//
// Computes what spectra.cu computes: for view c of signal row h and frame t,
//   Z[b, t, k] = s * sum_{n < frame_length} w[n] x_c[t*hop + n - bpad] e^{-2 pi i k n / N}
// with b = h * n_chunks + c, s = 1/sum w (scipy) or 1 (torch), time-major
// (rows, n_frames, n_bins) re/im planes; view c covers source samples
// [c*chunk_stride + view_start, + view_len), zero outside [0, n_src) and
// outside the view. ws = s * w (frame_length values) comes from the host.
//
// Bound on this card: bytes. The signal read once and the two planes written
// once (0.2 + 0.815 GB for 960 s of 48 kHz audio at n_fft 1024: 0.30 ms at
// 3.35 TB/s); the real FFT's ~2.5 N log2 N operations a frame are ~1% of the
// DFT product's. Design: one block per tile of tile_frames consecutive frames
// of one view (tile_frames * N/2 = fft_smem.cuh's ELEMS, 8 at n_fft 1024).
// The block loads the window and the tile's signal span, (tile_frames - 1)
// * hop + frame_length samples zero filled by the view and signal bounds,
// once into shared memory with coalesced loads (scalar: a span starts
// anywhere in the signal); packs each windowed frame as N/2
// complex points (even samples real, odd imaginary; zero past
// frame_length); runs the N/2-point FFT of fft_smem.cuh; and unpacks
//   X[k] = (Z[k] + conj Z[M-k]) / 2 - i e^{-2 pi i k/N} (Z[k] - conj Z[M-k]) / 2
// (indices mod M = N/2) straight into the planes, one thread for the pair
// k, M - k. The tile's rows are contiguous in the planes, so neighbouring
// threads store neighbouring bins (scalar stores: n_bins is odd, rows are
// not 16-byte aligned).
#include "fft_smem.cuh"

namespace {

// With E = (Z[k] + conj Z[M-k]) / 2 and O = -i (Z[k] - conj Z[M-k]) / 2 (the
// spectra of the even and odd samples) and w = e^{-2 pi i k/N}:
// X[k] = E + w O and X[M-k] = conj(E - w O).
__device__ __forceinline__ void split(float2 zk, float2 zm, float2 w, float2& lo,
                                      float2& hi) {
  const float2 ev = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 od = make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x));
  const float2 wo = nrf::cmul(w, od);
  lo = nrf::add(ev, wo);
  hi = nrf::conj(nrf::sub(ev, wo));
}

__global__ void __launch_bounds__(nrf::THREADS, nrf::MIN_BLOCKS)
    spectra_fft_kernel(const float* __restrict__ x, long long n_src,
                       int n_chunks, long long chunk_stride,
                       long long view_start, int view_len, int n_frames,
                       int hop, int bpad, int win, int log2m, int n_bins,
                       int tile_frames, int n_tiles,
                       const float* __restrict__ ws,
                       const float2* __restrict__ tw, float* __restrict__ re,
                       float* __restrict__ im) {
  extern __shared__ __align__(16) float2 smem2[];
  float2* z = smem2;
  float* wsm = reinterpret_cast<float*>(smem2 + nrf::PADDED);  // ws, win values
  float* span = wsm + win;
  const int tid = threadIdx.x;
  const int M = 1 << log2m;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * tile_frames;
  const int fe = min(tile_frames, n_frames - t0);
  const int h = b / n_chunks;
  const int c = b - h * n_chunks;

  // the window and the tile's signal span, once
  const int span_len = (fe - 1) * hop + win;
  const long long p0 = (long long)t0 * hop - bpad;  // view position of span[0]
  const long long s0 = c * chunk_stride + view_start + p0;
  const float* xr = x + (long long)h * n_src;
  for (int i = tid; i < win; i += nrf::THREADS) wsm[i] = __ldg(ws + i);
  for (int i = tid; i < span_len; i += nrf::THREADS) {
    const long long p = p0 + i;
    const long long s = s0 + i;
    span[i] = (p >= 0 && p < view_len && s >= 0 && s < n_src) ? __ldg(xr + s) : 0.f;
  }
  __syncthreads();

  // each segment of threads packs, transforms and unpacks its own frames
  const nrf::Seg sg = nrf::segment(log2m);
  const int step = 1 << sg.log2t;
  const int seg_end = sg.first + (step << nrf::LOG2PP);

  // windowed frames, packed: z[f][m] = u[2m] + i u[2m+1]
  for (int e = sg.first + sg.lane; e < min(fe << log2m, seg_end); e += step) {
    const int f = e >> log2m;
    const int n = 2 * (e - (f << log2m));
    const float* sp = span + f * hop + n;
    z[nrf::pad(e)] = make_float2(n < win ? wsm[n] * sp[0] : 0.f,
                                 n + 1 < win ? wsm[n + 1] * sp[1] : 0.f);
  }
  nrf::seg_sync(sg);

  nrf::fft_frames<false>(z, log2m, fe, tw, sg);

  // unpack the real spectrum into the tile's contiguous rows: slot k < M/2
  // of frame f writes bins k and M - k (slot 0: 0, M and M/2)
  const long long o0 = ((long long)b * n_frames + t0) * n_bins;
  for (int e = (sg.first >> 1) + sg.lane; e < min(fe << (log2m - 1), seg_end >> 1);
       e += step) {
    const int f = e >> (log2m - 1);
    const int k = e & (M / 2 - 1);
    const int base = f << log2m;
    const long long row = o0 + (long long)f * n_bins;
    const float2 zk = z[nrf::pad(base + k)];
    const float2 zm = z[nrf::pad(base + ((M - k) & (M - 1)))];
    float2 lo, hi;
    split(zk, zm, __ldg(tw + k), lo, hi);
    re[row + k] = lo.x;
    im[row + k] = lo.y;
    re[row + M - k] = hi.x;
    im[row + M - k] = hi.y;
    if (k == 0) {
      const float2 zh = z[nrf::pad(base + M / 2)];
      split(zh, zh, __ldg(tw + M / 2), lo, hi);
      re[row + M / 2] = lo.x;
      im[row + M / 2] = lo.y;
    }
  }
}

}  // namespace

// x: (rows, n_src) f32; ws: (win,) f32; tw: (n_fft,) complex f32;
// re/im: (rows*n_chunks, n_frames, n_bins) f32. tile_frames * n_fft/2 must
// not exceed ELEMS. Returns cudaGetLastError() after the launch.
extern "C" int nr_spectra_fft(const float* x, long long n_src, int rows,
                              int n_chunks, long long chunk_stride,
                              long long view_start, int view_len,
                              int n_frames, int hop, int bpad, int win,
                              int n_fft, int n_bins, int tile_frames,
                              const float* ws, const float* tw, float* re,
                              float* im, void* stream) {
  int log2m = 0;
  while ((2 << log2m) < n_fft) ++log2m;
  if ((2 << log2m) != n_fft || n_fft < 64 || (tile_frames << log2m) > nrf::ELEMS ||
      tile_frames < 1)
    return (int)cudaErrorInvalidValue;
  const int B = rows * n_chunks;
  if (B <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_tiles = (n_frames + tile_frames - 1) / tile_frames;
  const size_t smem = sizeof(float2) * nrf::PADDED +
                      sizeof(float) * ((size_t)(tile_frames - 1) * hop + 2 * win);
  cudaError_t err = cudaFuncSetAttribute(
      spectra_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spectra_fft_kernel<<<(unsigned)((long long)B * n_tiles), nrf::THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, n_src, n_chunks, chunk_stride, view_start, view_len, n_frames, hop,
      bpad, win, log2m, n_bins, tile_frames, n_tiles, ws,
      reinterpret_cast<const float2*>(tw), re, im);
  return (int)cudaGetLastError();
}
