// Kernel A, FFT route, real-FFT kernels: spectra of every chunk view for an
// even n_fft from 64 to 8192 whose half is 2^k 3^a 5^b 7^c
// (fft_route.cuh::real_kernel). spectra_cplx.cu serves the rest of the FFT
// route and the chirp-z route; spectra.cu (the DFT product) the other n_fft.
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
// DFT product's. The bf16 build (planes.cuh) reads a bf16 signal and stores
// bf16 planes, the FFT in float32: 0.1 + 0.41 GB, 0.15 ms. Design: one
// block per tile of tile_frames consecutive frames
// of one view (geometry.py's fft_tile_frames: the frame slots of the block's
// thread segments, 8 at n_fft 1024, 5 at 1536, 20 at 400).
// The block loads the window and the tile's signal span, (tile_frames - 1)
// * hop + frame_length samples zero filled by the view and signal bounds,
// once into shared memory with coalesced loads (scalar: a span starts
// anywhere in the signal); packs each windowed frame as M = N/2
// complex points (even samples real, odd imaginary; zero past
// frame_length); runs the M-point FFT of fft_smem.cuh; and unpacks
//   X[k] = (Z[k] + conj Z[M-k]) / 2 - i e^{-2 pi i k/N} (Z[k] - conj Z[M-k]) / 2
// (indices mod M; fft_smem.cuh::split) straight into the planes, one
// thread for the pair k, M - k: (M + 1) / 2 slots a frame, slot 0 giving
// bins 0 and M and, for an even M, M/2 as well (an odd M has no middle
// bin). The tile's rows are
// contiguous in the planes, so neighbouring threads store neighbouring bins
// (scalar stores: rows are not 16-byte aligned).
//
// Two kernels: spectra_fft_kernel<ODD> for an M with an odd prime factor
// (fft_smem.cuh's plan, divisions by multiply-high), and spectra_pow2_kernel
// for a power of two M, whose indices are shifts and masks of log2 M and
// whose segments keep four indices. The general kernel's indices hold more
// registers under the 40-register budget of 3 blocks an SM; at n_fft 1024
// they cost it ~4% (PERF.md), which the power-of-two kernel does not pay.
#include "fft_smem.cuh"
#include "planes.cuh"

// the power-of-two kernel's segments and FFT stages
namespace nrf {
namespace p2 {
// The threads of a block split into segments, each of which owns whole
// frames and runs their FFT alone: a segment of T threads owns T * PP
// consecutive points (PP = ELEMS / THREADS), T = one warp, or as many warps
// as one frame needs. A segment synchronises with __syncwarp or a named
// barrier of its own, so the FFT stages never wait for the whole block.
struct Seg {
  int log2t;  // log2 of the segment's threads
  int lane;   // thread index in the segment
  int id;     // segment index in the block
  int first;  // first point the segment owns
};

constexpr int LOG2PP = PP == 16 ? 4 : PP == 8 ? 3 : PP == 4 ? 2 : -1;
static_assert(LOG2PP > 0 && THREADS % 32 == 0, "4, 8 or 16 points a thread");

__device__ __forceinline__ Seg segment(int log2m) {
  Seg s;
  s.log2t = max(5, log2m - LOG2PP);
  s.lane = threadIdx.x & ((1 << s.log2t) - 1);
  s.id = threadIdx.x >> s.log2t;
  s.first = s.id << (s.log2t + LOG2PP);
  return s;
}

__device__ __forceinline__ void seg_sync(const Seg& s) {
  if (s.log2t == 5) {
    __syncwarp();
  } else {  // named barrier 1 + id (0 is __syncthreads'), 2^log2t threads
    asm volatile("bar.sync %0, %1;" ::"r"(1 + s.id), "r"(1 << s.log2t) : "memory");
  }
}

// One radix-R Stockham stage over the segment's frames among the first
// n_frames, in place: every thread loads its butterflies, then (after the
// segment's barrier) stores them. Called by every thread of the segment.
template <int R, bool INV>
__device__ __forceinline__ void stage(float2* z, int log2m, int ns, int n_frames,
                                      const float2* __restrict__ tw, const Seg& sg) {
  constexpr int P = PP / R;  // butterflies per thread
  constexpr int LOG2R = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int M = 1 << log2m;
  const int log2mr = log2m - LOG2R;
  const int mr = 1 << log2mr;
  const int n_bfly = n_frames << log2mr;
  const int bfly0 = sg.first >> LOG2R;  // the segment's first butterfly
  const int tstep = 2 * (M / (ns * R));  // tw index step per (j mod ns) * r
  float2 v[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = bfly0 + sg.lane + (p << sg.log2t);
    if (idx < n_bfly) {
      const int f = idx >> log2mr;
      const int j = idx & (mr - 1);
      const int base = f * M + j;
#pragma unroll
      for (int r = 0; r < R; ++r) v[p][r] = z[pad(base + r * mr)];
      const int jm = j & (ns - 1);
      if (jm) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          float2 w = __ldg(tw + jm * r * tstep);
          if (INV) w.y = -w.y;
          v[p][r] = cmul(v[p][r], w);
        }
      }
      dft<R, INV>(v[p]);
    }
  }
  seg_sync(sg);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = bfly0 + sg.lane + (p << sg.log2t);
    if (idx < n_bfly) {
      const int f = idx >> log2mr;
      const int j = idx & (mr - 1);
      const int jm = j & (ns - 1);
      const int d = f * M + (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) z[pad(d + r * ns)] = v[p][r];
    }
  }
  seg_sync(sg);
}

// The M-point complex DFT (INV: the unscaled inverse) of the segment's
// frames among the first n_frames, in place, natural order in and out. The
// caller has synchronised the segment after filling its frames; they are
// synchronised on return.
template <bool INV>
__device__ __forceinline__ void fft_frames(float2* z, int log2m, int n_frames,
                                           const float2* __restrict__ tw,
                                           const Seg& sg) {
  const int M = 1 << log2m;
  for (int ns = 1; ns < M;) {
    const int left = M / ns;
    if (left >= 8) {
      stage<8, INV>(z, log2m, ns, n_frames, tw, sg);
      ns *= 8;
    } else if (left == 4) {
      stage<4, INV>(z, log2m, ns, n_frames, tw, sg);
      ns *= 4;
    } else {
      stage<2, INV>(z, log2m, ns, n_frames, tw, sg);
      ns *= 2;
    }
  }
}

}  // namespace p2
}  // namespace nrf

namespace {

template <int ODD, class T>  // fft_smem.cuh::odd_primes of M; the plane type
__global__ void __launch_bounds__(nrf::THREADS, nrf::MIN_BLOCKS)
    spectra_fft_kernel(const T* __restrict__ x, long long n_src,
                       int n_chunks, long long chunk_stride,
                       long long view_start, int view_len, int n_frames,
                       int hop, int bpad, int win, int n_bins,
                       int tile_frames, int n_tiles,
                       const float* __restrict__ ws,
                       const float2* __restrict__ tw, T* __restrict__ re,
                       T* __restrict__ im, const nrf::Plan<ODD != 1> plan) {
  extern __shared__ __align__(16) float2 smem2[];
  const int m = plan.m.d;
  float2* z = smem2;
  float* wsm = reinterpret_cast<float*>(smem2 + nrf::PADDED);  // ws, win values
  float* span = wsm + win;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * tile_frames;
  const int fe = min(tile_frames, n_frames - t0);
  const int h = b / n_chunks;
  const int c = b - h * n_chunks;

  // the window and the tile's signal span, once
  const int span_len = (fe - 1) * hop + win;
  const long long p0 = (long long)t0 * hop - bpad;  // view position of span[0]
  const long long s0 = c * chunk_stride + view_start + p0;
  const T* xr = x + (long long)h * n_src;
  for (int i = tid; i < win; i += nrf::THREADS) wsm[i] = __ldg(ws + i);
  for (int i = tid; i < span_len; i += nrf::THREADS) {
    const long long p = p0 + i;
    const long long s = s0 + i;
    span[i] = (p >= 0 && p < view_len && s >= 0 && s < n_src) ? planes::ld(xr + s) : 0.f;
  }
  __syncthreads();

  // each segment of threads packs, transforms and unpacks its own frames
  const nrf::Seg sg = nrf::segment(plan);
  const int nf = nrf::seg_frames(sg, plan, fe);
  const int first = sg.f0 * m;  // the segment's first point

  // windowed frames, packed: z[f][q] = u[2q] + i u[2q+1]
  for (int e = sg.lane; e < nf * m; e += plan.threads) {
    const int fl = plan.m.div(e);
    const int n = 2 * (e - fl * m);
    const float* sp = span + (sg.f0 + fl) * hop + n;
    z[nrf::pad(first + e)] = make_float2(n < win ? wsm[n] * sp[0] : 0.f,
                                         n + 1 < win ? wsm[n + 1] * sp[1] : 0.f);
  }
  nrf::seg_sync(sg, plan);

  nrf::fft_frames<false, ODD>(z, m, fe, tw, sg, plan);

  // unpack the real spectrum into the tile's contiguous rows: slot k of
  // frame f writes bins k and M - k (slot 0: 0 and M, and M/2 for an even M)
  const int half = (m + 1) >> 1;  // slots a frame
  const long long o0 = ((long long)b * n_frames + t0 + sg.f0) * n_bins;
  for (int e = sg.lane; e < nf * half; e += plan.threads) {
    const int fl = plan.half.div(e);
    const int k = e - fl * half;
    const int base = first + fl * m;
    const long long row = o0 + (long long)fl * n_bins;
    const float2 zk = z[nrf::pad(base + k)];
    const float2 zm = z[nrf::pad(base + (k ? m - k : 0))];
    float2 lo, hi;
    nrf::split(zk, zm, __ldg(tw + k), lo, hi);
    planes::st(re + row + k, lo.x);
    planes::st(im + row + k, lo.y);
    planes::st(re + row + m - k, hi.x);
    planes::st(im + row + m - k, hi.y);
    if (k == 0 && !(m & 1)) {
      const float2 zh = z[nrf::pad(base + m / 2)];
      nrf::split(zh, zh, __ldg(tw + m / 2), lo, hi);
      planes::st(re + row + m / 2, lo.x);
      planes::st(im + row + m / 2, lo.y);
    }
  }
}

// The same computation for a power of two M, indexed by shifts of log2 M
// (nrf::p2's segments and stages).
template <class T>
__global__ void __launch_bounds__(nrf::THREADS, nrf::MIN_BLOCKS)
    spectra_pow2_kernel(const T* __restrict__ x, long long n_src,
                        int n_chunks, long long chunk_stride,
                        long long view_start, int view_len, int n_frames,
                        int hop, int bpad, int win, int log2m, int n_bins,
                        int tile_frames, int n_tiles,
                        const float* __restrict__ ws,
                        const float2* __restrict__ tw, T* __restrict__ re,
                        T* __restrict__ im) {
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
  const T* xr = x + (long long)h * n_src;
  for (int i = tid; i < win; i += nrf::THREADS) wsm[i] = __ldg(ws + i);
  for (int i = tid; i < span_len; i += nrf::THREADS) {
    const long long p = p0 + i;
    const long long s = s0 + i;
    span[i] = (p >= 0 && p < view_len && s >= 0 && s < n_src) ? planes::ld(xr + s) : 0.f;
  }
  __syncthreads();

  // each segment of threads packs, transforms and unpacks its own frames
  const nrf::p2::Seg sg = nrf::p2::segment(log2m);
  const int step = 1 << sg.log2t;
  const int seg_end = sg.first + (step << nrf::p2::LOG2PP);

  // windowed frames, packed: z[f][m] = u[2m] + i u[2m+1]
  for (int e = sg.first + sg.lane; e < min(fe << log2m, seg_end); e += step) {
    const int f = e >> log2m;
    const int n = 2 * (e - (f << log2m));
    const float* sp = span + f * hop + n;
    z[nrf::pad(e)] = make_float2(n < win ? wsm[n] * sp[0] : 0.f,
                                 n + 1 < win ? wsm[n + 1] * sp[1] : 0.f);
  }
  nrf::p2::seg_sync(sg);

  nrf::p2::fft_frames<false>(z, log2m, fe, tw, sg);

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
    nrf::split(zk, zm, __ldg(tw + k), lo, hi);
    planes::st(re + row + k, lo.x);
    planes::st(im + row + k, lo.y);
    planes::st(re + row + M - k, hi.x);
    planes::st(im + row + M - k, hi.y);
    if (k == 0) {
      const float2 zh = z[nrf::pad(base + M / 2)];
      nrf::split(zh, zh, __ldg(tw + M / 2), lo, hi);
      planes::st(re + row + M / 2, lo.x);
      planes::st(im + row + M / 2, lo.y);
    }
  }
}

}  // namespace

// plane: the type of x, re and im (planes.cuh: 0 float32, 1 bfloat16); x:
// (rows, n_src); ws: (win,) f32; tw: (n_fft,) complex f32; re/im:
// (rows*n_chunks, n_frames, n_bins). n_fft must be one fft_smem.cuh
// serves, seg_warps a segment of warps that holds a frame, and tile_frames
// at most the frame slots of the block's segments. Returns
// cudaGetLastError() after the launch.
extern "C" int nr_spectra_fft(int plane, const void* x, long long n_src, int rows,
                              int n_chunks, long long chunk_stride,
                              long long view_start, int view_len,
                              int n_frames, int hop, int bpad, int win,
                              int n_fft, int n_bins, int seg_warps, int tile_frames,
                              const float* ws, const float* tw, void* re,
                              void* im, void* stream) {
  const int m = n_fft / 2;
  if (!nrf::real_kernel(n_fft) || tile_frames < 1 ||
      tile_frames > nrf::fft_block_frames(seg_warps, m))
    return (int)cudaErrorInvalidValue;
  const int B = rows * n_chunks;
  if (B <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_tiles = (n_frames + tile_frames - 1) / tile_frames;
  const size_t smem = sizeof(float2) * nrf::PADDED +
                      sizeof(float) * ((size_t)(tile_frames - 1) * hop + 2 * win);
  const unsigned grid = (unsigned)((long long)B * n_tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const T* xt = static_cast<const T*>(x);
    T* ret = static_cast<T*>(re);
    T* imt = static_cast<T*>(im);
    return nrf::with_odd_primes(m, [&](auto odd) {
      constexpr int ODD = decltype(odd)::value;
      if constexpr (ODD == 1) {
        int log2m = 0;
        while ((1 << log2m) < m) ++log2m;
        const cudaError_t err = cudaFuncSetAttribute(
            spectra_pow2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        spectra_pow2_kernel<T><<<grid, nrf::THREADS, smem, st>>>(
            xt, n_src, n_chunks, chunk_stride, view_start, view_len, n_frames, hop, bpad,
            win, log2m, n_bins, tile_frames, n_tiles, ws, tw2, ret, imt);
      } else {
        const cudaError_t err = cudaFuncSetAttribute(
            spectra_fft_kernel<ODD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        spectra_fft_kernel<ODD, T><<<grid, nrf::THREADS, smem, st>>>(
            xt, n_src, n_chunks, chunk_stride, view_start, view_len, n_frames, hop, bpad,
            win, n_bins, tile_frames, n_tiles, ws, tw2, ret, imt,
            nrf::make_plan<true>(m, seg_warps));
      }
      return (int)cudaGetLastError();
    });
  });
}
