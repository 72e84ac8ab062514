// Kernel A, FFT route, real-FFT kernels: spectra of every chunk view for an
// even n_fft from 2 to 8192 whose half is 2^k 3^a 5^b 7^c
// (fft_route.cuh::real_kernel). spectra_cplx.cu serves the rest of the FFT
// route and the chirp-z route; the cluster and global kernels the longer
// frames.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// the analysis phase of the merged TPU gate kernel
// (noisereduce_tpu/ops/pallas/dispatch.py::_merged_gate_from_blocks), and the
// noise-clip spectra of dispatch.py::_fused_stft_planes (:556).
//
// Computes, for view c of signal row h and frame t,
//   Z[b, t, k] = s * sum_{n < frame_length} w[n] x_c[t*hop + n - bpad] e^{-2 pi i k n / N}
// with b = h * n_chunks + c, s = 1/sum w (scipy) or 1 (torch), time-major
// (rows, n_frames, n_bins) re/im planes; view c covers source samples
// [c*chunk_stride + view_start, + view_len), zero outside [0, n_src) and
// outside the view. ws = s * w (frame_length values) comes from the host.
//
// Bound on this card: bytes. The signal read once and the two planes written
// once (0.2 + 0.815 GB for 960 s of 48 kHz audio at n_fft 1024: 0.30 ms at
// 3.35 TB/s); the real FFT's ~2.5 N log2 N operations a frame are ~1% of a
// DFT product's. The bf16 build (planes.cuh) reads a bf16 signal and stores
// bf16 planes, the FFT in float32: 0.1 + 0.41 GB, 0.15 ms.
//
// Design: tiles of tile_frames consecutive frames of one view
// (geometry.py's fft_tile_frames: the frame slots of the block's thread
// segments, 8 at n_fft 1024, 5 at 1536, 20 at 400; 204 at 40, 4,096 at 2,
// a span of (tile_frames - 1) * hop + frame_length samples at hops of 1 to
// 16). Persistent blocks, as
// many as the card holds at once (nr_spectra_fft_capacity; 2 an SM, 64
// registers a thread), walk the tiles b, b + grid, ..., stage the window
// once, and copy the next tile's signal span ((tile_frames - 1) * hop +
// frame_length samples, zero filled by the view and signal bounds) with
// 16-byte cp.async (tile_span.cuh::issue_span: raw plane values, widened
// where they are packed, so a bf16 sample waits in no guard's branch)
// while this tile's stages and unpack run. Each segment packs its windowed
// frames as M = N/2 complex points (even samples real, odd imaginary; zero
// past frame_length) and runs the M-point FFT with every stage out of place
// between the block's two buffers (a thread stores a butterfly as soon as
// it has it, so no value is held across a barrier), the stages' twiddles
// from a table laid out once a block in shared memory in the order the
// stages read them (fft_smem.cuh::lay_twiddles: a warp reads consecutive
// entries, where its reads of the host table spread over up to 28 lines of
// the L1 cache); the unpack takes
//   X[k] = (Z[k] + conj Z[M-k]) / 2 - i e^{-2 pi i k/N} (Z[k] - conj Z[M-k]) / 2
// (indices mod M; fft_smem.cuh::split), one thread for the pair k, M - k:
// (M + 1) / 2 slots a frame, slot 0 giving bins 0 and M and, for an even M,
// M/2 as well (an odd M has no middle bin). A tile's rows are one
// contiguous run of tile_frames x n_bins values in each plane, which the
// unpack stores straight into the planes, neighbouring threads on
// neighbouring bins.
//
// Two kernels: spectra_fft_kernel<ODD> for an M with an odd prime factor
// (fft_smem.cuh's plan, divisions by multiply-high, its stages by
// fft_frames_large), and spectra_pow2_kernel for a power of two M, whose
// indices are shifts and masks of log2 M, whose segments keep four indices
// and whose first stage packs its points from the span as it loads them,
// no pass of its own through shared memory (nrf::p2); M = 1 (n_fft 2) has
// no stage, so its frames are packed by a pass of their own, each one
// point u[0] + i u[1] whose split gives bins 0 and 1.
#include "fft_smem.cuh"
#include "planes.cuh"
#include "tile_span.cuh"

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

// One radix-R Stockham stage of the forward transform over the segment's
// frames among the first n_frames, out of place, from the points load(e)
// (e = f M + q: point q of frame f) to dst: each thread loads, twiddles
// and transforms a butterfly and stores it at once, so no value is held
// across the segment's barrier; its twiddles from the stages' laid table
// stw (lay_twiddles). Called by every thread of the segment.
template <int R, class Load>
__device__ __forceinline__ void stage_oop(Load load, float2* __restrict__ dst, int log2m, int ns,
                                          int n_frames, const float2* __restrict__ stw,
                                          const Seg& sg) {
  constexpr int P = PP / R;  // butterflies per thread
  constexpr int LOG2R = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int M = 1 << log2m;
  const int log2mr = log2m - LOG2R;
  const int mr = 1 << log2mr;
  const int n_bfly = n_frames << log2mr;
  const int bfly0 = sg.first >> LOG2R;  // the segment's first butterfly
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = bfly0 + sg.lane + (p << sg.log2t);
    if (idx < n_bfly) {
      const int f = idx >> log2mr;
      const int j = idx & (mr - 1);
      const int base = f * M + j;
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = load(base + r * mr);
      const int jm = j & (ns - 1);
      if (jm) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], stw[r * ns + jm - 1]);
      }
      dft<R, false>(v);
      const int d = f * M + (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[pad(d + r * ns)] = v[r];
    }
  }
  seg_sync(sg);
}

// the radix of the stage of sub-transform size ns: 8 while at least 8 of M
// remain, then 4 or 2
__device__ __forceinline__ int radix(int M, int ns) { return min(8, M / ns); }

// The stages' twiddles laid out in the order their threads read them
// (fft_smem.cuh::lay_twiddles_by): stage (ns, R)'s entries, ns <= v < ns R,
// from the n_fft = 2M point table, step 2M / (ns R). Every thread of the
// block calls it, once.
__device__ __forceinline__ void lay_twiddles(float2* stw, const float2* __restrict__ tw,
                                             int log2m) {
  const int M = 1 << log2m;
  lay_twiddles_by(stw, tw, M, THREADS, [&](int v, int& ns, int& tstep) {
    ns = 1;
    while (ns * radix(M, ns) <= v) ns *= radix(M, ns);
    tstep = 2 * (M / (ns * radix(M, ns)));
  });
}

// The stage of sub-transform size ns, from load's points to dst
template <class Load>
__device__ __forceinline__ void stage(Load load, float2* dst, int log2m, int ns, int n_frames,
                                      const float2* __restrict__ stw, const Seg& sg) {
  switch (radix(1 << log2m, ns)) {
    case 8: stage_oop<8>(load, dst, log2m, ns, n_frames, stw, sg); break;
    case 4: stage_oop<4>(load, dst, log2m, ns, n_frames, stw, sg); break;
    default: stage_oop<2>(load, dst, log2m, ns, n_frames, stw, sg);
  }
}

// The M-point complex DFT's stages from sub-transform size ns on, over the
// segment's frames among the first n_frames, natural order out, from z
// through sc and z in turns. The caller has synchronised the segment after
// filling its frames; they are synchronised on return. Returns the buffer
// that holds the result.
__device__ __forceinline__ float2* fft_frames(float2* z, float2* sc, int log2m, int ns,
                                              int n_frames, const float2* __restrict__ stw,
                                              const Seg& sg) {
  for (const int M = 1 << log2m; ns < M; ns *= radix(M, ns)) {
    stage([z](int e) { return z[pad(e)]; }, sc, log2m, ns, n_frames, stw, sg);
    float2* t = z;
    z = sc;
    sc = t;
  }
  return z;
}

}  // namespace p2
}  // namespace nrf

namespace {

constexpr int BLOCKS_PER_SM = 2;  // two buffers of 4096 points a block

// The views and tiles of a launch (a kernel parameter)
struct Views {
  long long n_src, chunk_stride, view_start;
  int n_chunks, view_len, n_frames, hop, bpad, win, n_bins, tile_frames, n_tiles, total;
};

// A block's shared memory: two buffers of its points (z, sc), the stages'
// laid twiddles (stw: M - 1 entries, made even), the span's raw plane
// values with their slack, the window, the span's phase
template <class T>
struct Smem {
  float2* z;
  float2* sc;
  float2* stw;
  nrs::Raw<T>* raw;
  float* wsm;
  int* span_ph;
};

template <class T>
__device__ __forceinline__ Smem<T> smem_of(const Views& v) {
  extern __shared__ __align__(16) float2 smem2[];
  Smem<T> s;
  s.z = smem2;
  s.sc = smem2 + nrf::PADDED;
  s.stw = s.sc + nrf::PADDED;
  s.raw = reinterpret_cast<nrs::Raw<T>*>(s.stw + (v.n_bins & ~1));
  s.wsm = reinterpret_cast<float*>(s.raw +
                                   nrs::run_elems<T>((v.tile_frames - 1) * v.hop + v.win));
  s.span_ph = reinterpret_cast<int*>(s.wsm + v.win);
  return s;
}

template <class T>
size_t smem_bytes(int m, int tile_frames, int hop, int win) {
  return sizeof(float2) * (2 * nrf::PADDED + ((m + 1) & ~1)) +
         sizeof(nrs::Raw<T>) * nrs::run_elems<T>((tile_frames - 1) * hop + win) +
         sizeof(float) * win + sizeof(int);
}

// A block's persistent walk over the tiles blockIdx.x, + gridDim.x, ...:
// the window staged once and the first tile's span copied; then for each
// tile, once its span has landed, pack(t, span) fills the segments' slots,
// and behind a barrier (every read of the span done) the next tile's span
// is copied while transform(t) runs the stages and the unpack.
template <class T, class Pack, class Transform>
__device__ __forceinline__ void walk(const T* __restrict__ x, const Views& v, const Smem<T>& s,
                                     const float* __restrict__ ws, Pack pack,
                                     Transform transform) {
  const auto tile = [&](int i) {
    return nrs::tile_of(i, v.n_tiles, v.n_chunks, v.tile_frames, v.n_frames, v.hop, v.bpad,
                        v.win, v.chunk_stride, v.view_start);
  };
  const auto issue = [&](const nrs::Tile& t) {
    const int ph = nrs::issue_span<T, nrf::THREADS>(x + (long long)(t.b / v.n_chunks) * v.n_src,
                                                    t, v.view_len, v.n_src, s.raw);
    if (threadIdx.x == 0) *s.span_ph = ph;
  };
  for (int i = threadIdx.x; i < v.win; i += nrf::THREADS) s.wsm[i] = __ldg(ws + i);
  if ((int)blockIdx.x < v.total) issue(tile(blockIdx.x));
  for (int i = blockIdx.x; i < v.total; i += gridDim.x) {
    const nrs::Tile t = tile(i);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // the span and its phase landed; the last unpack done
    pack(t, s.raw + *s.span_ph);
    __syncthreads();  // every read of the span done
    if (i + (int)gridDim.x < v.total) issue(tile(i + gridDim.x));
    transform(t);
  }
}

// a raw span sample as a float
template <class R>
__device__ __forceinline__ float smp(const R* sp, int i) {
  return nrs::widen_raw(sp[i]);
}

template <int ODD, class T>  // fft_smem.cuh::odd_primes of M; the plane type
__global__ void __launch_bounds__(nrf::THREADS, BLOCKS_PER_SM)
    spectra_fft_kernel(const T* __restrict__ x, const Views v, const float* __restrict__ ws,
                       const float2* __restrict__ tw, T* __restrict__ re, T* __restrict__ im,
                       const nrf::Plan<true> plan) {
  const Smem<T> s = smem_of<T>(v);
  const int m = plan.m.d;
  // each segment of threads packs, transforms and unpacks its own frames
  const nrf::Seg sg = nrf::segment(plan);
  const int first = sg.f0 * m;  // the segment's first point
  nrf::lay_twiddles(s.stw, tw, m, plan, nrf::THREADS);
  walk(x, v, s, ws,
       [&](const nrs::Tile& t, const nrs::Raw<T>* sp) {
         // windowed frames, packed: z[f][q] = u[2q] + i u[2q+1]
         const int nf = nrf::seg_frames(sg, plan, t.fe);
         for (int e = sg.lane; e < nf * m; e += plan.threads) {
           const int fl = plan.m.div(e);
           const int n = 2 * (e - fl * m);
           const int o = (sg.f0 + fl) * v.hop + n;
           s.z[nrf::pad(first + e)] =
               make_float2(n < v.win ? s.wsm[n] * smp(sp, o) : 0.f,
                           n + 1 < v.win ? s.wsm[n + 1] * smp(sp, o + 1) : 0.f);
         }
       },
       [&](const nrs::Tile& t) {
         const float2* zo = nrf::fft_frames_large<false, ODD, false>(
             s.z, s.sc, m, t.fe, s.stw, sg, plan);
         // unpack the real spectrum into the tile's contiguous rows: slot
         // k of frame f writes bins k and M - k (slot 0: 0 and M, and M/2
         // for an even M)
         const int nf = nrf::seg_frames(sg, plan, t.fe);
         const int half = (m + 1) >> 1;  // slots a frame
         const long long o0 = ((long long)t.b * v.n_frames + t.t0) * v.n_bins;
         T* const rre = re + o0;  // the tile's rows
         T* const rim = im + o0;
         for (int e = sg.lane; e < nf * half; e += plan.threads) {
           const int fl = plan.half.div(e);
           const int k = e - fl * half;
           const int base = first + fl * m;
           const int row = (sg.f0 + fl) * v.n_bins;
           const float2 zk = zo[nrf::pad(base + k)];
           const float2 zm = zo[nrf::pad(base + (k ? m - k : 0))];
           float2 lo, hi;
           nrf::split(zk, zm, __ldg(tw + k), lo, hi);
           planes::st(rre + row + k, lo.x);
           planes::st(rim + row + k, lo.y);
           planes::st(rre + row + m - k, hi.x);
           planes::st(rim + row + m - k, hi.y);
           if (k == 0 && !(m & 1)) {
             const float2 zh = zo[nrf::pad(base + m / 2)];
             nrf::split(zh, zh, __ldg(tw + m / 2), lo, hi);
             planes::st(rre + row + m / 2, lo.x);
             planes::st(rim + row + m / 2, lo.y);
           }
         }
       });
}

// The same computation for a power of two M, indexed by shifts of log2 M
// (nrf::p2's segments and stages).
template <class T>
__global__ void __launch_bounds__(nrf::THREADS, BLOCKS_PER_SM)
    spectra_pow2_kernel(const T* __restrict__ x, const Views v, const float* __restrict__ ws,
                        const float2* __restrict__ tw, T* __restrict__ re, T* __restrict__ im,
                        int log2m) {
  const Smem<T> s = smem_of<T>(v);
  const int M = 1 << log2m;
  // each segment of threads packs, transforms and unpacks its own frames
  const nrf::p2::Seg sg = nrf::p2::segment(log2m);
  const int step = 1 << sg.log2t;
  const int seg_end = sg.first + (step << nrf::p2::LOG2PP);
  nrf::p2::lay_twiddles(s.stw, tw, log2m);
  walk(x, v, s, ws,
       [&](const nrs::Tile& t, const nrs::Raw<T>* sp) {
         // point q of frame f is u[2q] + i u[2q+1], each windowed sample a
         // rounded product, as stored
         const auto point = [&](int e) {
           const int f = e >> log2m;
           const int n = 2 * (e - (f << log2m));
           const int o = f * v.hop + n;
           return make_float2(n < v.win ? __fmul_rn(s.wsm[n], smp(sp, o)) : 0.f,
                              n + 1 < v.win ? __fmul_rn(s.wsm[n + 1], smp(sp, o + 1)) : 0.f);
         };
         if (log2m == 0) {  // M = 1: no stage; each frame one point
           for (int e = sg.first + sg.lane; e < min(t.fe, seg_end); e += step)
             s.z[nrf::pad(e)] = point(e);
         } else {  // the first stage, its points packed as it loads them
           nrf::p2::stage(point, s.z, log2m, 1, t.fe, s.stw, sg);
         }
       },
       [&](const nrs::Tile& t) {
         const float2* zo =
             nrf::p2::fft_frames(s.z, s.sc, log2m, nrf::p2::radix(M, 1), t.fe, s.stw, sg);
         // unpack the real spectrum into the tile's contiguous rows: slot
         // k < max(M/2, 1) of frame f writes bins k and M - k (slot 0: 0, M
         // and, for M >= 2, M/2)
         const int log2s = log2m ? log2m - 1 : 0;  // log2 of the slots a frame
         const int shift = log2m - log2s;          // points a slot, log2
         const long long o0 = ((long long)t.b * v.n_frames + t.t0) * v.n_bins;
         T* const rre = re + o0;  // the tile's rows
         T* const rim = im + o0;
         for (int e = (sg.first >> shift) + sg.lane;
              e < min(t.fe << log2s, seg_end >> shift); e += step) {
           const int f = e >> log2s;
           const int k = e & ((1 << log2s) - 1);
           const int base = f << log2m;
           const int row = f * v.n_bins;
           const float2 zk = zo[nrf::pad(base + k)];
           const float2 zm = zo[nrf::pad(base + ((M - k) & (M - 1)))];
           float2 lo, hi;
           nrf::split(zk, zm, __ldg(tw + k), lo, hi);
           planes::st(rre + row + k, lo.x);
           planes::st(rim + row + k, lo.y);
           planes::st(rre + row + M - k, hi.x);
           planes::st(rim + row + M - k, hi.y);
           if (k == 0 && M > 1) {
             const float2 zh = zo[nrf::pad(base + M / 2)];
             nrf::split(zh, zh, __ldg(tw + M / 2), lo, hi);
             planes::st(rre + row + M / 2, lo.x);
             planes::st(rim + row + M / 2, lo.y);
           }
         }
       });
}

// f(kernel, Of<T>, odd) for the build of M = n_fft / 2 and planes of type
// `plane`: spectra_pow2_kernel<T> for a power of two M, else
// spectra_fft_kernel<ODD, T>
template <class F>
int with_real_kernel(int plane, int m, F f) {
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return nrf::with_odd_primes(m, [&](auto odd) {
      constexpr int ODD = decltype(odd)::value;
      if constexpr (ODD == 1)
        return f(spectra_pow2_kernel<T>, tag, odd);
      else
        return f(spectra_fft_kernel<ODD, T>, tag, odd);
    });
  });
}

}  // namespace

// plane: the type of x, re and im (planes.cuh: 0 float32, 1 bfloat16); x:
// (rows, n_src); ws: (win,) f32; tw: (n_fft,) complex f32; re/im:
// (rows*n_chunks, n_frames, n_bins). n_fft must be one fft_smem.cuh
// serves, seg_warps a segment of warps that holds a frame, and tile_frames
// at most the frame slots of the block's segments. Launches persistent
// blocks, at most nr_spectra_fft_capacity of them. Returns
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
  const Views v{n_src, chunk_stride, view_start, n_chunks, view_len, n_frames, hop, bpad,
                win, n_bins, tile_frames, n_tiles, B * n_tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  return with_real_kernel(plane, m, [&](auto kernel, auto tag, auto odd) {
    using T = typename decltype(tag)::type;
    const size_t smem = smem_bytes<T>(m, tile_frames, hop, win);
    // persistent: the blocks the card holds at once
    const int fit = nrs::active_blocks(kernel, smem, nrf::THREADS);
    if (fit < 0) return -fit;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)(v.total < fit ? v.total : fit);
    const T* xt = static_cast<const T*>(x);
    T* ret = static_cast<T*>(re);
    T* imt = static_cast<T*>(im);
    if constexpr (decltype(odd)::value == 1) {
      int log2m = 0;
      while ((1 << log2m) < m) ++log2m;
      kernel<<<grid, nrf::THREADS, smem, st>>>(xt, v, ws, tw2, ret, imt, log2m);
    } else {
      kernel<<<grid, nrf::THREADS, smem, st>>>(xt, v, ws, tw2, ret, imt,
                                               nrf::make_plan<true>(m, seg_warps));
    }
    return (int)cudaGetLastError();
  });
}

// The persistent grid of nr_spectra_fft for these arguments: the blocks of
// its build the current device holds at once; a negative CUDA error code on
// failure (invalid: an n_fft the real-FFT kernels do not take).
extern "C" int nr_spectra_fft_capacity(int plane, int n_fft, int tile_frames, int hop,
                                       int win) {
  if (!nrf::real_kernel(n_fft) || tile_frames < 1) return -(int)cudaErrorInvalidValue;
  return with_real_kernel(plane, n_fft / 2, [&](auto kernel, auto tag, auto) {
    using T = typename decltype(tag)::type;
    return nrs::active_blocks(kernel, smem_bytes<T>(n_fft / 2, tile_frames, hop, win),
                              nrf::THREADS);
  });
}
