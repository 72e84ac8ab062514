// Kernel A, cluster routes: spectra of every chunk view for an n_fft whose
// transform's n has no prime factor above 13 and is past a big block
// (fft_route.cuh: n_fft 16386 to 131072, e.g. 40000 at 48 kHz), and on the
// cluster chirp route (CHIRP, below) for any other n to 32,768 points.
// The kernel template and its launch; spectra_cluster.cu builds and binds
// the cluster route's builds, spectra_cluster_chirp.cu the chirp's, so
// that nvcc compiles the two sets in parallel.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// as spectra_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// on its matrix unit (noisereduce_tpu/ops/pallas/geometry.py:75). Before
// this route such an n_fft took a DFT-product route here (since retired), whose n_fft x
// n_fft tables and O(n_fft) work a bin do not scale.
//
// Computes what spectra_cplx.cu computes on the FFT route, into the same
// time-major planes: a frame slot of n points holds
// - even N: n = N / 2, z[q] = u[2q] + i u[2q+1], unpacked by
//   fft_smem.cuh::split into bins k and (Nyquist) n;
// - odd N (PAIRED): n = N, frames 2s and 2s + 1 (zero past the last),
//   z[j] = u_a[j] + i u_b[j], separated as
//   X_a[k] = (Z[k] + conj Z[n-k]) / 2, X_b[k] = -i (Z[k] - conj Z[n-k]) / 2.
// Persistent clusters of c blocks walk the slots (fft_cluster.cuh's
// four-step FFT): step 1's first stage takes each block's columns'
// windowed samples, consecutive threads on consecutive points, from the
// free buffer where cp.async staged them while the previous slot unpacked
// (float32, an even N, a frame inside the view), else straight from the
// signal (L2 holds a frame; the window is read where it is used); after the
// transform each block unpacks the bins k whose k mod n2 its rows hold,
// consecutive threads on consecutive bins, the partner n - k read from the
// block that holds it (PERF.md: a pull of that block's buffer first, an
// order of rows that keeps each partner in its own block, and 4 or 8 bins
// a thread in flight all ran slower). Two cluster barriers a slot and two
// split ones: the partner reads of a slot end before the next slot's first
// stage writes the buffer they read.
//
// The cluster chirp route (CHIRP; fft_route.cuh: an n with a prime factor
// above 13 past 4096 points, or a 13-smooth n past a big block with no
// cluster shape, to 32,768 points) takes the same slots through a chirp-z
// transform of length L >= 2n - 1 (the cluster's four-step FFT of L
// points), as spectra_cplx.cu takes it within a block:
//   Z[k] = cbar_k sum_j (z_j cbar_j) c_{k-j},  c_j = e^{i pi j^2 / n}:
// step 1's gather multiplies each point j < n by cbar_j and writes zero for
// j >= n without loading it; fft_cluster.cuh::cluster_convolve takes the
// L-point FFT, the product with the filter spectrum in the FFT's own order
// and the unscaled inverse back to natural order; the unpack reads points
// k < n (or the bins, PAIRED) times cbar_k, the partner n - k from the
// block that holds it. The host builds cbar_j from the exact j^2 mod 2n and
// the filter FFT_L(c wrapped) / L in float64 (kernels.py), both rounded
// once to float32.
//
// Bound on this card: bytes, as spectra_fft.cu: the function reads the
// signal once and writes the planes once; its FFT is O(log n) a point (the
// chirp's two L-point transforms are operations of this algorithm, not of
// the function).
#pragma once

#include "fft_cluster.cuh"
#include "planes.cuh"

namespace {

// cp.async copies of 8 and 4 bytes from global to shared memory
__device__ __forceinline__ void copy8(void* to, const void* from) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(to)),
               "l"(from)
               : "memory");
}
__device__ __forceinline__ void copy4(void* to, const void* from) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(to)),
               "l"(from)
               : "memory");
}

// A slot of the walk: its view, its (first) frame and where that frame's
// window starts in the signal
struct Slot {
  int b, fa;
  bool has_b, whole;  // whole: the frames' windows lie inside the view and the signal
  long long s0;       // the view's first signal position
  long long start;    // the signal position of frame fa's first window sample
  long long row0;     // the signal row's first element
};

template <bool PAIRED, int ODD, bool CHIRP, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::CLUSTER_THREADS, nrf::cluster_min_blocks(ODD))
    spectra_cluster_kernel(const P* __restrict__ x, long long n_src, int n_chunks,
                           long long chunk_stride, long long view_start, int view_len,
                           int n_frames, int hop, int bpad, int win, int n_bins, int n_slots,
                           int n_total, const float* __restrict__ ws,
                           const float2* __restrict__ tw1, const float2* __restrict__ tw2,
                           const float2* __restrict__ twn, const float2* __restrict__ tws,
                           const float2* __restrict__ chirp, const float2* __restrict__ filt,
                           P* __restrict__ re, P* __restrict__ im, const nrf::Four f) {
  namespace cg = nrf::cg;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float2 smem2[];
  float2* const z0 = smem2;
  float2* const z1 = smem2 + f.buffer;
  const int rank = (int)cl.block_rank();
  const int clusters = gridDim.x / f.c;
  const bool ws_pairs = !(reinterpret_cast<size_t>(ws) % sizeof(float2));

  auto locate = [&](int slot) {
    Slot sl;
    sl.b = slot / n_slots;
    const int h = sl.b / n_chunks;
    const int c = sl.b - h * n_chunks;
    sl.fa = PAIRED ? 2 * (slot - sl.b * n_slots) : slot - sl.b * n_slots;
    sl.has_b = PAIRED && sl.fa + 1 < n_frames;
    sl.s0 = c * chunk_stride + view_start;
    sl.row0 = (long long)h * n_src;
    sl.start = sl.s0 + (long long)sl.fa * hop - bpad;
    auto inside = [&](int t) {
      const long long p0 = (long long)t * hop - bpad, p1 = p0 + win - 1;
      return p0 >= 0 && p1 < view_len && sl.s0 + p0 >= 0 && sl.s0 + p1 < n_src;
    };
    sl.whole = inside(sl.fa) && (!sl.has_b || inside(sl.fa + 1));
    return sl;
  };
  // whether a slot's samples are staged in shared memory ahead of its
  // transform: float32 planes, an even N whose window fills the frame, a
  // frame inside the view and the signal
  auto staged = [&](const Slot& sl) {
    return !PAIRED && sizeof(P) == sizeof(float) && sl.whole && win == 2 * f.pts;
  };
  // the staging of a slot's samples: step 1's point (col, j2) at j2 cols +
  // col of `to`, samples 2j and 2j + 1 (8 bytes a copy where they are
  // aligned, else two copies of 4), consecutive threads on consecutive
  // points of the signal; on the chirp route the points j < n only
  auto stage_in = [&](const Slot& sl, float2* to) {
    if constexpr (!PAIRED && sizeof(P) == sizeof(float)) {
      const float* src = reinterpret_cast<const float*>(x) + sl.row0 + sl.start +
                         2 * rank * f.cols;
      const bool aligned = !(reinterpret_cast<size_t>(src) % sizeof(float2));
      for (int e = threadIdx.x; e < f.cols * f.n2; e += nrf::CLUSTER_THREADS) {
        const int j2 = f.dcols.div(e);
        if (CHIRP && rank * f.cols + e - j2 * f.cols + f.n1 * j2 >= f.pts) continue;
        const float* p = src + 2 * (e - j2 * f.cols + f.n1 * j2);
        if (aligned) {
          copy8(to + e, p);
        } else {
          copy4(&to[e].x, p);
          copy4(&to[e].y, p + 1);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float2* spare = z0;    // the buffer that holds the staged samples of the slot to run
  float2* held = z1;     // the buffer the other blocks read last (the partner reads)
  bool pending = false;  // ... until every block arrives after them
  int slot = blockIdx.x / f.c;
  Slot cur = locate(slot);
  bool cur_staged = staged(cur);
  if (cur_staged) stage_in(cur, spare);
  for (; slot < n_total; slot += clusters) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (pending) nrf::cluster_wait();  // the partner reads of `held` are done
    const Slot sl = cur;
    const bool from_spare = cur_staged;
    const P* const xr = x + sl.row0;

    // windowed sample u of frame t of the view, zero outside it and the signal
    auto sample = [&](int t, int u) -> float {
      if (u >= win) return 0.f;
      const long long p = (long long)t * hop + u - bpad;  // view position
      const long long q = sl.s0 + p;
      return sl.whole || (p >= 0 && p < view_len && q >= 0 && q < n_src)
                 ? __ldg(ws + u) * planes::ld(xr + q)
                 : 0.f;
    };
    const float2* const staging = spare;
    // step 1's point j2 of column col: point j = j1 + n1 j2, j1 = rank cols + col
    auto point = [&](int col, int j2, int j) -> float2 {
      if constexpr (PAIRED) {
        return make_float2(sample(sl.fa, j), sl.has_b ? sample(sl.fa + 1, j) : 0.f);
      } else {
        if (from_spare) {  // samples 2j and 2j + 1, and the window's (one load each)
          const float2 wv = ws_pairs ? __ldg(reinterpret_cast<const float2*>(ws) + j)
                                     : make_float2(__ldg(ws + 2 * j), __ldg(ws + 2 * j + 1));
          const float2 xv = staging[j2 * f.cols + col];
          return make_float2(wv.x * xv.x, wv.y * xv.y);
        }
        return make_float2(sample(sl.fa, 2 * j), sample(sl.fa, 2 * j + 1));
      }
    };
    auto gather = [&](int col, int j2) -> float2 {
      const int j = rank * f.cols + col + f.n1 * j2;
      if constexpr (CHIRP) {  // z_j cbar_j, zero past n
        return j < f.pts ? nrf::cmul(point(col, j2, j), __ldg(chirp + j)) : make_float2(0.f, 0.f);
      } else {
        return point(col, j2, j);
      }
    };
    float2* w;
    if constexpr (CHIRP)
      w = nrf::cluster_convolve<false, ODD>(held, spare, cl, f, rank, gather, filt, tw1, tw2,
                                            twn);
    else
      w = nrf::cluster_fft<false, ODD>(held, spare, cl, f, rank, gather, tw1, tw2, twn);
    cl.sync();  // every block's points of the output are in its buffer w

    // the next slot's samples, staged in the free buffer while this one unpacks
    float2* const other = w == z0 ? z1 : z0;
    cur_staged = false;
    if (slot + clusters < n_total) {
      cur = locate(slot + clusters);
      cur_staged = staged(cur);
      if (cur_staged) stage_in(cur, other);
    }

    // bin k (and the Nyquist bin n from k = 0), or bin k of both frames
    // (PAIRED), from the transform's points k and n - k
    const long long row = ((long long)sl.b * n_frames + sl.fa) * n_bins;
    auto emit = [&](int k, float2 zk, float2 zm) {
      if constexpr (PAIRED) {
        planes::st(re + row + k, 0.5f * (zk.x + zm.x));
        planes::st(im + row + k, 0.5f * (zk.y - zm.y));
        if (sl.has_b) {
          planes::st(re + row + n_bins + k, 0.5f * (zk.y + zm.y));
          planes::st(im + row + n_bins + k, 0.5f * (zm.x - zk.x));
        }
      } else {
        float2 lo, hi;
        nrf::split(zk, zm, __ldg(tws + k), lo, hi);
        planes::st(re + row + k, lo.x);
        planes::st(im + row + k, lo.y);
        if (k == 0) {  // the Nyquist bin n
          planes::st(re + row + f.pts, hi.x);
          planes::st(im + row + f.pts, hi.y);
        }
      }
    };
    if constexpr (CHIRP) {
      // unpack the points k < n (bins k < n_bins, PAIRED) that this
      // block's columns hold, k = j1 + n1 j2, consecutive threads on
      // consecutive j1, each times cbar_k, the partner n - k times
      // cbar_{n-k} from the block that holds it
      const int k_end = PAIRED ? n_bins : f.pts;
      const int j2_end = min(f.n2, (k_end + f.n1 - 1) / f.n1);
      for (int e = threadIdx.x; e < f.cols * j2_end; e += nrf::CLUSTER_THREADS) {
        const int j2 = f.dcols.div(e);
        const int col = e - j2 * f.cols;
        const int k = rank * f.cols + col + f.n1 * j2;
        if (k >= k_end) continue;
        const int km = k ? f.pts - k : 0;
        emit(k, nrf::cmul(w[j2 * f.ldc + col], __ldg(chirp + k)),
             nrf::cmul(nrf::cluster_column_point(w, cl, f, km), __ldg(chirp + km)));
      }
    } else {
      // unpack the bins k = k2 + n2 k1 whose k2 this block's rows hold,
      // consecutive threads on consecutive k2, the partner n - k read from
      // the block that holds it
      for (int e = threadIdx.x; e < f.rows * f.n1; e += nrf::CLUSTER_THREADS) {
        const int k1 = f.drows.div(e);
        const int r = e - k1 * f.rows;
        const int k = rank * f.rows + r + f.n2 * k1;
        if (PAIRED && k >= n_bins) continue;
        emit(k, w[k1 * f.ldr + r], nrf::cluster_point(w, cl, f, k ? f.n - k : 0));
      }
    }
    nrf::cluster_arrive();  // this block's partner reads are done
    pending = true;
    held = w;
    spare = other;
  }
  if (pending) nrf::cluster_wait();  // no block leaves while another reads its buffer
}

// the build of kernel A for an FFT of n points (L on the chirp route)
template <bool PAIRED, bool CHIRP, class T>
auto spectra_cluster_build(int n) {
  if constexpr (CHIRP)
    return nrf::with_chirp_build(n, [](auto odd) {
      return spectra_cluster_kernel<PAIRED, decltype(odd)::value, true, T>;
    });
  else
    return nrf::with_cluster_build(n, [](auto odd) {
      return spectra_cluster_kernel<PAIRED, decltype(odd)::value, false, T>;
    });
}

// Launch kernel A's CHIRP builds (the arguments of nr_spectra_cluster_chirp,
// spectra_cluster_chirp.cu; chirp and filt null off the chirp route).
// Returns the launch's error code.
template <bool CHIRP>
int spectra_cluster_launch(int plane, const void* x, long long n_src, int rows, int n_chunks,
                           long long chunk_stride, long long view_start, int view_len,
                           int n_frames, int hop, int bpad, int win, int n_fft, int n_bins,
                           int slot, const float* ws, const float* tw1, const float* tw2,
                           const float* twn, const float* tws, const float* chirp,
                           const float* filt, void* re, void* im, void* stream) {
  nrf::Four f;
  const bool paired = n_fft % 2;
  if (!nrf::make_four_of<CHIRP>(n_fft, slot, f) || n_bins != n_fft / 2 + 1 ||
      (CHIRP && !(chirp && filt)))
    return (int)cudaErrorInvalidValue;
  const int B = rows * n_chunks;
  if (B <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_slots = paired ? (n_frames + 1) / 2 : n_frames;
  const long long total = (long long)B * n_slots;
  if (total > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const auto run = [&](auto kernel) {
      return nrf::launch_clusters(
          kernel, total, nrf::cluster_smem(f), st, f.c, static_cast<const T*>(x), n_src,
          n_chunks, chunk_stride, view_start, view_len, n_frames, hop, bpad, win, n_bins,
          n_slots, (int)total, ws, reinterpret_cast<const float2*>(tw1),
          reinterpret_cast<const float2*>(tw2), reinterpret_cast<const float2*>(twn),
          reinterpret_cast<const float2*>(tws), reinterpret_cast<const float2*>(chirp),
          reinterpret_cast<const float2*>(filt), static_cast<T*>(re), static_cast<T*>(im), f);
    };
    return paired ? run(spectra_cluster_build<true, CHIRP, T>(f.n))
                  : run(spectra_cluster_build<false, CHIRP, T>(f.n));
  });
}

// Clusters of kernel A's CHIRP build for n_fft and an FFT of slot points
// (plane type `plane`) that the current device holds at once: the
// persistent grid of a launch with at least as many slots; a negative CUDA
// error code on failure.
template <bool CHIRP>
int spectra_cluster_capacity(int plane, int n_fft, int slot) {
  nrf::Four f;
  if (!nrf::make_four_of<CHIRP>(n_fft, slot, f)) return -(int)cudaErrorInvalidValue;
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return n_fft % 2 ? nrf::active_clusters(spectra_cluster_build<true, CHIRP, T>(f.n),
                                            nrf::cluster_smem(f), f.c)
                     : nrf::active_clusters(spectra_cluster_build<false, CHIRP, T>(f.n),
                                            nrf::cluster_smem(f), f.c);
  });
}

}  // namespace
