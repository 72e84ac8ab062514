// Kernel D, cluster routes: mask apply, inverse FFT, overlap-add, envelope
// division and the output window for an n_fft whose transform's n has no
// prime factor above 13 and is past a big block (fft_route.cuh: n_fft
// 16386 to 131072, e.g. 40000 at 48 kHz), and on the cluster chirp route
// (CHIRP, below) for any other n to 32,768 points. The kernel templates
// and their launch; istft_cluster.cu builds and binds the cluster route's
// builds, istft_cluster_chirp.cu the chirp's, so that nvcc compiles the
// two sets in parallel.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// (noisereduce_tpu/ops/pallas/geometry.py:146). Before this route such an
// n_fft took a DFT-product route here (since retired), whose n_fft x hop tables per frame
// shift and O(n_fft) work a sample do not scale.
//
// Computes what istft_cplx.cu computes on the FFT route, with the same
// overlap-add order (frames in ascending t, one fmaf each), envelope and
// trim, in two passes:
// 1. istft_cluster_kernel: persistent clusters of c blocks walk the frame
//    slots that the output window needs (frames t_lo to t_hi of each row;
//    geometry.py::cluster_frames), each frame transformed once: step 1's
//    first stage gathers each block's columns' points straight from the
//    planes, consecutive threads on consecutive bins (each point from its
//    own bins, so no block waits for another's), the cluster takes the
//    slot's unscaled inverse transform (fft_cluster.cuh), and each block
//    writes the frame samples its rows hold to a scratch of (rows, frames,
//    win) float32, consecutive threads on consecutive samples. A slot of n
//    points holds
//    - even N: n = N / 2, the point j = unsplit(Y[j], Y[n - j] (Y[n] for
//      j = 0)) of Y = Z * mask (no imaginary DC or Nyquist part), whose
//      inverse holds n (y[2m] + i y[2m+1]);
//    - odd N (PAIRED): n = N, frames 2s and 2s + 1 (zero past the last),
//      W[k] = Y_a[k] + i Y_b[k], W[n-k] = conj Y_a[k] + i conj Y_b[k]
//      (k < (n + 1) / 2), whose inverse holds n (y_a + i y_b).
//    One cluster barrier a slot and one split one: the exchange's reads
//    end before the buffer they read is next written.
// 2. istft_cluster_ola_kernel: a thread a trimmed output sample, its
//    frames' post[u] y_t[u] summed from the scratch, then the envelope
//    division. No output hop block is transformed twice, and no block
//    waits for a cluster to overlap-add.
//
// The cluster chirp route (CHIRP; fft_route.cuh, as spectra_cluster.cuh)
// takes pass 1's inverse as a chirp-z transform of length L >= 2n - 1, the
// conjugate of kernel A's, as istft_cplx.cu takes it within a block:
//   y_j = c_j sum_k (W_k c_k) cbar_{j-k},  c_j = e^{i pi j^2 / n}:
// step 1's gather multiplies each point k < n of W by c_k = conj cbar_k
// (zero for k >= n, not loaded), fft_cluster.cuh::cluster_convolve takes
// the L-point FFT, the product with the conjugate filter spectrum in the
// FFT's own order and the unscaled inverse back to natural order, and
// the scratch takes the first n points (the frame's samples) times c_j,
// from the same host tables as kernel A. Pass 2 is the same.
//
// Bound on this card: bytes, as istft_fft.cu: the function reads the
// planes and the mask once and writes the output once; the scratch adds a
// write and a read of the frames (held in L2 when they fit).
#pragma once

#include "fft_cluster.cuh"
#include "planes.cuh"

namespace {

template <bool PAIRED, int ODD, bool CHIRP, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::CLUSTER_THREADS, nrf::cluster_min_blocks(ODD))
    istft_cluster_kernel(const P* __restrict__ re, const P* __restrict__ im,
                         const float* __restrict__ mask, int n_frames, int n_bins, int win,
                         int t_lo, int n_fr, int row_slots, int n_total,
                         const float2* __restrict__ tw1, const float2* __restrict__ tw2,
                         const float2* __restrict__ twn, const float2* __restrict__ tws,
                         const float2* __restrict__ chirp, const float2* __restrict__ filt,
                         float* __restrict__ y, const nrf::Four f) {
  namespace cg = nrf::cg;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float2 smem2[];
  float2* const z0 = smem2;
  float2* const z1 = smem2 + f.buffer;
  const int n = f.pts;  // the transform's points (the FFT's, f.n, off the chirp route)
  const int rank = (int)cl.block_rank();
  const int clusters = gridDim.x / f.c;
  for (int slot = blockIdx.x / f.c; slot < n_total; slot += clusters) {
    const int b = slot / row_slots;
    const int ta = t_lo + (slot - b * row_slots) * FPS;
    const bool has_b = PAIRED && ta + 1 < n_frames;
    const long long row = (long long)b * n_frames * n_bins;
    // Y[k] = Z[k] * mask[k] of frame t, without the imaginary DC or Nyquist part
    auto bin = [&](int t, int k) -> float2 {
      const long long o = row + (long long)t * n_bins + k;
      const float m = __ldg(mask + o);
      const bool real = k == 0 || (!PAIRED && k == n);
      return make_float2(planes::ld(re + o) * m, real ? 0.f : planes::ld(im + o) * m);
    };
    // point j of the slot: W[j] from bin j (or n - j) of both frames
    // (PAIRED), or the unsplit of bins j and n - j
    auto point = [&](int j) -> float2 {
      if constexpr (PAIRED) {
        const int k = j < n_bins ? j : n - j;
        const float2 ya = bin(ta, k);
        const float2 yb = has_b ? bin(ta + 1, k) : make_float2(0.f, 0.f);
        return j < n_bins ? make_float2(ya.x - yb.y, ya.y + yb.x)
                          : make_float2(ya.x + yb.y, yb.x - ya.y);
      } else {
        float2 lo, hi;
        nrf::unsplit(bin(ta, j), bin(ta, j ? n - j : n), __ldg(tws + j), lo, hi);
        return lo;
      }
    };
    // step 1's point j2 of column col: point j = j1 + n1 j2, j1 = rank cols + col
    auto gather = [&](int col, int j2) -> float2 {
      const int j = rank * f.cols + col + f.n1 * j2;
      if constexpr (CHIRP) {  // W_j c_j, zero past n
        return j < n ? nrf::cmul(point(j), nrf::conj(__ldg(chirp + j))) : make_float2(0.f, 0.f);
      } else {
        return point(j);
      }
    };
    const float2* w;
    if constexpr (CHIRP)
      w = nrf::cluster_convolve<true, ODD>(z0, z1, cl, f, rank, gather, filt, tw1, tw2, twn);
    else
      w = nrf::cluster_fft<true, ODD>(z0, z1, cl, f, rank, gather, tw1, tw2, twn);

    // the frame samples of output point k: u = k (PAIRED: frame a's real
    // part, b's imaginary one), or u = 2k and 2k + 1
    float* const ya = y + ((long long)b * n_fr + (ta - t_lo)) * win;
    const bool keep_b = has_b && ta + 1 - t_lo < n_fr;
    auto write = [&](int k, float2 p) {
      if constexpr (PAIRED) {
        if (k < win) {
          ya[k] = p.x;
          if (keep_b) ya[win + k] = p.y;
        }
      } else if (!(win & 1) && 2 * k + 1 < win) {  // rows of even length: an aligned float2
        *reinterpret_cast<float2*>(ya + 2 * k) = p;
      } else {
        if (2 * k < win) ya[2 * k] = p.x;
        if (2 * k + 1 < win) ya[2 * k + 1] = p.y;
      }
    };
    if constexpr (CHIRP) {
      // this block's points k = j1 + n1 j2 with a sample in the frame,
      // consecutive threads on consecutive j1, each times c_k
      const int k_end = PAIRED ? win : (win + 1) / 2;
      const int j2_end = min(f.n2, (k_end + f.n1 - 1) / f.n1);
      for (int e = threadIdx.x; e < f.cols * j2_end; e += nrf::CLUSTER_THREADS) {
        const int j2 = f.dcols.div(e);
        const int col = e - j2 * f.cols;
        const int k = rank * f.cols + col + f.n1 * j2;
        if (k < k_end) write(k, nrf::cmul(w[j2 * f.ldc + col], nrf::conj(__ldg(chirp + k))));
      }
    } else {
      // this block's output points k = k2 + n2 k1, consecutive threads on
      // consecutive k2
      for (int e = threadIdx.x; e < f.rows * f.n1; e += nrf::CLUSTER_THREADS) {
        const int k1 = f.drows.div(e);
        const int r = e - k1 * f.rows;
        write(rank * f.rows + r + f.n2 * k1, w[k1 * f.ldr + r]);
      }
    }
    __syncthreads();  // w's reads are done before the next slot writes it
  }
}

// the build of kernel D's transform pass for an FFT of n points (L on the
// chirp route)
template <bool PAIRED, bool CHIRP, class T>
auto istft_cluster_build(int n) {
  if constexpr (CHIRP)
    return nrf::with_chirp_build(n, [](auto odd) {
      return istft_cluster_kernel<PAIRED, decltype(odd)::value, true, T>;
    });
  else
    return nrf::with_cluster_build(n, [](auto odd) {
      return istft_cluster_kernel<PAIRED, decltype(odd)::value, false, T>;
    });
}

constexpr int OLA_THREADS = 256;

// overlap-add: output sample l of row b (hop block j0 + l / hop)
// takes post[u] y_t[u] of its frames t in [jj - r + 1, jj], ascending,
// then the envelope (the host table where all r frames exist, else summed
// in ascending t) and the trimmed output window
template <class P>
__global__ void istft_cluster_ola_kernel(const float* __restrict__ y, int n_frames, int hop,
                                         int r, int bpad, int j0, int n_out, int win, int t_lo,
                                         int n_fr, long long out_off, long long out_len,
                                         long long istft_len, float env_floor,
                                         const float* __restrict__ post,
                                         const float* __restrict__ wsq,
                                         const float* __restrict__ env_int,
                                         P* __restrict__ out) {
  const int per_row = (n_out * hop + OLA_THREADS - 1) / OLA_THREADS;  // blocks a row
  const int b = blockIdx.x / per_row;
  const int l = (blockIdx.x - b * per_row) * OLA_THREADS + threadIdx.x;
  if (l >= n_out * hop) return;
  const int jb = l / hop;
  const int q = l - jb * hop;
  const int jj = j0 + jb;
  const long long s = (long long)jj * hop + q - bpad;
  const long long o = s - out_off;
  if (o < 0 || o >= out_len) return;
  float v = 0.f;
  if (s < istft_len) {
    float a = 0.f;
    const float* yb = y + (long long)b * n_fr * win;
    for (int t = max(0, jj - r + 1); t <= min(jj, n_frames - 1); ++t) {
      const int u = (jj - t) * hop + q;
      a = fmaf(__ldg(post + u), __ldg(yb + (long long)(t - t_lo) * win + u), a);
    }
    float env;
    if (jj - r + 1 >= 0 && jj < n_frames) {
      env = __ldg(env_int + q);
    } else {
      env = 0.f;  // frames in ascending t, as the table sums them
      for (int i = r - 1; i >= 0; --i) {
        const int t = jj - i;
        if (t >= 0 && t < n_frames) env += __ldg(wsq + i * hop + q);
      }
    }
    v = a / (env > env_floor ? env : 1.f);
  }
  planes::st(out + (long long)b * out_len + o, v);
}

// Launch kernel D's CHIRP builds and its overlap-add pass (the arguments of
// nr_istft_cluster_chirp, istft_cluster_chirp.cu; chirp and filt null off
// the chirp route). Returns the first launch error.
template <bool CHIRP>
int istft_cluster_launch(int plane, const void* re, const void* im, const float* mask,
                         int rows, int n_frames, int n_bins, int n_fft, int hop, int r,
                         int bpad, int j0, int n_out, long long out_off, long long out_len,
                         long long istft_len, float env_floor, const float* post,
                         const float* wsq, const float* env_int, int slot, const float* tw1,
                         const float* tw2, const float* twn, const float* tws,
                         const float* chirp, const float* filt, float* y, int t_lo, int n_fr,
                         void* out, void* stream) {
  nrf::Four f;
  const bool paired = n_fft % 2;
  const int win = r * hop;
  int lo = j0 - r + 1 > 0 ? j0 - r + 1 : 0;
  if (paired) lo &= ~1;
  const int hi = j0 + n_out - 1 < n_frames - 1 ? j0 + n_out - 1 : n_frames - 1;
  if (!nrf::make_four_of<CHIRP>(n_fft, slot, f) || (CHIRP && !(chirp && filt)) ||
      n_bins != n_fft / 2 + 1 || win > n_fft || t_lo != lo ||
      n_fr != (hi >= lo ? hi - lo + 1 : 0))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_out <= 0) return (int)cudaGetLastError();
  const long long samples = (long long)n_out * hop;
  const long long ola_blocks = (long long)rows * ((samples + OLA_THREADS - 1) / OLA_THREADS);
  if (samples > 0x7FFFFFFFLL || ola_blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int row_slots = paired ? (n_fr + 1) / 2 : n_fr;
  const long long total = (long long)rows * row_slots;
  if (total > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (total > 0) {
      const auto go = [&](auto kernel) {
        return nrf::launch_clusters(
            kernel, total, nrf::cluster_smem(f), st, f.c, static_cast<const T*>(re),
            static_cast<const T*>(im), mask, n_frames, n_bins, win, t_lo, n_fr, row_slots,
            (int)total, reinterpret_cast<const float2*>(tw1),
            reinterpret_cast<const float2*>(tw2), reinterpret_cast<const float2*>(twn),
            reinterpret_cast<const float2*>(tws), reinterpret_cast<const float2*>(chirp),
            reinterpret_cast<const float2*>(filt), y, f);
      };
      const int err = paired ? go(istft_cluster_build<true, CHIRP, T>(f.n))
                             : go(istft_cluster_build<false, CHIRP, T>(f.n));
      if (err) return err;
    }
    istft_cluster_ola_kernel<T><<<(unsigned)ola_blocks, OLA_THREADS, 0, st>>>(
        y, n_frames, hop, r, bpad, j0, n_out, win, t_lo, n_fr, out_off, out_len, istft_len,
        env_floor, post, wsq, env_int, static_cast<T*>(out));
    return (int)cudaGetLastError();
  });
}

// Clusters of kernel D's CHIRP transform pass for n_fft and an FFT of slot
// points (plane type `plane`) that the current device holds at once; a
// negative CUDA error code on failure.
template <bool CHIRP>
int istft_cluster_capacity(int plane, int n_fft, int slot) {
  nrf::Four f;
  if (!nrf::make_four_of<CHIRP>(n_fft, slot, f)) return -(int)cudaErrorInvalidValue;
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return n_fft % 2 ? nrf::active_clusters(istft_cluster_build<true, CHIRP, T>(f.n),
                                            nrf::cluster_smem(f), f.c)
                     : nrf::active_clusters(istft_cluster_build<false, CHIRP, T>(f.n),
                                            nrf::cluster_smem(f), f.c);
  });
}

}  // namespace
