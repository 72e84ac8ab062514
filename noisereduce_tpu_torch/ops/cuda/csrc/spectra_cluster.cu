// Kernel A, cluster route: spectra of every chunk view for an n_fft whose
// transform's n has no prime factor above 13 and is past a big block
// (fft_route.cuh: n_fft 16386 to 131072, e.g. 40000 at 48 kHz).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// as spectra_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// on its matrix unit (noisereduce_tpu/ops/pallas/geometry.py:75). Before
// this route such an n_fft took the product route here, whose n_fft x
// n_fft tables and O(n_fft) work a bin do not scale.
//
// Computes what spectra_cplx.cu computes on the FFT route, into the same
// time-major planes: a frame slot of n points holds
// - even N: n = N / 2, z[q] = u[2q] + i u[2q+1], unpacked by
//   fft_smem.cuh::split into bins k and (Nyquist) n;
// - odd N (PAIRED): n = N, frames 2s and 2s + 1 (zero past the last),
//   z[j] = u_a[j] + i u_b[j], separated as
//   X_a[k] = (Z[k] + conj Z[n-k]) / 2, X_b[k] = -i (Z[k] - conj Z[n-k]) / 2.
// One cluster of c blocks a slot (fft_cluster.cuh's four-step FFT): each
// block gathers its columns' windowed samples straight from the signal
// (L2 holds a frame; no staging of the window or the span, which at these
// sizes would not fit), takes its part of the transform, and unpacks the
// bins k whose k mod n2 its rows hold, the partner n - k read from the
// block that holds it.
//
// Bound on this card: bytes, as spectra_fft.cu: the function reads the
// signal once and writes the planes once; its FFT is O(log n) a point.
// Design: a simple kernel first (the route's times are in PERF.md): one
// slot a cluster, three cluster barriers a slot, the exchange and the
// partner reads through distributed shared memory one float2 at a time.
#include "fft_cluster.cuh"
#include "planes.cuh"

namespace {

template <bool PAIRED, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::Cluster::THREADS, 1)
    spectra_cluster_kernel(const P* __restrict__ x, long long n_src, int n_chunks,
                           long long chunk_stride, long long view_start, int view_len,
                           int n_frames, int hop, int bpad, int win, int n_bins, int n_slots,
                           const float* __restrict__ ws, const float2* __restrict__ tw1,
                           const float2* __restrict__ tw2, const float2* __restrict__ twn,
                           const float2* __restrict__ tws, P* __restrict__ re,
                           P* __restrict__ im, const nrf::Four f) {
  namespace cg = nrf::cg;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float2 smem2[];
  float2* z = smem2;
  float2* w = smem2 + f.buffer;
  const int rank = (int)cl.block_rank();
  const int slot = blockIdx.x / f.c;
  const int b = slot / n_slots;
  const int s = slot - b * n_slots;
  const int h = b / n_chunks;
  const int c = b - h * n_chunks;
  const int fa = PAIRED ? 2 * s : s;  // the slot's (first) frame
  const bool has_b = PAIRED && fa + 1 < n_frames;
  const P* xr = x + (long long)h * n_src;
  const long long s0 = c * chunk_stride + view_start;

  // windowed sample u of frame t of the view, zero outside it and the signal
  auto sample = [&](int t, int u) -> float {
    if (u >= win) return 0.f;
    const long long p = (long long)t * hop + u - bpad;  // view position
    const long long q = s0 + p;
    return (p >= 0 && p < view_len && q >= 0 && q < n_src) ? __ldg(ws + u) * planes::ld(xr + q)
                                                          : 0.f;
  };

  // step 1's input: column j1 = rank cols + col, point j = j1 + n1 j2
  for (int e = threadIdx.x; e < f.cols * f.n2; e += nrf::Cluster::THREADS) {
    const int col = f.dn2.div(e);
    const int j2 = e - col * f.n2;
    const int j = rank * f.cols + col + f.n1 * j2;
    float2 v;
    if constexpr (PAIRED)
      v = make_float2(sample(fa, j), has_b ? sample(fa + 1, j) : 0.f);
    else
      v = make_float2(sample(fa, 2 * j), sample(fa, 2 * j + 1));
    z[nrf::pad(e)] = v;
  }
  __syncthreads();
  nrf::cluster_fft<false>(z, w, cl, f, rank, tw1, tw2, twn);

  // unpack the bins k = k2 + n2 k1 whose k2 this block's rows hold,
  // consecutive threads on consecutive k2
  const long long row = ((long long)b * n_frames + fa) * n_bins;
  for (int e = threadIdx.x; e < f.rows * f.n1; e += nrf::Cluster::THREADS) {
    const int k1 = f.drows.div(e);
    const int r = e - k1 * f.rows;
    const int k = rank * f.rows + r + f.n2 * k1;
    if (PAIRED && k >= n_bins) continue;
    const float2 zk = w[nrf::pad(r * f.n1 + k1)];
    const float2 zm = nrf::cluster_point(w, cl, f, k ? f.n - k : 0);
    if constexpr (PAIRED) {
      planes::st(re + row + k, 0.5f * (zk.x + zm.x));
      planes::st(im + row + k, 0.5f * (zk.y - zm.y));
      if (has_b) {
        planes::st(re + row + n_bins + k, 0.5f * (zk.y + zm.y));
        planes::st(im + row + n_bins + k, 0.5f * (zm.x - zk.x));
      }
    } else {
      float2 lo, hi;
      nrf::split(zk, zm, __ldg(tws + k), lo, hi);
      planes::st(re + row + k, lo.x);
      planes::st(im + row + k, lo.y);
      if (k == 0) {  // the Nyquist bin n
        planes::st(re + row + f.n, hi.x);
        planes::st(im + row + f.n, hi.y);
      }
    }
  }
  cl.sync();  // the cluster's partner reads of this block's w are done
}

}  // namespace

// plane: the type of x, re and im (planes.cuh: 0 float32, 1 bfloat16); x:
// (rows, n_src); ws: (win,) f32; tw1, tw2: (2 n1,), (2 n2,) complex f32,
// the stages' tables of the n1- and n2-point FFTs; twn: (n,) complex f32,
// e^{-2 pi i k / n}; tws: (n_fft,) complex f32, the split's (even n_fft);
// re/im: (rows*n_chunks, n_frames, n_bins). The cluster shape comes from
// n_fft (fft_route.cuh::cluster_shape). Returns the launch's error code.
extern "C" int nr_spectra_cluster(int plane, const void* x, long long n_src, int rows,
                                  int n_chunks, long long chunk_stride, long long view_start,
                                  int view_len, int n_frames, int hop, int bpad, int win,
                                  int n_fft, int n_bins, const float* ws, const float* tw1,
                                  const float* tw2, const float* twn, const float* tws,
                                  void* re, void* im, void* stream) {
  nrf::Four f;
  const bool paired = n_fft % 2;
  if (nrf::route_of(n_fft) != nrf::ROUTE_CLUSTER || !nrf::make_four(nrf::fft_n(n_fft), f) ||
      n_bins != n_fft / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const int B = rows * n_chunks;
  if (B <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_slots = paired ? (n_frames + 1) / 2 : n_frames;
  const long long grid = (long long)B * n_slots * f.c;
  const size_t smem = sizeof(float2) * 2 * (size_t)f.buffer;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const auto run = [&](auto kernel) {
      return nrf::launch_clusters(
          kernel, grid, smem, st, f.c, static_cast<const T*>(x), n_src, n_chunks, chunk_stride,
          view_start, view_len, n_frames, hop, bpad, win, n_bins, n_slots, ws,
          reinterpret_cast<const float2*>(tw1), reinterpret_cast<const float2*>(tw2),
          reinterpret_cast<const float2*>(twn), reinterpret_cast<const float2*>(tws),
          static_cast<T*>(re), static_cast<T*>(im), f);
    };
    return paired ? run(spectra_cluster_kernel<true, T>) : run(spectra_cluster_kernel<false, T>);
  });
}
