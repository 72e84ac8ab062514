// Kernel D, cluster route: mask apply, inverse FFT, overlap-add, envelope
// division and the output window for an n_fft whose transform's n has no
// prime factor above 13 and is past a big block (fft_route.cuh: n_fft
// 16386 to 131072, e.g. 40000 at 48 kHz).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// (noisereduce_tpu/ops/pallas/geometry.py:146). Before this route such an
// n_fft took the product route here, whose n_fft x hop tables per frame
// shift and O(n_fft) work a sample do not scale.
//
// Computes what istft_cplx.cu computes on the FFT route, with the same
// runs of output hop blocks, frames in ascending order, envelope and trim:
// a frame slot of n points holds
// - even N: n = N / 2, the point j = unsplit(Y[j], Y[n - j] (Y[n] for
//   j = 0)) of Y = Z * mask (no imaginary DC or Nyquist part), whose
//   inverse holds n (y[2m] + i y[2m+1]);
// - odd N (PAIRED): n = N, frames 2s and 2s + 1 (zero past the last),
//   W[k] = Y_a[k] + i Y_b[k], W[n-k] = conj Y_a[k] + i conj Y_b[k]
//   (k < (n + 1) / 2), whose inverse holds n (y_a + i y_b).
// One cluster of c blocks a run of output hop blocks of one row: for each
// slot of the run's frames, each block gathers its columns' points
// straight from the planes (each point from its own bins, so no block
// waits for another's), the cluster takes the slot's inverse transform
// (fft_cluster.cuh), and each block adds the samples it owns of the run,
// a contiguous c-th of it, from the block that holds each frame sample
// (cluster_point). post carries 1/n.
//
// Bound on this card: bytes, as istft_fft.cu: the function reads the
// planes and the mask once and writes the output once. Design: a simple
// kernel first (the route's times are in PERF.md): a run takes r - 1
// frames besides its own (frames recomputed r - 1 times in r + run - 1
// at the runs' edges, as the other routes do), one slot at a time, two
// cluster barriers a slot.
#include "fft_cluster.cuh"
#include "planes.cuh"

namespace {

template <bool PAIRED, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::Cluster::THREADS, 1)
    istft_cluster_kernel(const P* __restrict__ re, const P* __restrict__ im,
                         const float* __restrict__ mask, int n_frames, int n_bins, int hop,
                         int r, int bpad, int j0, int n_out, int run, int n_runs,
                         long long out_off, long long out_len, long long istft_len,
                         float env_floor, const float* __restrict__ post,
                         const float* __restrict__ wsq, const float* __restrict__ env_int,
                         const float2* __restrict__ tw1, const float2* __restrict__ tw2,
                         const float2* __restrict__ twn, const float2* __restrict__ tws,
                         P* __restrict__ out, const nrf::Four f) {
  namespace cg = nrf::cg;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float2 smem2[];
  float2* z = smem2;
  float2* w = smem2 + f.buffer;
  float* acc = reinterpret_cast<float*>(smem2 + 2 * f.buffer);
  const int n = f.n;
  const int rank = (int)cl.block_rank();
  const int cid = blockIdx.x / f.c;
  const int b = cid / n_runs;
  const int ja = j0 + (cid - b * n_runs) * run;
  const int je = min(run, j0 + n_out - ja);
  const int n_acc = je * hop;
  // this block's samples of the run: [l0, l1)
  const int share = (n_acc + f.c - 1) / f.c;
  const int l0 = min(n_acc, rank * share);
  const int l1 = min(n_acc, l0 + share);
  for (int l = l0 + threadIdx.x; l < l1; l += nrf::Cluster::THREADS) acc[l - l0] = 0.f;

  const long long row = (long long)b * n_frames * n_bins;
  // Y[k] = Z[k] * mask[k] of frame t, without the imaginary DC or Nyquist part
  auto bin = [&](int t, int k) -> float2 {
    const long long o = row + (long long)t * n_bins + k;
    const float m = __ldg(mask + o);
    const bool real = k == 0 || (!PAIRED && k == n);
    return make_float2(planes::ld(re + o) * m, real ? 0.f : planes::ld(im + o) * m);
  };

  const int t_lo = max(0, ja - r + 1) & (PAIRED ? ~1 : ~0);  // even when PAIRED
  const int t_hi = min(n_frames - 1, ja + je - 1);
  for (int ta = t_lo; ta <= t_hi; ta += FPS) {
    const bool has_b = PAIRED && ta + 1 < n_frames;
    // step 1's input: column j1 = rank cols + col, point j = j1 + n1 j2
    for (int e = threadIdx.x; e < f.cols * f.n2; e += nrf::Cluster::THREADS) {
      const int col = f.dn2.div(e);
      const int j2 = e - col * f.n2;
      const int j = rank * f.cols + col + f.n1 * j2;
      float2 v;
      if constexpr (PAIRED) {
        const int k = j < n_bins ? j : n - j;
        const float2 ya = bin(ta, k);
        const float2 yb = has_b ? bin(ta + 1, k) : make_float2(0.f, 0.f);
        v = j < n_bins ? make_float2(ya.x - yb.y, ya.y + yb.x)
                       : make_float2(ya.x + yb.y, yb.x - ya.y);
      } else {
        float2 lo, hi;
        nrf::unsplit(bin(ta, j), bin(ta, j ? n - j : n), __ldg(tws + j), lo, hi);
        v = lo;
      }
      z[nrf::pad(e)] = v;
    }
    __syncthreads();
    nrf::cluster_fft<true>(z, w, cl, f, rank, tw1, tw2, twn);

    // overlap-add: sample l (hop block ja + l / hop) takes the frames of
    // this slot among [jj - r + 1, jj], ascending
    for (int l = l0 + threadIdx.x; l < l1; l += nrf::Cluster::THREADS) {
      const int jb = l / hop;
      const int q = l - jb * hop;
      const int jj = ja + jb;
      float a = acc[l - l0];
      for (int t = max(ta, jj - r + 1); t <= min(ta + FPS - 1, jj); ++t) {
        if (t >= n_frames) break;
        const int u = (jj - t) * hop + q;
        float y;
        if constexpr (PAIRED) {
          const float2 p = nrf::cluster_point(w, cl, f, u);
          y = t == ta ? p.x : p.y;
        } else {
          const float2 p = nrf::cluster_point(w, cl, f, u >> 1);
          y = (u & 1) ? p.y : p.x;
        }
        a = fmaf(__ldg(post + u), y, a);
      }
      acc[l - l0] = a;
    }
    cl.sync();  // every block's reads of the others' w are done
  }

  // envelope division and the trimmed output window
  for (int l = l0 + threadIdx.x; l < l1; l += nrf::Cluster::THREADS) {
    const int jb = l / hop;
    const int q = l - jb * hop;
    const int jj = ja + jb;
    const long long s = (long long)jj * hop + q - bpad;
    const long long o = s - out_off;
    if (o < 0 || o >= out_len) continue;
    float y = 0.f;
    if (s < istft_len) {
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
      y = acc[l - l0] / (env > env_floor ? env : 1.f);
    }
    planes::st(out + (long long)b * out_len + o, y);
  }
}

}  // namespace

// plane: the type of re, im and out (planes.cuh: 0 float32, 1 bfloat16);
// re/im: (rows, n_frames, n_bins); mask: the same, f32; post, wsq: (r *
// hop,) f32; env_int: (hop,) f32; tw1, tw2: (2 n1,), (2 n2,) complex f32,
// the stages' tables; twn: (n,) complex f32, e^{-2 pi i k / n}; tws:
// (n_fft,) complex f32, the unsplit's (even n_fft); out: (rows, out_len).
// run: output hop blocks of one cluster, run * hop at most c * 8192 (a
// run of one hop block any hop whose c-th fits beside the buffers). The
// cluster shape comes from n_fft (fft_route.cuh::cluster_shape). Returns
// the launch's error code.
extern "C" int nr_istft_cluster(int plane, const void* re, const void* im, const float* mask,
                                int rows, int n_frames, int n_bins, int n_fft, int hop, int r,
                                int bpad, int j0, int n_out, int run, long long out_off,
                                long long out_len, long long istft_len, float env_floor,
                                const float* post, const float* wsq, const float* env_int,
                                const float* tw1, const float* tw2, const float* twn,
                                const float* tws, void* out, void* stream) {
  nrf::Four f;
  const bool paired = n_fft % 2;
  if (nrf::route_of(n_fft) != nrf::ROUTE_CLUSTER || !nrf::make_four(nrf::fft_n(n_fft), f) ||
      n_bins != n_fft / 2 + 1 || run < 1 ||
      (run > 1 && (long long)run * hop > (long long)f.c * nrf::BIG_SLOTS))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_out <= 0) return (int)cudaGetLastError();
  const int n_runs = (n_out + run - 1) / run;
  const long long grid = (long long)rows * n_runs * f.c;
  const int share = (run * hop + f.c - 1) / f.c;
  const size_t smem = sizeof(float2) * 2 * (size_t)f.buffer + sizeof(float) * (size_t)share;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const auto go = [&](auto kernel) {
      return nrf::launch_clusters(
          kernel, grid, smem, st, f.c, static_cast<const T*>(re), static_cast<const T*>(im),
          mask, n_frames, n_bins, hop, r, bpad, j0, n_out, run, n_runs, out_off, out_len,
          istft_len, env_floor, post, wsq, env_int, reinterpret_cast<const float2*>(tw1),
          reinterpret_cast<const float2*>(tw2), reinterpret_cast<const float2*>(twn),
          reinterpret_cast<const float2*>(tws), static_cast<T*>(out), f);
    };
    return paired ? go(istft_cluster_kernel<true, T>) : go(istft_cluster_kernel<false, T>);
  });
}
