// Kernel D, global chirp route: mask apply, inverse FFT, overlap-add,
// envelope division and the output window for an n_fft whose transform's n
// takes no other route past 32,768 points (fft_route.cuh:
// ROUTE_GLOBAL_CHIRP; n_fft 40005, 65538, 144000, 192000, ...), as the
// conjugate of kernel A's chirp-z transform (spectra_global.cu) over
// fft_global.cuh's four-step FFT through device memory.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// (noisereduce_tpu/ops/pallas/geometry.py:146). Before this route such an
// n_fft took a DFT-product route here (since retired), whose tables (6.4 GB
// at 40005) and O(n_fft) work a sample do not scale.
//
// Computes what istft_cluster.cu computes on the cluster chirp route, in
// the same two parts: each frame the output window needs transformed once
// into a float32 frame scratch of (rows, n_fr, win) (frames t_lo to t_lo +
// n_fr - 1, geometry.py::cluster_frames), then istft_cluster.cuh's
// overlap-add pass over it, so the output does not depend on how slots are
// grouped into launches. A slot of n points holds
// - even N: n = N / 2, the point j = unsplit(Y[j], Y[n - j] (Y[n] for j =
//   0)) of Y = Z * mask (no imaginary DC or Nyquist part), whose inverse
//   holds n (y[2m] + i y[2m+1]);
// - odd N (PAIRED): n = N, frames 2s and 2s + 1 (zero past the last),
//   W[k] = Y_a[k] + i Y_b[k], W[n-k] = conj Y_a[k] + i conj Y_b[k];
// y_j = c_j sum_k (W_k c_k) cbar_{j-k}, the circular convolution of length
// L of fft_global.cuh with the conjugate filter. Three launches a group of
// slots and one overlap-add launch:
// 1. istft_global_columns: each point k < n of a tile's columns from its
//    bins k and n - k (contiguous and reverse-contiguous runs of the
//    planes and the mask) times c_k, zero past n (not loaded); pass 1;
// 2. global_rows_kernel<true>: pass 2 with the conjugate filter spectrum;
// 3. istft_global_inverse: pass 3; each point j with a sample in the frame
//    times c_j into the frame scratch, consecutive threads on consecutive
//    samples;
// 4. istft_cluster_ola_kernel (istft_cluster.cuh), once over every frame.
//
// Bound on this card: bytes, as istft_fft.cu: the function reads the
// planes and the mask once and writes the output once; the chirp's two
// L-point transforms, the scratch's three round trips (a group's scratch
// sized to stay in L2) and the frame scratch's write and read are costs of
// this algorithm.
#include "fft_global.cuh"
#include "istft_cluster.cuh"

namespace {

// Pass 1: block (s, tile) of the group's slots [g0, g0 + G)
template <bool PAIRED, int ODD, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::GLOBAL_THREADS, 2)
    istft_global_columns(const P* __restrict__ re, const P* __restrict__ im,
                         const float* __restrict__ mask, int n_frames, int n_bins, int t_lo,
                         int row_slots, int g0, const float2* __restrict__ tw1,
                         const float2* __restrict__ twl, const float2* __restrict__ tws,
                         const float2* __restrict__ chirp, float2* __restrict__ scratch,
                         const nrf::Glob g) {
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  extern __shared__ __align__(16) float2 smem2[];
  const int s = blockIdx.x / g.tiles;
  const int c0 = (blockIdx.x - s * g.tiles) * g.tc;
  const int slot = g0 + s;
  const int b = slot / row_slots;
  const int ta = t_lo + (slot - b * row_slots) * FPS;
  const bool has_b = PAIRED && ta + 1 < n_frames;
  const long long row = (long long)b * n_frames * n_bins;
  const int n = g.n;
  // Y[k] = Z[k] * mask[k] of frame t, without the imaginary DC or Nyquist part
  auto bin = [&](int t, int k) -> float2 {
    const long long o = row + (long long)t * n_bins + k;
    const float m = __ldg(mask + o);
    const bool real = k == 0 || (!PAIRED && k == n);
    return make_float2(planes::ld(re + o) * m, real ? 0.f : planes::ld(im + o) * m);
  };
  auto gather = [&](int col, int j1) -> float2 {
    const int j2 = c0 + col;
    const int j = j2 + g.L2 * j1;
    if (j2 >= g.L2 || j >= n) return make_float2(0.f, 0.f);
    float2 w;
    if constexpr (PAIRED) {
      const int k = j < n_bins ? j : n - j;
      const float2 ya = bin(ta, k);
      const float2 yb = has_b ? bin(ta + 1, k) : make_float2(0.f, 0.f);
      w = j < n_bins ? make_float2(ya.x - yb.y, ya.y + yb.x) : make_float2(ya.x + yb.y, yb.x - ya.y);
    } else {
      float2 hi;
      nrf::unsplit(bin(ta, j), bin(ta, j ? n - j : n), __ldg(tws + j), w, hi);
    }
    return nrf::cmul(w, nrf::conj(__ldg(chirp + j)));
  };
  nrf::global_columns<ODD>(smem2, smem2 + g.buffer, g, c0, gather, tw1, twl,
                           scratch + (long long)s * g.L);
}

// Pass 3: the frame samples of each point j of the convolution times c_j:
// u = j (PAIRED: frame a's real part, b's imaginary one), or u = 2j and
// 2j + 1, into the frame scratch y
template <bool PAIRED, int ODD>
__global__ void __launch_bounds__(nrf::GLOBAL_THREADS, 2)
    istft_global_inverse(int n_frames, int win, int t_lo, int n_fr, int row_slots, int g0,
                         const float2* __restrict__ tw1, const float2* __restrict__ twl,
                         const float2* __restrict__ chirp, const float2* __restrict__ scratch,
                         float* __restrict__ y, const nrf::Glob g) {
  constexpr int FPS = PAIRED ? 2 : 1;
  extern __shared__ __align__(16) float2 smem2[];
  const int s = blockIdx.x / g.tiles;
  const int c0 = (blockIdx.x - s * g.tiles) * g.tc;
  const int slot = g0 + s;
  const int b = slot / row_slots;
  const int ta = t_lo + (slot - b * row_slots) * FPS;
  float* const ya = y + ((long long)b * n_fr + (ta - t_lo)) * win;
  const bool keep_b = PAIRED && ta + 1 < n_frames && ta + 1 - t_lo < n_fr;
  const int k_end = PAIRED ? win : (win + 1) / 2;
  nrf::global_columns_inverse<ODD>(
      smem2, smem2 + g.buffer, g, c0, scratch + (long long)s * g.L, tw1, twl,
      [&](int j, float2 v) {
        if (j >= k_end) return;
        const float2 p = nrf::cmul(v, nrf::conj(__ldg(chirp + j)));
        if constexpr (PAIRED) {
          ya[j] = p.x;
          if (keep_b) ya[win + j] = p.y;
        } else {
          ya[2 * j] = p.x;
          if (2 * j + 1 < win) ya[2 * j + 1] = p.y;
        }
      });
}

}  // namespace

// Masked inverse STFT on the global chirp route: the arguments of
// nr_istft_cluster_chirp (istft_cluster_chirp.cu) with slot the chirp
// length L (its split comes from it), then group: slots a launch of each
// pass takes; tw1, tw2: the stages' tables e^{-2 pi i k / (2 L1)} and (2
// L2); twl: (L1, L2) complex f32, w_L^{j2 k1} at k1 L2 + j2; tws, chirp,
// filt: kernel A's tables (spectra_global.cu), conjugated here; scratch:
// (group, L) complex f32; y: the frame scratch. Returns the first launch
// error.
extern "C" int nr_istft_global(int plane, const void* re, const void* im, const float* mask,
                               int rows, int n_frames, int n_bins, int n_fft, int hop, int r,
                               int bpad, int j0, int n_out, long long out_off, long long out_len,
                               long long istft_len, float env_floor, const float* post,
                               const float* wsq, const float* env_int, int slot, int group,
                               const float* tw1, const float* tw2, const float* twl,
                               const float* tws, const float* chirp, const float* filt,
                               float* scratch, float* y, int t_lo, int n_fr, void* out,
                               void* stream) {
  nrf::Glob g;
  const bool paired = n_fft % 2;
  const int win = r * hop;
  int lo = j0 - r + 1 > 0 ? j0 - r + 1 : 0;
  if (paired) lo &= ~1;
  const int hi = j0 + n_out - 1 < n_frames - 1 ? j0 + n_out - 1 : n_frames - 1;
  if (!nrf::make_glob(n_fft, slot, g) || !(chirp && filt && scratch) || group < 1 ||
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
  const size_t smem = nrf::global_smem(g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w1 = reinterpret_cast<const float2*>(tw1);
  const auto* w2 = reinterpret_cast<const float2*>(tw2);
  const auto* wl = reinterpret_cast<const float2*>(twl);
  const auto* cb = reinterpret_cast<const float2*>(chirp);
  auto* z = reinterpret_cast<float2*>(scratch);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    int err = nrf::with_chirp_build(g.L, [&](auto odd) {
      constexpr int ODD = decltype(odd)::value;
      const auto cols = paired ? istft_global_columns<true, ODD, T>
                               : istft_global_columns<false, ODD, T>;
      const auto inv = paired ? istft_global_inverse<true, ODD> : istft_global_inverse<false, ODD>;
      int e = global_smem_limit(smem, cols, global_rows_kernel<true, ODD>, inv);
      for (long long g0 = 0; !e && g0 < total; g0 += group) {
        const long long G = total - g0 < group ? total - g0 : group;
        e = launch_global(cols, G * g.tiles, smem, st, static_cast<const T*>(re),
                          static_cast<const T*>(im), mask, n_frames, n_bins, t_lo, row_slots,
                          (int)g0, w1, wl, reinterpret_cast<const float2*>(tws), cb, z, g);
        if (!e)
          e = launch_global(global_rows_kernel<true, ODD>, G * g.row_blocks, smem, st, z,
                            reinterpret_cast<const float2*>(filt), w2, g);
        if (!e)
          e = launch_global(inv, G * g.tiles, smem, st, n_frames, win, t_lo, n_fr, row_slots,
                            (int)g0, w1, wl, cb, static_cast<const float2*>(z), y, g);
      }
      return e;
    });
    if (err) return err;
    istft_cluster_ola_kernel<T><<<(unsigned)ola_blocks, OLA_THREADS, 0, st>>>(
        y, n_frames, hop, r, bpad, j0, n_out, win, t_lo, n_fr, out_off, out_len, istft_len,
        env_floor, post, wsq, env_int, static_cast<T*>(out));
    return (int)cudaGetLastError();
  });
}
