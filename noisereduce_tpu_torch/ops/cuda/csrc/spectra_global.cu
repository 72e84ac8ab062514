// Kernel A, global chirp route: spectra of every chunk view for an n_fft
// whose transform's n takes no other route past 32,768 points
// (fft_route.cuh: ROUTE_GLOBAL_CHIRP; n_fft 40005 = 0.83 s frames at 48
// kHz, 65538, 144000, 192000, ...), as a chirp-z transform over
// fft_global.cuh's four-step FFT through device memory.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// as spectra_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// on its matrix unit (noisereduce_tpu/ops/pallas/geometry.py:75). Before
// this route such an n_fft took a DFT-product route here (since retired), whose
// n_fft x n_fft table (6.4 GB at 40005, 147 GB at 192000) and O(n_fft) work
// a bin do not scale; past about n_fft 146,000 the table alone does not fit
// the card.
//
// Computes what spectra_cluster.cu computes on the cluster chirp route,
// into the same time-major planes: a frame slot of n points holds
// - even N: n = N / 2, z[q] = u[2q] + i u[2q+1], unpacked by
//   fft_smem.cuh::split into bins k and (Nyquist) n;
// - odd N (PAIRED): n = N, frames 2s and 2s + 1 (zero past the last),
//   z[j] = u_a[j] + i u_b[j], separated as
//   X_a[k] = (Z[k] + conj Z[n-k]) / 2, X_b[k] = -i (Z[k] - conj Z[n-k]) / 2;
// and Z[k] = cbar_k sum_j (z_j cbar_j) c_{k-j}, c_j = e^{i pi j^2 / n}, the
// circular convolution of length L of fft_global.cuh. Four launches a
// group of slots:
// 1. spectra_global_columns: each point j < n of a tile's columns is the
//    windowed sample pair (or the pair of frames) times cbar_j, zero past
//    n (not loaded), read straight from the signal, consecutive threads on
//    consecutive points; pass 1 into the group's scratch;
// 2. global_rows_kernel<false>: pass 2 with the filter spectrum;
// 3. spectra_global_inverse: pass 3; each point j < n times cbar_j goes
//    back to the scratch at j (the addresses its block read);
// 4. spectra_global_unpack: a thread a bin k of a slot, Z[k] and its
//    partner Z[n - k] from the scratch (contiguous and reverse-contiguous
//    runs), the split or the pair's separation, the planes written once.
// Folding the unpack into pass 3 (a block taking a tile of columns and
// their mirrors (n - j2) mod L2, so that it holds points k and n - k, and
// writing the planes itself: bitwise this output) ran A 1.4-7% slower at
// 40005 on 960 s and on 400,000 samples and at 192000, 3.5% faster at
// 65538 (PERF.md): the pass's bins leave a block in runs of half a tile's
// columns, 4-byte stores 20-32 bytes long, where the unpack's are whole
// warps' runs; wider tiles (one block an SM) were slower still.
// The host builds cbar_j from the exact j^2 mod 2n and the filter FFT_L(c
// wrapped) / L in float64 (kernels.py), and the twiddles w_L^{j2 k1} in the
// columns' layout from the exact product j2 k1 < L, each rounded once to
// float32.
//
// Bound on this card: bytes, as spectra_fft.cu: the function reads the
// signal once and writes the planes once; its FFT is O(log n) a point (the
// chirp's two L-point transforms, about 2.2 n points each, and the
// scratch's three round trips are costs of this algorithm, not of the
// function; a group's scratch is sized to stay in L2).
#include "fft_global.cuh"
#include "planes.cuh"

namespace {

constexpr int UNPACK_THREADS = 256;

// slot of a launch's group: its view, its first frame and whether the
// pair's second frame exists
struct GSlot {
  int b, fa;
  bool has_b;
};

__device__ __forceinline__ GSlot locate(int slot, int n_slots, int n_frames, bool paired) {
  GSlot sl;
  sl.b = slot / n_slots;
  sl.fa = paired ? 2 * (slot - sl.b * n_slots) : slot - sl.b * n_slots;
  sl.has_b = paired && sl.fa + 1 < n_frames;
  return sl;
}

// Pass 1: block (s, tile) of the group's slots [g0, g0 + G)
template <bool PAIRED, int ODD, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::GLOBAL_THREADS, 2)
    spectra_global_columns(const P* __restrict__ x, long long n_src, int n_chunks,
                           long long chunk_stride, long long view_start, int view_len,
                           int n_frames, int hop, int bpad, int win, int n_slots, int g0,
                           const float* __restrict__ ws, const float2* __restrict__ tw1,
                           const float2* __restrict__ twl, const float2* __restrict__ chirp,
                           float2* __restrict__ scratch, const nrf::Glob g) {
  extern __shared__ __align__(16) float2 smem2[];
  const int s = blockIdx.x / g.tiles;
  const int c0 = (blockIdx.x - s * g.tiles) * g.tc;
  const GSlot sl = locate(g0 + s, n_slots, n_frames, PAIRED);
  const int h = sl.b / n_chunks;
  const long long s0 = (sl.b - h * n_chunks) * chunk_stride + view_start;
  const P* const xr = x + (long long)h * n_src;
  // windowed sample u of frame t of the view, zero outside it and the signal
  auto sample = [&](int t, int u) -> float {
    if (u >= win) return 0.f;
    const long long p = (long long)t * hop + u - bpad;  // view position
    const long long q = s0 + p;
    return p >= 0 && p < view_len && q >= 0 && q < n_src ? __ldg(ws + u) * planes::ld(xr + q)
                                                         : 0.f;
  };
  auto gather = [&](int col, int j1) -> float2 {
    const int j2 = c0 + col;
    const int j = j2 + g.L2 * j1;
    if (j2 >= g.L2 || j >= g.n) return make_float2(0.f, 0.f);
    const float2 z = PAIRED ? make_float2(sample(sl.fa, j), sl.has_b ? sample(sl.fa + 1, j) : 0.f)
                            : make_float2(sample(sl.fa, 2 * j), sample(sl.fa, 2 * j + 1));
    return nrf::cmul(z, __ldg(chirp + j));
  };
  nrf::global_columns<ODD>(smem2, smem2 + g.buffer, g, c0, gather, tw1, twl,
                           scratch + (long long)s * g.L);
}

// Pass 3: the convolution's points j < n times cbar_j, in place
template <int ODD>
__global__ void __launch_bounds__(nrf::GLOBAL_THREADS, 2)
    spectra_global_inverse(const float2* __restrict__ tw1, const float2* __restrict__ twl,
                           const float2* __restrict__ chirp, float2* scratch,
                           const nrf::Glob g) {
  extern __shared__ __align__(16) float2 smem2[];
  const int s = blockIdx.x / g.tiles;
  const int c0 = (blockIdx.x - s * g.tiles) * g.tc;
  float2* const z = scratch + (long long)s * g.L;
  nrf::global_columns_inverse<ODD>(smem2, smem2 + g.buffer, g, c0, z, tw1, twl,
                                   [&](int j, float2 v) {
                                     if (j < g.n) z[j] = nrf::cmul(v, __ldg(chirp + j));
                                   });
}

// Pass 4: bin k (and the Nyquist bin n from k = 0), or bin k of both
// frames (PAIRED), from the transform's points k and n - k
template <bool PAIRED, class P>
__global__ void __launch_bounds__(UNPACK_THREADS)
    spectra_global_unpack(const float2* __restrict__ scratch, int n_slots, int n_frames,
                          int n_bins, int g0, int chunks, const float2* __restrict__ tws,
                          P* __restrict__ re, P* __restrict__ im, const nrf::Glob g) {
  const int s = blockIdx.x / chunks;
  const int k = (blockIdx.x - s * chunks) * UNPACK_THREADS + threadIdx.x;
  if (k >= (PAIRED ? n_bins : g.n)) return;
  const GSlot sl = locate(g0 + s, n_slots, n_frames, PAIRED);
  const float2* const z = scratch + (long long)s * g.L;
  const float2 zk = z[k], zm = z[k ? g.n - k : 0];
  const long long row = ((long long)sl.b * n_frames + sl.fa) * n_bins;
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
      planes::st(re + row + g.n, hi.x);
      planes::st(im + row + g.n, hi.y);
    }
  }
}

}  // namespace

// Windowed frame spectra of every view on the global chirp route: the
// arguments of nr_spectra_cluster_chirp (spectra_cluster_chirp.cu) with
// slot the chirp length L (fft_route.cuh::chirp_length_ok; its split comes
// from it), then group: slots a launch of each pass takes; tw1, tw2: the
// stages' tables e^{-2 pi i k / (2 L1)} and (2 L2); twl: (L1, L2) complex
// f32, w_L^{j2 k1} at k1 L2 + j2; tws: the split's table of n_fft points;
// chirp: (n,) cbar_j; filt: the filter spectrum in the row pass's order
// (global_rows_kernel); scratch: (group, L) complex f32. Returns the
// first launch error.
extern "C" int nr_spectra_global(int plane, const void* x, long long n_src, int rows,
                                 int n_chunks, long long chunk_stride, long long view_start,
                                 int view_len, int n_frames, int hop, int bpad, int win,
                                 int n_fft, int n_bins, int slot, int group, const float* ws,
                                 const float* tw1, const float* tw2, const float* twl,
                                 const float* tws, const float* chirp, const float* filt,
                                 float* scratch, void* re, void* im, void* stream) {
  nrf::Glob g;
  const bool paired = n_fft % 2;
  if (!nrf::make_glob(n_fft, slot, g) || n_bins != n_fft / 2 + 1 || group < 1 ||
      !(chirp && filt && scratch))
    return (int)cudaErrorInvalidValue;
  const int B = rows * n_chunks;
  if (B <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_slots = paired ? (n_frames + 1) / 2 : n_frames;
  const long long total = (long long)B * n_slots;
  if (total > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int chunks = ((paired ? n_bins : g.n) + UNPACK_THREADS - 1) / UNPACK_THREADS;
  const size_t smem = nrf::global_smem(g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w1 = reinterpret_cast<const float2*>(tw1);
  const auto* w2 = reinterpret_cast<const float2*>(tw2);
  const auto* wl = reinterpret_cast<const float2*>(twl);
  const auto* cb = reinterpret_cast<const float2*>(chirp);
  auto* z = reinterpret_cast<float2*>(scratch);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return nrf::with_chirp_build(g.L, [&](auto odd) {
      constexpr int ODD = decltype(odd)::value;
      const auto cols = paired ? spectra_global_columns<true, ODD, T>
                               : spectra_global_columns<false, ODD, T>;
      const auto unpack = paired ? spectra_global_unpack<true, T> : spectra_global_unpack<false, T>;
      int err = global_smem_limit(smem, cols, global_rows_kernel<false, ODD>,
                                  spectra_global_inverse<ODD>);
      for (long long g0 = 0; !err && g0 < total; g0 += group) {
        const long long G = total - g0 < group ? total - g0 : group;
        err = launch_global(cols, G * g.tiles, smem, st, static_cast<const T*>(x), n_src,
                            n_chunks, chunk_stride, view_start, view_len, n_frames, hop, bpad,
                            win, n_slots, (int)g0, ws, w1, wl, cb, z, g);
        if (!err)
          err = launch_global(global_rows_kernel<false, ODD>, G * g.row_blocks, smem, st, z,
                              reinterpret_cast<const float2*>(filt), w2, g);
        if (!err)
          err = launch_global(spectra_global_inverse<ODD>, G * g.tiles, smem, st, w1, wl, cb, z,
                              g);
        if (!err) {
          if (G * chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
          unpack<<<(unsigned)(G * chunks), UNPACK_THREADS, 0, st>>>(
              z, n_slots, n_frames, n_bins, (int)g0, chunks,
              reinterpret_cast<const float2*>(tws), static_cast<T*>(re), static_cast<T*>(im), g);
          err = (int)cudaGetLastError();
        }
      }
      return err;
    });
  });
}
