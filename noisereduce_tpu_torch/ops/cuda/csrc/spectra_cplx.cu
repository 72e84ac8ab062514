// Kernel A, complex-frame kernels: spectra of every chunk view for the
// n_fft of the FFT route that spectra_fft.cu does not serve (M with a
// factor 11 or 13, and every odd n_fft whose prime factors are at most 13)
// and for the chirp-z route (fft_route.cuh).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// as spectra_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// on its matrix unit (noisereduce_tpu/ops/pallas/geometry.py:75).
//
// Computes what spectra_fft.cu computes, Z[b, t, k] = s * sum_n w[n]
// x_c[t*hop + n - bpad] e^{-2 pi i k n / N}, into the same time-major
// planes, from the same tiles of frames and signal spans. A frame slot of
// T points holds one transform of n complex points:
// - even N: n = M = N/2, the frame packed as z[q] = u[2q] + i u[2q+1] and
//   unpacked by fft_smem.cuh::split, as spectra_fft.cu does;
// - odd N (PAIRED): n = N, two frames a slot, z[j] = u_a[j] + i u_b[j]
//   (a zero frame b past the tile's last), separated as
//   X_a[k] = (Z[k] + conj Z[N-k]) / 2,  X_b[k] = -i (Z[k] - conj Z[N-k]) / 2,
//   (N + 1) / 2 bins each, no Nyquist bin.
// On the FFT route T = n and the slot takes fft_smem.cuh's n-point FFT. On
// the chirp route (CHIRP; n with a prime factor above 13) T = L >= 2n - 1
// and
//   Z[k] = cbar_k sum_j (z_j cbar_j) c_{k-j},  c_j = e^{i pi j^2 / n},
// a circular convolution of length L: the slot's first n points times
// cbar_j (zero past n), the L-point FFT, times the filter spectrum
// filt = FFT_L(c wrapped) / L, the unscaled inverse, and cbar_k times the
// first n points as the unpack reads them. The host builds cbar_j =
// e^{-i pi (j^2 mod 2n) / n}, j < n, from the exact integer j^2 mod 2n in
// float64 (a float phase of j^2 < 2^26 loses its low bits), and filt in
// float64 once per (n, L); both rounded once to float32.
//
// Bound on this card: bytes, as spectra_fft.cu (the function's FFT of
// length N; the chirp's three passes over L points are extra operations of
// this algorithm, not of the function). Design: as spectra_fft.cu, one
// block per tile of frames of one view, its threads in segments that each
// own whole slots; a slot past 4096 points takes a big block of 1024
// threads and 8192 points (fft_smem.cuh::Blk), one slot a block. Every
// build of 512 threads takes 64 registers (2 blocks an SM; PERF.md).
#include "fft_smem.cuh"

namespace {

template <int ODD, bool PAIRED, bool CHIRP, bool BIG>
__global__ void __launch_bounds__(nrf::Blk<BIG>::THREADS, BIG ? 1 : 2)
    spectra_cplx_kernel(const float* __restrict__ x, long long n_src, int n_chunks,
                        long long chunk_stride, long long view_start, int view_len,
                        int n_frames, int hop, int bpad, int win, int n, int n_bins,
                        int tile_frames, int n_tiles, const float* __restrict__ ws,
                        const float2* __restrict__ tw, const float2* __restrict__ tws,
                        const float2* __restrict__ chirp, const float2* __restrict__ filt,
                        float* __restrict__ re, float* __restrict__ im,
                        const nrf::Plan<ODD != 1> plan, const nrf::Div<true> dh) {
  using B = nrf::Blk<BIG>;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  extern __shared__ __align__(16) float2 smem2[];
  const int T = plan.m.d;  // points a slot: n, or the chirp length
  float2* z = smem2;
  float* wsm = reinterpret_cast<float*>(smem2 + B::PADDED);  // ws, win values
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
  const float* xr = x + (long long)h * n_src;
  for (int i = tid; i < win; i += B::THREADS) wsm[i] = __ldg(ws + i);
  for (int i = tid; i < span_len; i += B::THREADS) {
    const long long p = p0 + i;
    const long long s = s0 + i;
    span[i] = (p >= 0 && p < view_len && s >= 0 && s < n_src) ? __ldg(xr + s) : 0.f;
  }
  __syncthreads();

  // each segment of threads packs, transforms and unpacks its own slots
  const nrf::Seg sg = nrf::segment(plan);
  const int n_slots = (fe + FPS - 1) / FPS;
  const int nf = nrf::seg_frames(sg, plan, n_slots);
  const int first = sg.f0 * T;  // the segment's first point

  // the slots: the frames' n points (times cbar_j), zero past n
  for (int e = sg.lane; e < nf * T; e += plan.threads) {
    const int sl = plan.m.div(e);
    const int q = e - sl * T;
    float2 v = make_float2(0.f, 0.f);
    if (q < n) {
      if constexpr (PAIRED) {  // z[j] = u_a[j] + i u_b[j]
        const int fa = FPS * (sg.f0 + sl);
        if (q < win) {
          const float w = wsm[q];
          v.x = w * span[fa * hop + q];
          if (fa + 1 < fe) v.y = w * span[(fa + 1) * hop + q];
        }
      } else {  // z[q] = u[2q] + i u[2q+1]
        const int u = 2 * q;
        const float* sp = span + (sg.f0 + sl) * hop + u;
        v = make_float2(u < win ? wsm[u] * sp[0] : 0.f, u + 1 < win ? wsm[u + 1] * sp[1] : 0.f);
      }
      if constexpr (CHIRP) v = nrf::cmul(v, __ldg(chirp + q));
    }
    z[nrf::pad(first + e)] = v;
  }
  nrf::seg_sync(sg, plan);

  if constexpr (CHIRP) {  // the convolution with c
    nrf::fft_frames<false, ODD>(z, T, n_slots, tw, sg, plan);
    for (int e = sg.lane; e < nf * T; e += plan.threads) {
      const int l = nrf::pad(first + e);
      z[l] = nrf::cmul(z[l], __ldg(filt + (e - plan.m.div(e) * T)));
    }
    nrf::seg_sync(sg, plan);
    nrf::fft_frames<true, ODD>(z, T, n_slots, tw, sg, plan);
  } else {
    nrf::fft_frames<false, ODD>(z, T, n_slots, tw, sg, plan);
  }

  // unpack into the tile's contiguous rows: slot point pair (k, n - k)
  // (k = 0 with itself) gives bin k of both frames (PAIRED), or bins k and
  // n - k, and for an even n n/2 with k = 0 (split)
  const int half = dh.d;  // pairs a slot: (n + 1) / 2
  const long long o0 = ((long long)b * n_frames + t0 + FPS * sg.f0) * n_bins;
  for (int e = sg.lane; e < nf * half; e += plan.threads) {
    const int sl = dh.div(e);
    const int k = e - sl * half;
    const int km = k ? n - k : 0;
    const int base = first + sl * T;
    const long long row = o0 + (long long)FPS * sl * n_bins;
    float2 zk = z[nrf::pad(base + k)], zm = z[nrf::pad(base + km)];
    if constexpr (CHIRP) {
      zk = nrf::cmul(zk, __ldg(chirp + k));
      zm = nrf::cmul(zm, __ldg(chirp + km));
    }
    if constexpr (PAIRED) {
      re[row + k] = 0.5f * (zk.x + zm.x);
      im[row + k] = 0.5f * (zk.y - zm.y);
      if (FPS * (sg.f0 + sl) + 1 < fe) {
        re[row + n_bins + k] = 0.5f * (zk.y + zm.y);
        im[row + n_bins + k] = 0.5f * (zm.x - zk.x);
      }
    } else {
      float2 lo, hi;
      nrf::split(zk, zm, __ldg(tws + k), lo, hi);
      re[row + k] = lo.x;
      im[row + k] = lo.y;
      re[row + n - k] = hi.x;
      im[row + n - k] = hi.y;
      if (k == 0 && !(n & 1)) {
        float2 zh = z[nrf::pad(base + n / 2)];
        if constexpr (CHIRP) zh = nrf::cmul(zh, __ldg(chirp + n / 2));
        nrf::split(zh, zh, __ldg(tws + n / 2), lo, hi);
        re[row + n / 2] = lo.x;
        im[row + n / 2] = lo.y;
      }
    }
  }
}

}  // namespace

// x: (rows, n_src) f32; ws: (win,) f32; tw: (2 slot,) complex f32, the
// core's table for slot points; tws: (n_fft,) complex f32, the split's
// (even n_fft); chirp: (n,) complex f32 and filt: (slot,) complex f32 on
// the chirp route, else null; re/im: (rows*n_chunks, n_frames, n_bins)
// f32. slot: fft_n(n_fft) on the FFT route, the chirp length on the chirp
// route (fft_smem.cuh::cplx_slot_ok); seg_warps a segment of warps that
// holds a slot, tile_frames at most the frames of the block's slots.
// Returns cudaGetLastError() after the launch.
extern "C" int nr_spectra_cplx(const float* x, long long n_src, int rows,
                               int n_chunks, long long chunk_stride,
                               long long view_start, int view_len,
                               int n_frames, int hop, int bpad, int win,
                               int n_fft, int n_bins, int slot, int seg_warps,
                               int tile_frames, const float* ws, const float* tw,
                               const float* tws, const float* chirp, const float* filt,
                               float* re, float* im, void* stream) {
  const int n = nrf::fft_n(n_fft);
  const bool paired = n_fft % 2, big = slot > nrf::ELEMS;
  const int block_warps = big ? nrf::Blk<true>::WARPS : nrf::WARPS;
  if (!nrf::cplx_slot_ok(n_fft, slot) || (slot != n && (!chirp || !filt)) ||
      tile_frames < 1 ||
      tile_frames > (paired ? 2 : 1) * nrf::fft_block_frames(seg_warps, slot, block_warps))
    return (int)cudaErrorInvalidValue;
  const int B = rows * n_chunks;
  if (B <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_tiles = (n_frames + tile_frames - 1) / tile_frames;
  const unsigned grid = (unsigned)((long long)B * n_tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nrf::with_cplx_build(n_fft, slot, [&](auto odd, auto pr, auto ch, auto bg) {
    constexpr int ODD = decltype(odd)::value;
    constexpr bool BIG = decltype(bg)::value;
    using Bk = nrf::Blk<BIG>;
    const size_t smem = sizeof(float2) * Bk::PADDED +
                        sizeof(float) * ((size_t)(tile_frames - 1) * hop + 2 * win);
    const auto kernel = spectra_cplx_kernel<ODD, decltype(pr)::value, decltype(ch)::value, BIG>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, Bk::THREADS, smem, st>>>(
        x, n_src, n_chunks, chunk_stride, view_start, view_len, n_frames, hop, bpad, win, n,
        n_bins, tile_frames, n_tiles, ws, reinterpret_cast<const float2*>(tw),
        reinterpret_cast<const float2*>(tws), reinterpret_cast<const float2*>(chirp),
        reinterpret_cast<const float2*>(filt), re, im,
        nrf::make_plan<ODD != 1>(slot, seg_warps, Bk::WARPS),
        nrf::Div<true>(paired ? n_bins : (n + 1) / 2));
    return (int)cudaGetLastError();
  });
}
