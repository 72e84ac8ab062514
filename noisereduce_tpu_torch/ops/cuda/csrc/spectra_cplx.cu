// Kernel A, complex-frame kernels: spectra of every chunk view for the
// n_fft of the FFT route that spectra_fft.cu does not serve (M with a
// factor 11 or 13, or within a block from 17 to 31, and every odd n_fft
// whose prime factors are at most 13, or 31 within a block) and for the
// chirp-z route (fft_route.cuh).
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
// - odd N (PAIRED; n_fft 1, a slot of one point, among them): n = N, two
//   frames a slot, z[j] = u_a[j] + i u_b[j]
//   (a zero frame b past the tile's last), separated as
//   X_a[k] = (Z[k] + conj Z[N-k]) / 2,  X_b[k] = -i (Z[k] - conj Z[N-k]) / 2,
//   (N + 1) / 2 bins each, no Nyquist bin.
// On the FFT route T = n and the slot takes fft_smem.cuh's n-point FFT. On
// the chirp route (CHIRP; n to 4096 with a prime factor above 31) T = L >=
// 2n - 1 and
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
// this algorithm, not of the function); its bf16 build as spectra_fft.cu's.
// Design: as spectra_fft.cu, tiles of frames of one view, a block's
// threads in segments that each own whole slots. Persistent blocks, as
// many as the card holds at once (nr_spectra_cplx_capacity), walk the
// tiles b, b + grid, ..., stage the window once, and copy the next tile's
// span with 16-byte cp.async (tile_span.cuh::issue_span, shared with
// spectra_fft.cu: raw plane values, widened where they are packed) while
// this tile's stages and unpack run (PERF.md: with the
// stages out of place, 4-7% faster than one tile a block loading its span
// behind guards at 4 of 5 cells, 6% slower at the fifth). A block of 512
// threads holds two buffers of its 4096 points and runs every stage out
// of place (fft_smem.cuh::fft_frames_large: stage_oop, and stage_large
// for a prime factor from 17 to 31, n = 551 = 19 x 29 at n_fft 1102, in
// place of a chirp of twice its length); in place, stage's values held
// across its barrier spilled 144-690 B a thread at the 64-register budget
// (2 blocks an SM) and ran A 17-33% slower. A slot past 4096 points takes
// a big block of 1024 threads and 8192 points (fft_smem.cuh::Blk), one
// slot a block, one block an SM: its window and span fill the SM's shared
// memory, so its stages stay in place (fft_frames).
#include <type_traits>

#include "fft_smem.cuh"
#include "planes.cuh"
#include "tile_span.cuh"

namespace {

using nrs::Raw;
using nrs::Tile;
using nrs::active_blocks;
using nrs::issue_span;
using nrs::tile_of;
using nrs::widen_raw;

// the plan's divisions: multiply-high for a block's stages out of place,
// whose plan may hold any radix (fft_frames_large)
template <int ODD, bool BIG>
constexpr bool MIXED = ODD != 1 || !BIG;

template <int ODD, bool PAIRED, bool CHIRP, bool BIG, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::Blk<BIG>::THREADS, BIG ? 1 : 2)
    spectra_cplx_kernel(const P* __restrict__ x, long long n_src, int n_chunks,
                        long long chunk_stride, long long view_start, int view_len,
                        int n_frames, int hop, int bpad, int win, int n, int n_bins,
                        int tile_frames, int n_tiles, int total, const float* __restrict__ ws,
                        const float2* __restrict__ tw, const float2* __restrict__ tws,
                        const float2* __restrict__ chirp, const float2* __restrict__ filt,
                        P* __restrict__ re, P* __restrict__ im,
                        const nrf::Plan<MIXED<ODD, BIG>> plan, const nrf::Div<true> dh) {
  using B = nrf::Blk<BIG>;
  using R = Raw<P>;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  extern __shared__ __align__(16) float2 smem2[];
  const int T = plan.m.d;  // points a slot: n, or the chirp length
  float2* z = smem2;
  float2* sc = z + B::PADDED;  // a block's second buffer (none in a big block)
  // the raw span (16-byte aligned), the window, and the phase of the span
  // in flight: in shared memory, not a register live across the stages
  R* raw = reinterpret_cast<R*>(sc + (BIG ? 0 : B::PADDED));
  float* wsm =
      reinterpret_cast<float*>(raw + ((tile_frames - 1) * hop + win + 16 / sizeof(R) + 3) / 4 * 4);
  int* span_ph = reinterpret_cast<int*>(wsm + win);
  const int tid = threadIdx.x;
  for (int i = tid; i < win; i += B::THREADS) wsm[i] = __ldg(ws + i);

  int tile = blockIdx.x;
  if (tile < total) {
    const Tile t = tile_of(tile, n_tiles, n_chunks, tile_frames, n_frames, hop, bpad, win,
                           chunk_stride, view_start);
    const int ph = issue_span<P, B::THREADS>(x + (long long)(t.b / n_chunks) * n_src, t,
                                             view_len, n_src, raw);
    if (tid == 0) *span_ph = ph;
  }
  while (tile < total) {
    const Tile t = tile_of(tile, n_tiles, n_chunks, tile_frames, n_frames, hop, bpad, win,
                           chunk_stride, view_start);
    const int b = t.b, t0 = t.t0, fe = t.fe;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const R* sp = raw + *span_ph;
    // a span sample as a float
    const auto smp = [&](int i) -> float { return widen_raw(sp[i]); };

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
            v.x = w * smp(fa * hop + q);
            if (fa + 1 < fe) v.y = w * smp((fa + 1) * hop + q);
          }
        } else {  // z[q] = u[2q] + i u[2q+1]
          const int u = 2 * q;
          const int o = (sg.f0 + sl) * hop + u;
          v = make_float2(u < win ? wsm[u] * smp(o) : 0.f, u + 1 < win ? wsm[u + 1] * smp(o + 1) : 0.f);
        }
        if constexpr (CHIRP) v = nrf::cmul(v, __ldg(chirp + q));
      }
      z[nrf::pad(first + e)] = v;
    }
    // every read of the span done: the next tile's copies land there while
    // this tile's stages and unpack run
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < total) {
      const Tile u = tile_of(next, n_tiles, n_chunks, tile_frames, n_frames, hop, bpad, win,
                             chunk_stride, view_start);
      const int ph = issue_span<P, B::THREADS>(x + (long long)(u.b / n_chunks) * n_src, u,
                                               view_len, n_src, raw);
      if (tid == 0) *span_ph = ph;
    }

    // the transform (the chirp's: the convolution with c), its result in zo
    float2* zo = z;
    if constexpr (BIG) {
      nrf::fft_frames<false, ODD>(z, T, n_slots, tw, sg, plan);
    } else {
      zo = nrf::fft_frames_large<false, ODD>(z, sc, T, n_slots, tw, sg, plan);
    }
    if constexpr (CHIRP) {
      for (int e = sg.lane; e < nf * T; e += plan.threads) {
        const int l = nrf::pad(first + e);
        zo[l] = nrf::cmul(zo[l], __ldg(filt + (e - plan.m.div(e) * T)));
      }
      nrf::seg_sync(sg, plan);
      if constexpr (BIG) {
        nrf::fft_frames<true, ODD>(z, T, n_slots, tw, sg, plan);
      } else {
        zo = nrf::fft_frames_large<true, ODD>(zo, zo == z ? sc : z, T, n_slots, tw, sg, plan);
      }
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
      float2 zk = zo[nrf::pad(base + k)], zm = zo[nrf::pad(base + km)];
      if constexpr (CHIRP) {
        zk = nrf::cmul(zk, __ldg(chirp + k));
        zm = nrf::cmul(zm, __ldg(chirp + km));
      }
      if constexpr (PAIRED) {
        planes::st(re + row + k, 0.5f * (zk.x + zm.x));
        planes::st(im + row + k, 0.5f * (zk.y - zm.y));
        if (FPS * (sg.f0 + sl) + 1 < fe) {
          planes::st(re + row + n_bins + k, 0.5f * (zk.y + zm.y));
          planes::st(im + row + n_bins + k, 0.5f * (zm.x - zk.x));
        }
      } else {
        float2 lo, hi;
        nrf::split(zk, zm, __ldg(tws + k), lo, hi);
        planes::st(re + row + k, lo.x);
        planes::st(im + row + k, lo.y);
        planes::st(re + row + n - k, hi.x);
        planes::st(im + row + n - k, hi.y);
        if (k == 0 && !(n & 1)) {
          float2 zh = zo[nrf::pad(base + n / 2)];
          if constexpr (CHIRP) zh = nrf::cmul(zh, __ldg(chirp + n / 2));
          nrf::split(zh, zh, __ldg(tws + n / 2), lo, hi);
          planes::st(re + row + n / 2, lo.x);
          planes::st(im + row + n / 2, lo.y);
        }
      }
    }
    // the next tile, from the view and frame the unpack kept (no register
    // holds the tile index across the stages)
    tile = b * n_tiles + t0 / tile_frames + gridDim.x;
  }
}

// Dynamic shared memory of a build: the slots (a block's two buffers, a big
// block's one), the span's raw plane values with 16 bytes of slack for
// their phase, the window, and the phase
template <bool BIG, class P>
size_t cplx_smem(int tile_frames, int hop, int win) {
  using Bk = nrf::Blk<BIG>;
  const size_t slots = sizeof(float2) * Bk::PADDED * (BIG ? 1 : 2);
  const size_t len = (size_t)(tile_frames - 1) * hop + win;
  return slots + sizeof(Raw<P>) * ((len + 16 / sizeof(Raw<P>) + 3) / 4 * 4) +
         sizeof(float) * win + sizeof(int);
}

// f(kernel, smem, threads, Of<T>, MIXED) for the build of n_fft with slots
// of `slot` points and planes of type `plane` (kernel: its instance,
// threads its block, smem its dynamic shared memory at tile_frames, hop
// and win; T the plane type; MIXED its plan's); cudaErrorInvalidValue for
// a pair no build takes. A large radix's build (with_cplx_build's LARGE)
// is the same kernel as a build without: every block's stages run out of
// place, stage_large among them.
template <class F>
int with_cplx_kernel(int plane, int n_fft, int slot, int tile_frames, int hop, int win, F f) {
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return nrf::with_cplx_build(n_fft, slot, [&](auto odd, auto pr, auto ch, auto bg, auto) {
      constexpr int ODD = decltype(odd)::value;
      constexpr bool BIG = decltype(bg)::value;
      return f(spectra_cplx_kernel<ODD, decltype(pr)::value, decltype(ch)::value, BIG, T>,
               cplx_smem<BIG, T>(tile_frames, hop, win), nrf::Blk<BIG>::THREADS, tag,
               std::integral_constant<bool, MIXED<ODD, BIG>>());
    });
  });
}

}  // namespace

// plane: the type of x, re and im (planes.cuh: 0 float32, 1 bfloat16); x:
// (rows, n_src); ws: (win,) f32; tw: (2 slot,) complex f32, the core's
// table for slot points; tws: (n_fft,) complex f32, the split's (even
// n_fft); chirp: (n,) complex f32 and filt: (slot,) complex f32 on the
// chirp route, else null; re/im: (rows*n_chunks, n_frames, n_bins). slot:
// fft_n(n_fft) on the FFT route, the chirp length on the chirp route
// (fft_smem.cuh::cplx_slot_ok); seg_warps a segment of warps that holds a
// slot, tile_frames at most the frames of the block's slots. Launches
// persistent blocks, at most nr_spectra_cplx_capacity of them. Returns
// cudaGetLastError() after the launch.
extern "C" int nr_spectra_cplx(int plane, const void* x, long long n_src, int rows,
                               int n_chunks, long long chunk_stride,
                               long long view_start, int view_len,
                               int n_frames, int hop, int bpad, int win,
                               int n_fft, int n_bins, int slot, int seg_warps,
                               int tile_frames, const float* ws, const float* tw,
                               const float* tws, const float* chirp, const float* filt,
                               void* re, void* im, void* stream) {
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
  const int total = B * n_tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cplx_kernel(plane, n_fft, slot, tile_frames, hop, win,
                          [&](auto kernel, size_t smem, int threads, auto tag, auto mixed) {
    using T = typename decltype(tag)::type;
    // persistent: the blocks the card holds at once
    const int fit = active_blocks(kernel, smem, threads);
    if (fit < 0) return -fit;
    const int grid = total < fit ? total : fit;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, threads, smem, st>>>(
        static_cast<const T*>(x), n_src, n_chunks, chunk_stride, view_start, view_len,
        n_frames, hop, bpad, win, n, n_bins, tile_frames, n_tiles, total, ws,
        reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(tws),
        reinterpret_cast<const float2*>(chirp), reinterpret_cast<const float2*>(filt),
        static_cast<T*>(re), static_cast<T*>(im),
        nrf::make_plan<decltype(mixed)::value>(slot, seg_warps, threads / 32),
        nrf::Div<true>(paired ? n_bins : (n + 1) / 2));
    return (int)cudaGetLastError();
  });
}

// The persistent grid of nr_spectra_cplx for these arguments: the blocks
// of its build the current device holds at once; a negative CUDA error
// code on failure (invalid: a pair no build takes).
extern "C" int nr_spectra_cplx_capacity(int plane, int n_fft, int slot, int tile_frames,
                                        int hop, int win) {
  if (!nrf::cplx_slot_ok(n_fft, slot) || tile_frames < 1) return -(int)cudaErrorInvalidValue;
  return with_cplx_kernel(plane, n_fft, slot, tile_frames, hop, win,
                          [&](auto kernel, size_t smem, int threads, auto, auto) {
    return active_blocks(kernel, smem, threads);
  });
}
