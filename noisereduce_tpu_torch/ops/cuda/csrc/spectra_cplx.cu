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
// tiles b, b + grid, ...; every build runs every stage out of place
// between two buffers of the block's points (fft_smem.cuh::
// fft_frames_large: stage_oop, which holds no value across a barrier, and
// stage_large for a prime factor from 17 to 31, n = 551 = 19 x 29 at n_fft
// 1102, in place of a chirp of twice its length), from the slot's
// twiddles laid out in shared memory once a block in the order the stages
// read them (fft_smem.cuh::lay_twiddles: a warp reads consecutive
// entries, where the host table's reads scatter; stage_large's roots from
// the host table), as kernel D's complex-frame kernel does. In place,
// stage's values held across its barrier spilled 144-690 B a thread at
// the 64-register budget and ran A 17-33% slower (PERF.md).
// - A block of 512 threads (a slot within 4096 points) stages the window
//   once and copies the next tile's span with 16-byte cp.async
//   (tile_span.cuh::issue_span, shared with spectra_fft.cu: raw plane
//   values, widened where they are packed) while this tile's stages and
//   unpack run (PERF.md: 4-7% faster than one tile a block loading its
//   span behind guards at 4 of 5 cells, 6% slower at the fifth); 1 or 2
//   blocks an SM, as its shared memory allows.
// - A slot past 4096 points takes a big block of 1024 threads and 8192
//   points (fft_smem.cuh::Blk), one slot a tile, one block an SM: its two
//   buffers and laid table fill most of the SM's shared memory, so it
//   stages neither window nor span. Its pack reads the frame's samples
//   straight from the plane (consecutive threads on consecutive samples,
//   behind the span's guards, tile_span.cuh::span_bounds) and the window
//   through __ldg (4 points a thread at once ran 1.5% slower and spilled:
//   PERF.md).
// In a big block and a build with radix 13 (and no large radix) the
// tile's index goes through shared memory across the stages, so that no
// register holds the tile (held in registers, it spilled 4-12 B a thread
// in the radix-13 builds at the 64-register budget and ran the big block
// 3-11% slower); the other builds keep the tile's view, first frame and
// frames in registers, which ran them up to 4% faster (PERF.md). The
// builds with the large radices beside radix 11 or 13 spill either way
// (4-16 B a thread so, 4-40 B with the index in shared memory).
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

// whether a build's tile index crosses the stages in shared memory
template <int ODD, bool BIG, bool LARGE>
constexpr bool TILE_SM = BIG || (ODD % 13 == 0 && !LARGE);

template <int ODD, bool PAIRED, bool CHIRP, bool BIG, bool LARGE, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::Blk<BIG>::THREADS, BIG ? 1 : 2)
    spectra_cplx_kernel(const P* __restrict__ x, long long n_src, int n_chunks,
                        long long chunk_stride, long long view_start, int view_len,
                        int n_frames, int hop, int bpad, int win, int n, int n_bins,
                        int tile_frames, int n_tiles, int total, const float* __restrict__ ws,
                        const float2* __restrict__ tw, const float2* __restrict__ tws,
                        const float2* __restrict__ chirp, const float2* __restrict__ filt,
                        P* __restrict__ re, P* __restrict__ im, const nrf::Plan<true> plan,
                        const nrf::Div<true> dh) {
  using B = nrf::Blk<BIG>;
  using R = Raw<P>;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  extern __shared__ __align__(16) float2 smem2[];
  const int T = plan.m.d;  // points a slot: n, or the chirp length
  // the slots, the second buffer and the laid twiddles (T - 1 entries,
  // made even); a block of 512 threads: the raw span (16-byte aligned),
  // the window, and the phase of the span in flight (in shared memory,
  // not a register live across the stages)
  float2* z = smem2;
  float2* sc = z + B::PADDED;
  float2* stw = sc + B::PADDED;
  R* raw = reinterpret_cast<R*>(stw + ((T + 1) & ~1));
  float* wsm =
      reinterpret_cast<float*>(raw + ((tile_frames - 1) * hop + win + 16 / sizeof(R) + 3) / 4 * 4);
  int* span_ph = reinterpret_cast<int*>(wsm + win);
  // the tile's index across the stages (TILE_SM)
  int* tile_sm = BIG ? reinterpret_cast<int*>(stw + ((T + 1) & ~1)) : span_ph + 1;
  const int tid = threadIdx.x;

  int tile = blockIdx.x;
  if constexpr (!BIG) {
    for (int i = tid; i < win; i += B::THREADS) wsm[i] = __ldg(ws + i);
    if (tile < total) {
      const Tile t = tile_of(tile, n_tiles, n_chunks, tile_frames, n_frames, hop, bpad, win,
                             chunk_stride, view_start);
      const int ph = issue_span<P, B::THREADS>(x + (long long)(t.b / n_chunks) * n_src, t,
                                               view_len, n_src, raw);
      if (tid == 0) *span_ph = ph;
    }
  }
  // the laid twiddles, after the first span's copies are in flight, where
  // a stage reads them: one of radix 13 or less past the first (n = 551 =
  // 19 x 29 of n_fft 1102 has none)
  bool laid = false;
  for (int s = 1; s < plan.n_stages; ++s) laid |= plan.radix[s] <= 13;
  if (laid) nrf::lay_twiddles(stw, tw, T, plan, B::THREADS);
  while (tile < total) {
    const Tile t = tile_of(tile, n_tiles, n_chunks, tile_frames, n_frames, hop, bpad, win,
                           chunk_stride, view_start);
    if constexpr (!BIG) asm volatile("cp.async.wait_all;" ::: "memory");
    // the span in place (and the laid twiddles); the last tile's unpack
    // done with the buffers (and the tile's index)
    __syncthreads();
    if (TILE_SM<ODD, BIG, LARGE> && tid == 0) *tile_sm = tile;
    // a span sample (view position p0 + i) as a float: from the span in
    // shared memory, or (BIG) from the plane, zero outside the view and
    // the signal
    const R* sp = raw;
    if constexpr (!BIG) sp += *span_ph;
    const P* xr = x + (long long)(t.b / n_chunks) * n_src + t.s0;
    int lo = 0, hi = 0;
    if constexpr (BIG) nrs::span_bounds(t, view_len, n_src, lo, hi);
    const auto smp = [&](int i) -> float {
      if constexpr (BIG)
        return i >= lo && i < hi ? planes::ld(xr + i) : 0.f;
      else
        return widen_raw(sp[i]);
    };
    const auto wnd = [&](int q) -> float {
      if constexpr (BIG)
        return __ldg(ws + q);
      else
        return wsm[q];
    };

    // each segment of threads packs, transforms and unpacks its own slots
    const nrf::Seg sg = nrf::segment(plan);
    const int fe = t.fe;
    const int n_slots = (fe + FPS - 1) / FPS;
    const int nf = nrf::seg_frames(sg, plan, n_slots);
    const int first = sg.f0 * T;  // the segment's first point

    // the slots: the frames' n points (times cbar_j), zero past n
    const auto point = [&](int e) {
      const int sl = plan.m.div(e);
      const int q = e - sl * T;
      float2 v = make_float2(0.f, 0.f);
      if (q < n) {
        if constexpr (PAIRED) {  // z[j] = u_a[j] + i u_b[j]
          const int fa = FPS * (sg.f0 + sl);
          if (q < win) {
            const float w = wnd(q);
            v.x = w * smp(fa * hop + q);
            if (fa + 1 < fe) v.y = w * smp((fa + 1) * hop + q);
          }
        } else {  // z[q] = u[2q] + i u[2q+1]
          const int u = 2 * q;
          const int o = (sg.f0 + sl) * hop + u;
          v = make_float2(u < win ? wnd(u) * smp(o) : 0.f,
                          u + 1 < win ? wnd(u + 1) * smp(o + 1) : 0.f);
        }
        if constexpr (CHIRP) v = nrf::cmul(v, __ldg(chirp + q));
      }
      return v;
    };
    for (int e = sg.lane; e < nf * T; e += plan.threads) z[nrf::pad(first + e)] = point(e);
    // every read of the span done: the next tile's copies land there while
    // this tile's stages and unpack run
    __syncthreads();
    if constexpr (!BIG) {
      const int next = tile + gridDim.x;
      if (next < total) {
        const Tile u = tile_of(next, n_tiles, n_chunks, tile_frames, n_frames, hop, bpad, win,
                               chunk_stride, view_start);
        const int ph = issue_span<P, B::THREADS>(x + (long long)(u.b / n_chunks) * n_src, u,
                                                 view_len, n_src, raw);
        if (tid == 0) *span_ph = ph;
      }
    }

    // the transform (the chirp's: the convolution with c), its result in zo
    float2* zo = nrf::fft_frames_large<false, ODD, LARGE>(z, sc, T, n_slots, stw, sg, plan, tw);
    if constexpr (CHIRP) {
      for (int e = sg.lane; e < nf * T; e += plan.threads) {
        const int l = nrf::pad(first + e);
        zo[l] = nrf::cmul(zo[l], __ldg(filt + (e - plan.m.div(e) * T)));
      }
      nrf::seg_sync(sg, plan);
      zo = nrf::fft_frames_large<true, ODD, LARGE>(zo, zo == z ? sc : z, T, n_slots, stw, sg,
                                                   plan, tw);
    }

    // the tile's view, first frame and frames: kept, or (TILE_SM) again
    // from its index in shared memory, so that no register holds them (or
    // the unpack's addresses) across the stages
    int b = t.b, t0 = t.t0, fu = fe, nu = nf, fu0 = first;
    if constexpr (TILE_SM<ODD, BIG, LARGE>) {
      tile = *tile_sm;
      b = tile / n_tiles;
      t0 = (tile - b * n_tiles) * tile_frames;
      fu = min(tile_frames, n_frames - t0);
      nu = nrf::seg_frames(sg, plan, (fu + FPS - 1) / FPS);
      fu0 = sg.f0 * T;  // the segment's first point
    }

    // unpack into the tile's contiguous rows: slot point pair (k, n - k)
    // (k = 0 with itself) gives bin k of both frames (PAIRED), or bins k and
    // n - k, and for an even n n/2 with k = 0 (split)
    const int half = dh.d;  // pairs a slot: (n + 1) / 2
    const long long o0 = ((long long)b * n_frames + t0 + FPS * sg.f0) * n_bins;
    for (int e = sg.lane; e < nu * half; e += plan.threads) {
      const int sl = dh.div(e);
      const int k = e - sl * half;
      const int km = k ? n - k : 0;
      const int base = fu0 + sl * T;
      const long long row = o0 + (long long)FPS * sl * n_bins;
      float2 zk = zo[nrf::pad(base + k)], zm = zo[nrf::pad(base + km)];
      if constexpr (CHIRP) {
        zk = nrf::cmul(zk, __ldg(chirp + k));
        zm = nrf::cmul(zm, __ldg(chirp + km));
      }
      if constexpr (PAIRED) {
        planes::st(re + row + k, 0.5f * (zk.x + zm.x));
        planes::st(im + row + k, 0.5f * (zk.y - zm.y));
        if (FPS * (sg.f0 + sl) + 1 < fu) {
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
    tile += gridDim.x;
  }
}

// Dynamic shared memory of a build: the slots and the second buffer, the
// laid twiddles (slot - 1 entries, made even), for a block of 512 threads
// the span's raw plane values with 16 bytes of slack for their phase, the
// window and the phase, and the tile's index
template <bool BIG, class P>
size_t cplx_smem(int slot, int tile_frames, int hop, int win) {
  using Bk = nrf::Blk<BIG>;
  const size_t core = sizeof(float2) * (Bk::PADDED * 2 + ((slot + 1) & ~1));
  if (BIG) return core + sizeof(int);
  const size_t len = (size_t)(tile_frames - 1) * hop + win;
  return core + sizeof(Raw<P>) * ((len + 16 / sizeof(Raw<P>) + 3) / 4 * 4) +
         sizeof(float) * win + 2 * sizeof(int);
}

// f(kernel, smem, threads, Of<T>) for the build of n_fft with slots of
// `slot` points and planes of type `plane` (kernel: its instance, threads
// its block, smem its dynamic shared memory at tile_frames, hop and win;
// T the plane type); cudaErrorInvalidValue for a pair no build takes.
template <class F>
int with_cplx_kernel(int plane, int n_fft, int slot, int tile_frames, int hop, int win, F f) {
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return nrf::with_cplx_build(n_fft, slot, [&](auto odd, auto pr, auto ch, auto bg, auto lg) {
      constexpr bool BIG = decltype(bg)::value;
      return f(spectra_cplx_kernel<decltype(odd)::value, decltype(pr)::value,
                                   decltype(ch)::value, BIG, decltype(lg)::value, T>,
               cplx_smem<BIG, T>(slot, tile_frames, hop, win), nrf::Blk<BIG>::THREADS, tag);
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
                          [&](auto kernel, size_t smem, int threads, auto tag) {
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
        nrf::make_plan<true>(slot, seg_warps, threads / 32),
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
                          [&](auto kernel, size_t smem, int threads, auto) {
    return active_blocks(kernel, smem, threads);
  });
}
