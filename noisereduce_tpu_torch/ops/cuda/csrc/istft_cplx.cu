// Kernel D, complex-frame kernels: mask apply, inverse FFT, overlap-add,
// envelope division and the output window, for the n_fft of the FFT route
// that istft_fft.cu does not serve (M with a factor 11 or 13, or within a
// block from 17 to 31, and every odd n_fft whose prime factors are at most
// 13, or 31 within a block) and for the chirp-z route (fft_route.cuh).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// (noisereduce_tpu/ops/pallas/geometry.py:146).
//
// Computes what istft_fft.cu computes, with the same runs of output hop
// blocks, groups of frames, overlap-add in ascending frame order (the
// output is the same whatever the run), envelope and trim. A frame slot of
// T points holds one inverse transform of n complex points:
// - even N: n = M = N/2; Y = Z * mask (no imaginary DC or Nyquist part)
//   turned into Z' by fft_smem.cuh::unsplit, whose inverse holds
//   M (y[2m] + i y[2m+1]), as istft_fft.cu does;
// - odd N (PAIRED): n = N, two frames a slot, 2s and 2s + 1 (groups start
//   at an even frame, and a zero frame stands in past the last), so a
//   frame has the same partner in every run and the output does not depend
//   on the run: the Hermitian spectra of frames a and b as
//   W[k] = Y_a[k] + i Y_b[k], W[N-k] = conj Y_a[k] + i conj Y_b[k]
//   (k < (N + 1) / 2; the imaginary DC parts dropped), whose inverse holds
//   N (y_a + i y_b).
// On the FFT route T = n and the slot takes fft_smem.cuh's unscaled n-point
// inverse. On the chirp route T = L >= 2n - 1 and the inverse is
//   y_j = c_j sum_k (W_k c_k) cbar_{j-k},  c_j = e^{i pi j^2 / n},
// the conjugate of kernel A's: W times c (zero past n), the L-point FFT,
// times conj filt (FFT_L(cbar wrapped) / L), the unscaled inverse, and
// the first n points times c_j, from the same host tables as kernel A
// (conjugated here). post carries 1/n either way.
//
// Bound on this card: bytes, as istft_fft.cu, and its bf16 build as
// istft_fft.cu's. Design: persistent blocks, as many as the card holds at
// once (nr_istft_cplx_capacity), walk the launch's items b, b + grid, ...;
// each inverts frames in groups of the frame slots of the block's thread
// segments:
// - the pre-step from device memory: the unsplit of each pair (k, n - k)
//   from the products Y = Z * mask, each rounded as a product (__fmul_rn),
//   or a frame pair's W[k] and W[n - k];
// - the stages out of place through a second buffer of the block's points
//   (fft_frames_large: stage_oop holds no value across a barrier), their
//   twiddles laid out in shared memory in the order the stages read them
//   (fft_smem.cuh::lay_twiddles; stage_large's roots from the plan's
//   table).
// A slot within a block's 4096 points takes istft_fft.cu's walk and ring,
// without its slab: an item is a run of output hop blocks of a row (the
// caller's run, geometry.py::cplx_run: the geometry's longest, or a
// shorter one that fills whole groups where that takes fewer rounds of the
// grid), its frames the run's and r - 1 halo frames, summed in a
// shared-memory ring of G + r - 1 hop blocks, each sample owned by one
// thread, its frames in ascending order, a finished sample of the run
// divided by the envelope as it leaves the ring (RING_UNROLL samples a
// thread at once, pairs of samples for an even hop and an even N).
// A slot past 4096 points (BIG: a block of 1024 threads and 8192 points,
// one slot a group) takes the cluster routes' two passes: an item is a
// group of the frames the output window needs (geometry.py::
// cluster_frames), each frame inverted once and its win samples written to
// a scratch of (rows, frames, win) float32; then istft_cluster.cuh's
// overlap-add pass sums them in ascending frame order, one fmaf each, as
// the ring does (the output is the walk's, bit for bit). The walk's runs
// inverted their halo frames again (runs of 11 at 4106 / 2053 on one view:
// 12 frames and a flush for 11 outputs); the two passes ran D 7% faster
// at 4106 and 19% at 8580, and leave the ring out of shared memory, so
// that every big block holds its laid table (PERF.md). On block-sized
// slots they ran 3-11% faster on 5 views of 60 s at 1100, 1101 and 1102,
// but 14% slower at 1100 on 960 s, 20% at 1323 and 69% at 37: the walk
// stays there.
// Also measured (PERF.md): a slab of the next group's re, im and mask
// copied by cp.async as istft_fft.cu does ran D 3-11% slower at every cell
// it was taken; stages in place, 21-26% slower on the FFT route's small
// radices and 11-29% in a big block.
#include <type_traits>

#include "fft_smem.cuh"
#include "istft_cluster.cuh"  // istft_cluster_ola_kernel, OLA_THREADS
#include "planes.cuh"
#include "tile_span.cuh"  // active_blocks

namespace {

// ring samples (pairs for an even hop and an even N) a thread sums at once
constexpr int RING_UNROLL = 6;

// The items of a launch (a kernel parameter): n_runs a row, each `run`
// output hop blocks (the walk) or `run` frames (BIG) of the frames f_lo to
// f_lo + n_fr - 1, whose win samples each go to y (rows, n_fr, win)
struct Runs {
  long long out_off, out_len, istft_len;
  float env_floor;
  int n_frames, n_bins, hop, r, bpad, j0, n_out, run, n_runs, total;
  float* y;
  int f_lo, n_fr, win;
};

// Item `item`: row b, frames [t_lo, t_hi] (none if t_lo > t_hi), from an
// even frame when PAIRED; on the walk the run's output hop blocks [ja, ja +
// je)
struct Run {
  int b, ja, je, t_lo, t_hi;
};

template <bool PAIRED, bool BIG>
__device__ __forceinline__ Run run_of(int item, const Runs& p) {
  Run u;
  u.b = item / p.n_runs;
  if constexpr (BIG) {
    u.ja = u.je = 0;
    u.t_lo = p.f_lo + (item - u.b * p.n_runs) * p.run;
    u.t_hi = min(p.f_lo + p.n_fr, u.t_lo + p.run) - 1;
  } else {
    u.ja = p.j0 + (item - u.b * p.n_runs) * p.run;
    u.je = min(p.run, p.j0 + p.n_out - u.ja);
    u.t_lo = max(0, u.ja - p.r + 1) & (PAIRED ? ~1 : ~0);
    u.t_hi = min(p.n_frames - 1, u.ja + u.je - 1);
  }
  return u;
}

// Dynamic shared memory of a build: the slots and the second buffer, the
// laid twiddles (T - 1 entries, made even) and, on the walk, the ring of G
// + r - 1 hop blocks
template <bool BIG>
size_t cplx_smem(int slot, int G, int hop, int r) {
  using Bk = nrf::Blk<BIG>;
  return sizeof(float2) * (Bk::PADDED * 2 + ((slot + 1) & ~1)) +
         (BIG ? 0 : sizeof(float) * (size_t)(G + r - 1) * hop);
}

template <int ODD, bool PAIRED, bool CHIRP, bool BIG, bool LARGE,
          class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::Blk<BIG>::THREADS, BIG ? 1 : 2)
    istft_cplx_kernel(const P* __restrict__ re, const P* __restrict__ im,
                      const float* __restrict__ mask, const Runs p, const nrf::Div<true> dhop,
                      int n, const float* __restrict__ post,
                      const float* __restrict__ wsq, const float* __restrict__ env_int,
                      const float2* __restrict__ tw, const float2* __restrict__ tws,
                      const float2* __restrict__ chirp, const float2* __restrict__ filt,
                      P* __restrict__ out,
                      const nrf::Plan<true> plan,
                      const nrf::Div<true> dh, const nrf::Div<true> dnb) {
  using B = nrf::Blk<BIG>;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  extern __shared__ __align__(16) float2 smem2[];
  const int T = plan.m.d;  // points a slot: n, or the chirp length
  // each segment of threads loads, transforms and inverts its own slots
  const nrf::Seg sg = nrf::segment(plan);
  const int S = plan.segs * plan.fps;  // slots a group holds
  const int G = FPS * S;               // frames a group holds
  const int n_bins = p.n_bins;
  // the slots, the second buffer, the laid twiddles and the walk's ring
  float2* z = smem2;
  float2* sc = z + B::PADDED;
  float2* stw = sc + B::PADDED;
  float* acc = reinterpret_cast<float*>(stw + ((T + 1) & ~1));
  const int NB = G + p.r - 1;  // hop blocks the ring holds
  const int ring = NB * p.hop;
  const int tid = threadIdx.x;
  if constexpr (!BIG)
    for (int i = tid; i < ring; i += B::THREADS) acc[i] = 0.f;
  nrf::lay_twiddles(stw, tw, T, plan, B::THREADS);

  // sample q of hop block jj of row b, a: the overlap-add's sum; divided
  // by the envelope and written where it falls in the trimmed output
  const auto finish = [&](int b, int jj, int q, float a) {
    const long long s = (long long)jj * p.hop + q - p.bpad;
    const long long o = s - p.out_off;
    if (o < 0 || o >= p.out_len) return;
    float y = 0.f;
    if (s < p.istft_len) {
      float env;
      if (jj - p.r + 1 >= 0 && jj < p.n_frames) {
        env = __ldg(env_int + q);
      } else {
        env = 0.f;  // frames in ascending t, as the table sums them
        for (int i = p.r - 1; i >= 0; --i) {
          const int t = jj - i;
          if (t >= 0 && t < p.n_frames) env += __ldg(wsq + i * p.hop + q);
        }
      }
      y = a / (env > p.env_floor ? env : 1.f);
    }
    planes::st(out + (long long)b * p.out_len + o, y);
  };

  for (int item = blockIdx.x; item < p.total; item += gridDim.x) {
    const Run u = run_of<PAIRED, BIG>(item, p);
    if (!BIG && u.t_lo > u.t_hi) {  // no frame reaches the run: its sums are 0
      for (int l = tid; l < u.je * p.hop; l += B::THREADS) {
        const int jb = dhop.div(l);
        finish(u.b, u.ja + jb, l - jb * p.hop, 0.f);
      }
      continue;
    }
    for (int tg = u.t_lo; tg <= u.t_hi; tg += G) {
      const int ge = min(G, u.t_hi - tg + 1);
      const int n_slots = (ge + FPS - 1) / FPS;
      const int nf = nrf::seg_frames(sg, plan, n_slots);
      const int first = sg.f0 * T;  // the segment's first point
      __syncthreads();  // the last overlap-add done
      {
        const long long og = ((long long)u.b * p.n_frames + tg) * n_bins;  // the group's bins
        // bin q of the group's frame f: re, im and the mask
        const auto at = [&](int f, int q, float& zr, float& zi, float& mk) {
          const long long o = og + f * n_bins + q;
          zr = planes::ld(re + o);
          zi = planes::ld(im + o);
          mk = __ldg(mask + o);
        };
        if constexpr (PAIRED) {
          // slot bin k: W[k] and W[N - k] from bin k of frames a and b
          for (int e = sg.lane; e < nf * n_bins; e += plan.threads) {
            const int sl = dnb.div(e);
            const int k = e - sl * n_bins;
            const int fa = FPS * (sg.f0 + sl);
            float ra, ia, ma;
            at(fa, k, ra, ia, ma);
            const float2 ya = make_float2(ra * ma, k ? ia * ma : 0.f);
            float2 yb = make_float2(0.f, 0.f);
            if (tg + fa + 1 < p.n_frames) {
              float rb, ib, mb;
              at(fa + 1, k, rb, ib, mb);
              yb = make_float2(rb * mb, k ? ib * mb : 0.f);
            }
            const int base = first + sl * T;
            float2 w = make_float2(ya.x - yb.y, ya.y + yb.x);
            if constexpr (CHIRP) w = nrf::cmul(w, nrf::conj(__ldg(chirp + k)));
            z[nrf::pad(base + k)] = w;
            if (k) {
              w = make_float2(ya.x + yb.y, yb.x - ya.y);
              if constexpr (CHIRP) w = nrf::cmul(w, nrf::conj(__ldg(chirp + n - k)));
              z[nrf::pad(base + n - k)] = w;
            }
          }
        } else {
          // Y = Z * mask at bin q of frame f, no imaginary DC or Nyquist part
          const auto Y = [&](int f, int q) {
            float zr, zi, mk;
            at(f, q, zr, zi, mk);
            return make_float2(__fmul_rn(zr, mk), (q == 0 || q == n) ? 0.f : __fmul_rn(zi, mk));
          };
          // the pre-step: pair (k, n - k) (k = 0: with Y[M], and n/2 for
          // an even n), times c_k on the chirp route
          for (int e = sg.lane; e < nf * dh.d; e += plan.threads) {
            const int sl = dh.div(e);
            const int k = e - sl * dh.d;
            const int f = sg.f0 + sl;
            const int base = first + sl * T;
            float2 lo, hi;
            nrf::unsplit(Y(f, k), Y(f, k ? n - k : n), __ldg(tws + k), lo, hi);
            if constexpr (CHIRP) lo = nrf::cmul(lo, nrf::conj(__ldg(chirp + k)));
            z[nrf::pad(base + k)] = lo;
            if (k != 0) {
              if constexpr (CHIRP) hi = nrf::cmul(hi, nrf::conj(__ldg(chirp + n - k)));
              z[nrf::pad(base + n - k)] = hi;
            } else if (!(n & 1)) {
              const float2 yh = Y(f, n / 2);
              nrf::unsplit(yh, yh, __ldg(tws + n / 2), lo, hi);
              if constexpr (CHIRP) lo = nrf::cmul(lo, nrf::conj(__ldg(chirp + n / 2)));
              z[nrf::pad(base + n / 2)] = lo;
            }
          }
        }
        if constexpr (CHIRP) {  // zero past n
          for (int e = sg.lane; e < nf * T; e += plan.threads)
            if (e - plan.m.div(e) * T >= n) z[nrf::pad(first + e)] = make_float2(0.f, 0.f);
        }
      }
      __syncthreads();  // the group's slots filled

      float2* zo = z;  // the transform's result
      if constexpr (CHIRP) {
        zo = nrf::fft_frames_large<false, ODD, false>(z, sc, T, n_slots, stw, sg, plan);
        for (int e = sg.lane; e < nf * T; e += plan.threads) {
          const int l = nrf::pad(first + e);
          zo[l] = nrf::cmul(zo[l], nrf::conj(__ldg(filt + (e - plan.m.div(e) * T))));
        }
        nrf::seg_sync(sg, plan);
        zo = nrf::fft_frames_large<true, ODD, false>(zo, zo == z ? sc : z, T, n_slots, stw, sg,
                                                    plan);
        for (int e = sg.lane; e < nf * T; e += plan.threads) {
          const int q = e - plan.m.div(e) * T;
          if (q < n) {
            const int l = nrf::pad(first + e);
            zo[l] = nrf::cmul(zo[l], nrf::conj(__ldg(chirp + q)));
          }
        }
      } else {
        zo = nrf::fft_frames_large<true, ODD, LARGE>(z, sc, T, n_slots, stw, sg, plan, tw);
      }
      __syncthreads();  // the overlap-add reads every slot of the group

      if constexpr (BIG) {
        // the group's frames, win samples each, to the scratch: y_t[u] is
        // float u of frame t's slot (even N), or the real (a) or imaginary
        // (b) part of point u of its slot (PAIRED)
        const float* zf = reinterpret_cast<const float*>(zo);
        for (int f = 0; f < ge; ++f) {
          float* yt = p.y + ((long long)u.b * p.n_fr + tg + f - p.f_lo) * p.win;
          for (int q = tid; q < p.win; q += B::THREADS)
            yt[q] = PAIRED ? zf[2 * nrf::pad((f >> 1) * T + q) + (f & 1)]
                           : zf[2 * nrf::pad(f * T + (q >> 1)) + (q & 1)];
        }
        continue;  // the walk's ring below
      }

      // overlap-add into the ring: slot block jj in [tg, tg + NB), jj mod
      // NB, takes frames t in [jj - r + 1, jj] of this group, ascending;
      // y_t[u] is float u of frame t's slot (even N), or the real (a) or
      // imaginary (b) part of point u of its slot (PAIRED). Blocks below tg
      // + G (all, after the run's last group) leave the ring: finished if
      // in the run. W samples a thread at a time: 2 for an even hop and an
      // even N, whose pairs (2l, 2l + 1) share a hop block and a point
      const bool last = tg + G > u.t_hi;
      const int tgm = tg % NB;
      const auto add = [&](auto width) {
        constexpr int W = decltype(width)::value;
        using V = std::conditional_t<W == 2, float2, float>;
        const float* zf = reinterpret_cast<const float*>(zo);
        for (int i0 = W * tid; i0 < ring; i0 += RING_UNROLL * W * B::THREADS) {
#pragma unroll
          for (int k = 0; k < RING_UNROLL; ++k) {
            const int i = i0 + k * W * B::THREADS;
            if (i >= ring) break;
            const int slot = dhop.div(i);
            const int q = i - slot * p.hop;
            const int jj = tg + slot - tgm + (slot < tgm ? NB : 0);
            const int ta = max(tg, jj - p.r + 1);
            const int tb = min(tg + ge - 1, jj);
            V a = *reinterpret_cast<const V*>(acc + i);
            for (int t = ta; t <= tb; ++t) {
              const int uu = (jj - t) * p.hop + q;
              const int f = t - tg;
              if constexpr (W == 2) {  // uu even: the pair is point uu / 2 of the slot
                const float2 w = __ldg(reinterpret_cast<const float2*>(post + uu));
                const float2 y = zo[nrf::pad(f * T + (uu >> 1))];
                a = make_float2(fmaf(w.x, y.x, a.x), fmaf(w.y, y.y, a.y));
              } else {
                const float y = PAIRED ? zf[2 * nrf::pad((f >> 1) * T + uu) + (f & 1)]
                                       : zf[2 * nrf::pad(f * T + (uu >> 1)) + (uu & 1)];
                a = fmaf(__ldg(post + uu), y, a);
              }
            }
            if (last || jj < tg + G) {
              if (jj >= u.ja && jj < u.ja + u.je) {
                if constexpr (W == 2) {
                  finish(u.b, jj, q, a.x);
                  finish(u.b, jj, q + 1, a.y);
                } else {
                  finish(u.b, jj, q, a);
                }
              }
              a = V{};
            }
            *reinterpret_cast<V*>(acc + i) = a;
          }
        }
      };
      if constexpr (PAIRED) {
        add(std::integral_constant<int, 1>());
      } else {
        if (p.hop % 2)
          add(std::integral_constant<int, 1>());
        else
          add(std::integral_constant<int, 2>());
      }
    }
    if (!BIG && u.t_hi + p.r < u.ja + u.je) {
      // the run reaches past its last frame's reach, t_hi + r - 1: its
      // blocks past the ring of its last group tl, [tl, tl + NB), sum no
      // frame
      const int tl = u.t_lo + (u.t_hi - u.t_lo) / G * G;
      for (int l = (tl + NB - u.ja) * p.hop + tid; l < u.je * p.hop; l += B::THREADS) {
        const int jb = dhop.div(l);
        finish(u.b, u.ja + jb, l - jb * p.hop, 0.f);
      }
    }
  }
}

// The launch of a build: its threads, dynamic shared memory and the
// persistent grid the card holds at once
struct Shape {
  int threads, fit;
  size_t smem;
};

// f(kernel, shape, Of<T>) for the build of n_fft with slots of `slot`
// points, planes of type `plane`, segments of seg_warps warps and the ring
// of hop and r; cudaErrorInvalidValue for a pair no build takes, else a
// negative CUDA error of the occupancy query
template <class F>
int with_cplx_launch(int plane, int n_fft, int slot, int seg_warps, int hop, int r, F f) {
  const bool big = slot > nrf::ELEMS;
  const int S = nrf::fft_block_frames(seg_warps, slot, big ? nrf::Blk<true>::WARPS : nrf::WARPS);
  const int G = (n_fft % 2 ? 2 : 1) * S;
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return nrf::with_cplx_build(n_fft, slot, [&](auto odd, auto pr, auto ch, auto bg, auto lg) {
      constexpr int ODD = decltype(odd)::value;
      constexpr bool PAIRED = decltype(pr)::value, CHIRP = decltype(ch)::value;
      constexpr bool BIG = decltype(bg)::value, LARGE = decltype(lg)::value;
      const auto kernel = istft_cplx_kernel<ODD, PAIRED, CHIRP, BIG, LARGE, T>;
      Shape sh{nrf::Blk<BIG>::THREADS, 0, cplx_smem<BIG>(slot, G, hop, r)};
      sh.fit = nrs::active_blocks(kernel, sh.smem, sh.threads);
      if (sh.fit < 1) return sh.fit < 0 ? sh.fit : -(int)cudaErrorInvalidConfiguration;
      return f(kernel, sh, tag);
    });
  });
}

}  // namespace

// plane: the type of re, im and out (planes.cuh: 0 float32, 1 bfloat16);
// re/im: (rows, n_frames, n_bins); mask: the same, f32; post, wsq: (r *
// hop,) f32; env_int: (hop,) f32; tw: (2 slot,) complex f32, the core's
// table; tws: (n_fft,) complex f32, the unsplit's (even n_fft); chirp: (n,)
// complex f32 and filt: (slot,) complex f32 on the chirp route, else null;
// out: (rows, out_len). slot as nr_spectra_cplx takes it, seg_warps a
// segment of warps that holds a slot. A block-sized slot: run, the output
// hop blocks a run covers (geometry.py::cplx_run); persistent blocks, at
// most nr_istft_cplx_capacity of them, walk the runs. A big block's slot
// (past 4096 points): run unused; y, the scratch, (rows, n_fr, r * hop)
// f32, frames t_lo to t_lo + n_fr - 1 (geometry.py::cluster_frames: the
// frames of hop blocks j0 to j0 + n_out - 1, t_lo even for an odd n_fft);
// persistent blocks walk groups of its frames, then the overlap-add pass.
// Returns the first launch error.
extern "C" int nr_istft_cplx(int plane, const void* re, const void* im, const float* mask,
                             int rows, int n_frames, int n_bins, int n_fft, int slot,
                             int seg_warps, int hop, int r, int bpad, int j0,
                             int n_out, int run, long long out_off, long long out_len,
                             long long istft_len, float env_floor,
                             const float* post, const float* wsq,
                             const float* env_int, const float* tw, const float* tws,
                             const float* chirp, const float* filt, float* y, int t_lo,
                             int n_fr, void* out, void* stream) {
  const int n = nrf::fft_n(n_fft);
  const bool paired = n_fft % 2, big = slot > nrf::ELEMS;
  const int block_warps = big ? nrf::Blk<true>::WARPS : nrf::WARPS;
  const int S = nrf::fft_block_frames(seg_warps, slot, block_warps);
  const int G = (paired ? 2 : 1) * S;
  const int win = r * hop;
  int lo = j0 - r + 1 > 0 ? j0 - r + 1 : 0;  // a big block's frames
  if (paired) lo &= ~1;
  const int hi = j0 + n_out - 1 < n_frames - 1 ? j0 + n_out - 1 : n_frames - 1;
  if (!nrf::cplx_slot_ok(n_fft, slot) || (slot != n && (!chirp || !filt)) || S < 1 ||
      run < 1 || n_bins != n_fft / 2 + 1 ||
      (big && (win > n_fft || t_lo != lo || n_fr != (hi >= lo ? hi - lo + 1 : 0))))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_out <= 0) return (int)cudaGetLastError();
  const int n_runs = big ? (n_fr + G - 1) / G : (n_out + run - 1) / run;  // items a row
  const long long samples = (long long)n_out * hop;
  const long long ola_blocks = (long long)rows * ((samples + OLA_THREADS - 1) / OLA_THREADS);
  if ((long long)rows * n_runs > 0x7FFFFFFFLL ||
      (big && (samples > 0x7FFFFFFFLL || ola_blocks > 0x7FFFFFFFLL)))
    return (int)cudaErrorInvalidValue;
  const Runs p{out_off, out_len, istft_len, env_floor, n_frames, n_bins, hop, r,
               bpad,    j0,      n_out,     big ? G : run,        n_runs,
               rows * n_runs,             y,         t_lo,      n_fr,  win};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = with_cplx_launch(plane, n_fft, slot, seg_warps, hop, r,
                          [&](auto kernel, const Shape& sh, auto tag) {
    using T = typename decltype(tag)::type;
    if (p.total > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(unsigned)(p.total < sh.fit ? p.total : sh.fit), sh.threads, sh.smem, st>>>(
          static_cast<const T*>(re), static_cast<const T*>(im), mask, p, nrf::Div<true>(hop), n,
          post, wsq, env_int, reinterpret_cast<const float2*>(tw),
          reinterpret_cast<const float2*>(tws), reinterpret_cast<const float2*>(chirp),
          reinterpret_cast<const float2*>(filt), static_cast<T*>(out),
          nrf::make_plan<true>(slot, seg_warps, sh.threads / 32),
          nrf::Div<true>(paired ? n_bins : (n + 1) / 2), nrf::Div<true>(n_bins));
    }
    if (big)
      istft_cluster_ola_kernel<T><<<(unsigned)ola_blocks, OLA_THREADS, 0, st>>>(
          y, n_frames, hop, r, bpad, j0, n_out, win, t_lo, n_fr, out_off, out_len, istft_len,
          env_floor, post, wsq, env_int, static_cast<T*>(out));
    return (int)cudaGetLastError();
  });
  return e < 0 ? -e : e;  // an occupancy query's error, as a CUDA error code
}

// The persistent grid of nr_istft_cplx for these arguments: the blocks of
// its build the current device holds at once; a negative CUDA error code on
// failure (invalid: a pair no build takes).
extern "C" int nr_istft_cplx_capacity(int plane, int n_fft, int slot, int seg_warps,
                                      int n_bins, int hop, int r) {
  const bool big = slot > nrf::ELEMS;
  if (!nrf::cplx_slot_ok(n_fft, slot) || n_bins != n_fft / 2 + 1 ||
      nrf::fft_block_frames(seg_warps, slot, big ? nrf::Blk<true>::WARPS : nrf::WARPS) < 1)
    return -(int)cudaErrorInvalidValue;
  return with_cplx_launch(plane, n_fft, slot, seg_warps, hop, r,
                          [&](auto, const Shape& sh, auto) { return sh.fit; });
}
