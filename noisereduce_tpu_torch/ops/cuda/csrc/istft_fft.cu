// Kernel D, FFT route, real-FFT kernels: mask apply, inverse real FFT,
// overlap-add, envelope division and the output window, for an even n_fft
// from 2 to 8192 whose half is 2^k 3^a 5^b 7^c
// (fft_route.cuh::real_kernel). istft_cplx.cu serves the rest of the FFT
// route and the chirp-z route; the cluster and global kernels the longer
// frames.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331).
//
// Computes, with Y = Z * mask and y_t =
// irfft_N(Y_t) (imaginary DC and Nyquist parts ignored, scale 1/N), the
// overlap-add signal at p = j*hop + q is
//   x[p] = sum_{i < r, 0 <= j-i < T} post[u] y_{j-i}[u],  u = i*hop + q,
// post = w * sum w (scipy) or w (torch), divided by the window-square
// envelope env[p] = sum w[u]^2 over the same frames (entries <= env_floor
// count as 1). Only trimmed samples s = p - bpad in [out_off, out_off +
// out_len) are written, as out[b, s - out_off], zero where s is past the
// istft length.
//
// Bound on this card: bytes. re, im and the mask read once and the output
// written once (1.22 + 0.185 GB at the 960 s headline: 0.42 ms at 3.35 TB/s;
// the bf16 build, planes.cuh, reads bf16 re/im and the float32 mask and
// stores a bf16 output, the arithmetic in float32: 0.81 + 0.09 GB, 0.27 ms).
//
// Design: runs of `run` consecutive output hop blocks of one row
// (geometry.py's fft_run: run + r - 1 frames fill whole groups where a run
// of at most FFT_ACC samples can, 29 at hop 256 for 4 groups of 8, where
// 32 took a fifth group for 3 frames; below n_fft 64, where a group holds
// 136 to 4,096 frames, the run grows with it: the run plus its halo fill
// the fewest whole groups in which the halo takes at most half, 201 at
// n_fft 40 / hop 10, 4,095 at 2 / 1). Persistent blocks, as many as the
// card holds at once (nr_istft_fft_capacity; 2 an SM, 64 registers a
// thread), walk the runs b, b + grid, ...; each inverts the frames that
// cover its run, the run plus r - 1 halo frames, in groups of the frame
// slots of the block's thread segments (fft_smem.cuh; 8 at n_fft 1024, 5
// at 1536), and copies the next group's slab (re, im and the mask of its
// frames: three contiguous runs of G x n_bins values) into shared memory
// with 16-byte cp.async (tile_span.cuh::issue_copy) while this group's
// transform and overlap-add run:
//   pre    Z'[k] = (Y[k] + conj Y[M-k]) / 2 + i e^{2 pi i k/N} (Y[k] - conj Y[M-k]) / 2
//          straight from the slab (Y = Z * mask, each product rounded as a
//          product, __fmul_rn), one thread per pair (k, M-k), which also
//          gives Z'[M-k] = conj of the same with the second term negated
//          ((M + 1) / 2 slots a frame; slot 0 pairs 0 with Y[M], and for an
//          even M also turns M/2; the slot's divisions by the plan's
//          multiply-high);
//   FFT    the unscaled M-point inverse of fft_smem.cuh (M = N/2), in place
//          (a second buffer leaves one block an SM beside the slab: D 23%
//          slower at the headline, PERF.md), its twiddles from the stages'
//          table laid out in shared memory in the order the stages read
//          them (fft_smem.cuh::lay_twiddles), whose output holds M * (y[2m]
//          + i y[2m+1]); post carries the 1/M;
//   add    a ring of NB = G + r - 1 hop blocks in shared memory holds the
//          hop blocks [tg, tg + NB) that group tg's frames reach, block jj
//          in slot jj mod NB; each sample, owned by one thread, sums its
//          frames' post[u] y_t[u] in ascending t (post staged in shared
//          memory), and the blocks below tg + G, which no later frame
//          reaches, leave the ring: the thread divides a finished sample of
//          the run by the envelope, writes it, and zeroes the slot for the
//          block NB later. The run's blocks past its last frame's reach,
//          which the ring of its last group does not hold (all of them if
//          no frame reaches the run), finish sums of 0. A thread sums
//          RING_UNROLL of its samples at once and, for an even hop, pairs
//          of samples (one float2 of y and of post): 11% and 10% of D at
//          the headline (PERF.md). A run's sums held in registers instead
//          spilled 268-756 B a thread.
// No atomics: every sample sums the same products in the same order
// whatever run or group its frames land in, so the output is the same from
// run to run and a row's output does not depend on the other rows. The
// envelope is a host table for blocks where all r frames exist; at the
// edges the window's squares of the frames that exist, summed in the
// table's order (float32 for torch, as torch.istft sums it).
#include <type_traits>

#include "fft_smem.cuh"
#include "planes.cuh"
#include "tile_span.cuh"

namespace {

constexpr int BLOCKS_PER_SM = 2;
// ring samples (pairs for an even hop) a thread sums at once, unrolled:
// independent sums in flight
constexpr int RING_UNROLL = 6;

// The runs of a launch (a kernel parameter)
struct Runs {
  long long out_off, out_len, istft_len;
  float env_floor;
  int n_frames, n_bins, hop, r, bpad, j0, n_out, run, n_runs, total;
};

// Run `item`: row b, output hop blocks [ja, ja + je), frames [t_lo, t_hi]
// (none if t_lo > t_hi)
struct Run {
  int b, ja, je, t_lo, t_hi;
};

__device__ __forceinline__ Run run_of(int item, const Runs& p) {
  Run u;
  u.b = item / p.n_runs;
  u.ja = p.j0 + (item - u.b * p.n_runs) * p.run;
  u.je = min(p.run, p.j0 + p.n_out - u.ja);
  u.t_lo = max(0, u.ja - p.r + 1);
  u.t_hi = min(p.n_frames - 1, u.ja + u.je - 1);
  return u;
}

// Elements of a slab buffer: G frames of n_bins values and their slack
template <class T>
__host__ __device__ int slab_elems(int G, int n_bins) {
  return nrs::run_elems<T>(G * n_bins);
}

// the frames, the stages' laid twiddles (M - 1 entries, made even), the
// slab (re and im raw, the mask's bits), post, the ring of G + r - 1 hop
// blocks and the slab's three phases
template <class T>
size_t smem_bytes(int m, int G, int n_bins, int hop, int r) {
  return sizeof(float2) * (nrf::PADDED + ((m + 1) & ~1)) +
         2 * sizeof(nrs::Raw<T>) * slab_elems<T>(G, n_bins) +
         sizeof(float) * (slab_elems<float>(G, n_bins) + r * hop + (G + r - 1) * hop) +
         3 * sizeof(int);
}

template <int ODD, class T>  // fft_smem.cuh::odd_primes of M; the plane type
__global__ void __launch_bounds__(nrf::THREADS, BLOCKS_PER_SM)
    istft_fft_kernel(const T* __restrict__ re, const T* __restrict__ im,
                     const float* __restrict__ mask, const Runs p, const nrf::Div<true> dhop,
                     const float* __restrict__ post, const float* __restrict__ wsq,
                     const float* __restrict__ env_int, const float2* __restrict__ tw,
                     T* __restrict__ out, const nrf::Plan<ODD != 1> plan) {
  using R = nrs::Raw<T>;
  extern __shared__ __align__(16) float2 smem2[];
  const int m = plan.m.d;
  // each segment of threads inverts its own frames
  const nrf::Seg sg = nrf::segment(plan);
  const int G = plan.segs * plan.fps;  // frames a group holds
  // the frames, the laid twiddles, the slab (re, im, the mask's bits),
  // post, the ring and the slab's three phases
  float2* z = smem2;
  float2* stw = z + nrf::PADDED;
  R* re_s = reinterpret_cast<R*>(stw + ((m + 1) & ~1));
  R* im_s = re_s + slab_elems<T>(G, p.n_bins);
  unsigned* mk_s = reinterpret_cast<unsigned*>(im_s + slab_elems<T>(G, p.n_bins));
  float* post_s = reinterpret_cast<float*>(mk_s + slab_elems<float>(G, p.n_bins));
  const int NB = G + p.r - 1;  // hop blocks the ring holds
  const int ring = NB * p.hop;
  float* acc = post_s + p.r * p.hop;
  int* ph = reinterpret_cast<int*>(acc + ring);
  const int tid = threadIdx.x;
  for (int i = tid; i < p.r * p.hop; i += nrf::THREADS) post_s[i] = __ldg(post + i);
  for (int i = tid; i < ring; i += nrf::THREADS) acc[i] = 0.f;
  nrf::lay_twiddles(stw, tw, m, plan, nrf::THREADS);

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

  // the slab of frames [tg, tg + ge) of row b
  const auto issue = [&](int b, int tg, int ge) {
    const long long o = ((long long)b * p.n_frames + tg) * p.n_bins;
    const int len = ge * p.n_bins;
    const int a = nrs::issue_copy<T, nrf::THREADS>(re + o, 0, len, len, re_s);
    const int c = nrs::issue_copy<T, nrf::THREADS>(im + o, 0, len, len, im_s);
    const int d = nrs::issue_copy<float, nrf::THREADS>(mask + o, 0, len, len, mk_s);
    if (tid == 0) ph[0] = a, ph[1] = c, ph[2] = d;
  };
  // the first group of the first run from `item` on (this block's: item,
  // item + grid, ...) that has frames
  const auto issue_from = [&](int item) {
    for (; item < p.total; item += gridDim.x) {
      const Run u = run_of(item, p);
      if (u.t_lo <= u.t_hi) {
        issue(u.b, u.t_lo, min(G, u.t_hi - u.t_lo + 1));
        return;
      }
    }
  };

  const int half = (m + 1) >> 1;  // pre-step slots a frame
  issue_from(blockIdx.x);
  for (int item = blockIdx.x; item < p.total; item += gridDim.x) {
    const Run u = run_of(item, p);
    if (u.t_lo > u.t_hi) {  // no frame reaches the run: its sums are 0
      for (int l = tid; l < u.je * p.hop; l += nrf::THREADS) {
        const int jb = dhop.div(l);
        finish(u.b, u.ja + jb, l - jb * p.hop, 0.f);
      }
      continue;
    }
    for (int tg = u.t_lo; tg <= u.t_hi; tg += G) {
      const int ge = min(G, u.t_hi - tg + 1);
      const int nf = nrf::seg_frames(sg, plan, ge);
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();  // the slab and its phases landed; the last overlap-add done
      {
        // pre-step from the slab: slot k of frame f turns the pair (k, M -
        // k) (slot 0: 0 with Y[M], and M/2 for an even M)
        const R* sre = re_s + ph[0];
        const R* sim = im_s + ph[1];
        const unsigned* smk = mk_s + ph[2];
        for (int e = sg.lane; e < nf * half; e += plan.threads) {
          const int fl = plan.half.div(e);
          const int k = e - fl * half;
          const int f = sg.f0 + fl;
          const int base = f * m;
          const int row = f * p.n_bins;
          // Y = Z * mask at bin q of frame f, no imaginary DC or Nyquist part
          const auto Y = [&](int q) {
            const float mk = nrs::widen_raw(smk[row + q]);
            return make_float2(__fmul_rn(nrs::widen_raw(sre[row + q]), mk),
                               (q == 0 || q == m) ? 0.f
                                                  : __fmul_rn(nrs::widen_raw(sim[row + q]), mk));
          };
          float2 lo, hi;
          nrf::unsplit(Y(k), Y(k ? m - k : m), __ldg(tw + k), lo, hi);
          z[nrf::pad(base + k)] = lo;
          if (k != 0) {
            z[nrf::pad(base + m - k)] = hi;
          } else if (!(m & 1)) {
            const float2 yh = Y(m / 2);
            nrf::unsplit(yh, yh, __ldg(tw + m / 2), lo, hi);
            z[nrf::pad(base + m / 2)] = lo;
          }
        }
      }
      __syncthreads();  // every read of the slab done: the next group's lands there
      if (tg + G <= u.t_hi)
        issue(u.b, tg + G, min(G, u.t_hi - tg - G + 1));
      else
        issue_from(item + gridDim.x);

      nrf::fft_frames<true, ODD>(z, m, ge, stw, sg, plan);
      __syncthreads();  // the overlap-add reads every frame of the group

      // overlap-add into the ring: slot block jj in [tg, tg + NB), jj mod
      // NB, takes frames t in [jj - r + 1, jj] of this group, ascending;
      // y_t[u] is float u of frame t's row. Blocks below tg + G (all, after
      // the run's last group) leave the ring: finished if in the run. W
      // samples a thread at a time: 2 for an even hop, whose pairs (2l,
      // 2l + 1) share a hop block, and whose y and post pairs are float2s
      const bool last = tg + G > u.t_hi;
      const int tgm = tg % NB;
      const auto add = [&](auto width) {
        constexpr int W = decltype(width)::value;
        using V = std::conditional_t<W == 2, float2, float>;
        const V* zv = reinterpret_cast<const V*>(z);
        for (int i0 = W * tid; i0 < ring; i0 += RING_UNROLL * W * nrf::THREADS) {
#pragma unroll
          for (int k = 0; k < RING_UNROLL; ++k) {
            const int i = i0 + k * W * nrf::THREADS;
            if (i >= ring) break;
            const int slot = dhop.div(i);
            const int q = i - slot * p.hop;
            const int jj = tg + slot - tgm + (slot < tgm ? NB : 0);
            const int ta = max(tg, jj - p.r + 1);
            const int tb = min(tg + ge - 1, jj);
            V a = *reinterpret_cast<const V*>(acc + i);
            for (int t = ta; t <= tb; ++t) {
              const int uu = (jj - t) * p.hop + q;
              const int L = nrf::pad((t - tg) * m + (uu >> 1));
              if constexpr (W == 2) {  // uu even: the pair is z[L]
                const float2 w = *reinterpret_cast<const float2*>(post_s + uu);
                a = make_float2(fmaf(w.x, zv[L].x, a.x), fmaf(w.y, zv[L].y, a.y));
              } else {
                a = fmaf(post_s[uu], zv[2 * L + (uu & 1)], a);
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
      if (p.hop % 2)
        add(std::integral_constant<int, 1>());
      else
        add(std::integral_constant<int, 2>());
    }
    if (u.t_hi + p.r < u.ja + u.je) {
      // the run reaches past its last frame's reach, t_hi + r - 1: its
      // blocks past the ring of its last group tl, [tl, tl + NB), sum no
      // frame
      const int tl = u.t_lo + (u.t_hi - u.t_lo) / G * G;
      for (int l = (tl + NB - u.ja) * p.hop + tid; l < u.je * p.hop; l += nrf::THREADS) {
        const int jb = dhop.div(l);
        finish(u.b, u.ja + jb, l - jb * p.hop, 0.f);
      }
    }
  }
}

// f(kernel, Of<T>, odd) for the build of M = n_fft / 2 and planes of type
// `plane`
template <class F>
int with_real_kernel(int plane, int m, F f) {
  return planes::with_plane(plane, [&](auto tag) {
    return nrf::with_odd_primes(m, [&](auto odd) {
      return f(istft_fft_kernel<decltype(odd)::value, typename decltype(tag)::type>, tag, odd);
    });
  });
}

}  // namespace

// plane: the type of re, im and out (planes.cuh: 0 float32, 1 bfloat16);
// re/im: (rows, n_frames, n_bins); mask: the same, f32; post, wsq: (r *
// hop,) f32; env_int: (hop,) f32; tw: (n_fft,) complex f32; out: (rows,
// out_len). n_fft must be one fft_smem.cuh serves, seg_warps a segment of
// warps that holds a frame, and run * hop at most 8192 (the hop's Div is
// exact below). Launches persistent
// blocks, at most nr_istft_fft_capacity of them. Returns cudaGetLastError()
// after the launch.
extern "C" int nr_istft_fft(int plane, const void* re, const void* im, const float* mask,
                            int rows, int n_frames, int n_bins, int n_fft,
                            int seg_warps, int hop, int r, int bpad, int j0,
                            int n_out, int run, long long out_off, long long out_len,
                            long long istft_len, float env_floor,
                            const float* post, const float* wsq,
                            const float* env_int, const float* tw, void* out,
                            void* stream) {
  const int m = n_fft / 2;
  const int G = nrf::fft_block_frames(seg_warps, m);
  if (!nrf::real_kernel(n_fft) || G < 1 || run < 1 || (long long)run * hop > 8192)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_out <= 0) return (int)cudaGetLastError();
  const int n_runs = (n_out + run - 1) / run;
  const Runs p{out_off, out_len, istft_len, env_floor, n_frames, n_bins, hop, r,
               bpad,    j0,      n_out,     run,       n_runs,   rows * n_runs};
  return with_real_kernel(plane, m, [&](auto kernel, auto tag, auto odd) {
    using T = typename decltype(tag)::type;
    const size_t smem = smem_bytes<T>(m, G, n_bins, hop, r);
    // persistent: the blocks the card holds at once
    const int fit = nrs::active_blocks(kernel, smem, nrf::THREADS);
    if (fit < 0) return -fit;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(p.total < fit ? p.total : fit), nrf::THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(re), static_cast<const T*>(im), mask, p, nrf::Div<true>(hop),
        post, wsq, env_int, reinterpret_cast<const float2*>(tw), static_cast<T*>(out),
        nrf::make_plan<decltype(odd)::value != 1>(m, seg_warps));
    return (int)cudaGetLastError();
  });
}

// The persistent grid of nr_istft_fft for these arguments: the blocks of
// its build the current device holds at once; a negative CUDA error code on
// failure (invalid: an n_fft the real-FFT kernels do not take).
extern "C" int nr_istft_fft_capacity(int plane, int n_fft, int seg_warps, int n_bins, int hop,
                                     int r) {
  const int m = n_fft / 2;
  const int G = nrf::fft_block_frames(seg_warps, m);
  if (!nrf::real_kernel(n_fft) || G < 1) return -(int)cudaErrorInvalidValue;
  return with_real_kernel(plane, m, [&](auto kernel, auto tag, auto) {
    using T = typename decltype(tag)::type;
    return nrs::active_blocks(kernel, smem_bytes<T>(m, G, n_bins, hop, r), nrf::THREADS);
  });
}
