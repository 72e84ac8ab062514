// Shared-memory complex FFT core of kernels A and D: the real-FFT kernels
// (spectra_fft.cu, istft_fft.cu: an even N = 2M, M = 2^k 3^a 5^b 7^c) and
// the complex-frame kernels (spectra_cplx.cu, istft_cplx.cu: the rest of
// the FFT route, M or an odd N with radices 11 and 13 too, and within a
// block 17, 19, 23, 29 and 31, and the chirp-z route). fft_route.cuh says
// which n_fft takes which.
//
// A block holds up to ELEMS complex values in shared memory (a big block,
// Blk<true>, BIG_SLOTS): frame slots of m points each, slot f at logical
// index f*m, as float2 padded by one slot every 16 (pad()) against bank
// conflicts. Each segment of the block's threads (a warp, or a few warps
// together) transforms its own slots. Each stage is a radix-R Stockham
// step, in a fixed order: the power-of-two part first (R = 8 while at least
// 8 of it remain, then 4 or 2), then the 3s, 5s, 7s, 11s and 13s, then
// the large radices 17, 19, 23, 29 and 31. Up to 13 a thread loads the R
// points of a butterfly into registers, twiddles them, takes the R-point
// DFT in registers, and after a barrier stores them at the autosorted
// positions, so the output comes in natural order with no digit reversal.
// A large radix (stage_large) goes through a second buffer of the block's
// size instead: one thread a (butterfly, pair k) folds two twiddled points
// into t+_k and t-_k, and after a barrier one thread a (butterfly, output
// pair m) sums them into outputs m and R - m. The complex-frame kernels
// (big blocks included) and kernel A's real-FFT kernel run every stage out
// of place between the two buffers (fft_frames_large; the small radices by
// stage_oop, which holds no value across a barrier; A's power-of-two real
// build by its own shifted twin, spectra_fft.cu's nrf::p2); the in-place
// stage serves the real-FFT D, whose group slab leaves no room for a
// second buffer at two blocks an SM. For sub-transform size ns (the product
// of the radices before this stage) and butterfly j < m/R:
//   load   v[r] = z[j + r*m/R]
//   twiddle v[r] *= e^{-+2 pi i (j mod ns) r / (ns R)}
//   store  z'[(j - j mod ns) R + (j mod ns) + r ns] = DFT_R(v)[r]
// The twiddles come from a float32 table tw[k] = e^{-2 pi i k / (2m)}, k <
// 2m, built in float64 on the host (no fast sincos intrinsics): stage s's
// point r of butterfly j takes tw[2 q], q = (j mod ns) r m / (ns R) < m (ns
// R divides m), which every kernel lays out in shared memory once a block
// in the order the stages read it (lay_twiddles); the inverse conjugates.
// The R-point DFTs use float32 constants rounded from float64. FP32
// throughout, no tensor cores: the FFT errs by about eps log2 m.
//
// A slot of m = 1 point (n_fft 1 and 2) has no stage: its transform is
// itself, and the plan's stage loops run none (a laid twiddle table of m -
// 1 = 0 entries); m of 2 to 31 points (n_fft 3 to 63) runs the same stages
// as any other m, up to 4,096 slots a block.
//
// No index assumes a power of two: the slot, butterfly and point indices
// divide by m, m/R, ns and a frame's bin pairs through Div, a shift for a
// power of two m and a multiply-high otherwise, whose constants the host
// computes once per launch (Plan, a kernel parameter). The kernels are
// built once for each set of odd primes m can take (odd_primes; the
// complex-frame kernels group the sets with 11 or 13, build_primes, and
// beside a large radix large_build): a build holds the stages of its own
// radices only, so no kernel carries the registers of an odd radix it
// never runs (the radix-7 butterflies hold 14 complex values a thread)
// under its 40-register budget; a build with radix 11 or 13 (22 or 26
// values), or with the large radices and their second buffer, takes a
// budget of 64 (min_blocks). The large stages hold a few values a thread
// whatever R.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "fft_route.cuh"

namespace nrf {

// must match noisereduce_tpu_torch/ops/cuda/geometry.py
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// blocks an SM holds of kernel D's complex-frame builds without radix 11,
// 13 or a large radix (at most 40 registers a thread; a few spill): more
// blocks in flight hide the global loads between a block's barriers
constexpr int MIN_BLOCKS = 3;
constexpr int ELEMS = 4096;  // complex values a block holds
constexpr int PADDED = ELEMS + ELEMS / 16;  // float2 slots after pad()
constexpr int PP = ELEMS / THREADS;  // points per thread
static_assert(PP * THREADS == ELEMS && THREADS % 32 == 0, "whole warps, whole points");
static_assert(ELEMS == BLOCK_SLOTS, "fft_route.cuh's block");

// The block of a complex-frame kernel: the block above, or a big block of
// BIG_THREADS threads and BIG_SLOTS points (PP points a thread in both, so
// the stages hold the same registers) for a slot of more than ELEMS points.
constexpr int BIG_THREADS = 1024;
template <bool BIG>
struct Blk {
  static constexpr int THREADS = BIG ? BIG_THREADS : nrf::THREADS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int ELEMS = THREADS * PP;
  static constexpr int PADDED = ELEMS + ELEMS / 16;
};
static_assert(Blk<true>::ELEMS == BIG_SLOTS, "fft_route.cuh's big block");

// blocks an SM holds for a complex-frame build of kernel D: MIN_BLOCKS (40
// registers a thread), 2 (64) for a build with radix 11 or 13 or the large
// radices (whose second buffer doubles a block's shared memory), 1 (64 at
// 1024 threads) for a big block. Kernel
// A's take 2 for every block of 512 threads (PERF.md: at 64 registers A's
// chirp build ran 11% faster than at 40, D's 12% slower).
constexpr int min_blocks(int odd, bool big, bool large = false) {
  return big ? 1 : (odd % 11 && odd % 13 && !large) ? MIN_BLOCKS : 2;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// x / d for 0 <= x, d >= 1 and x * d < 2^32. MIXED: the high half of
// x * ceil(2^32 / d), which is floor(x / d) under that bound (the error
// x * (ceil - 2^32/d) / 2^32 < x / 2^32 < 1/d cannot cross an integer);
// every use here has x < 2^14 and d <= 2^14, or (the cluster route,
// fft_cluster.cuh) x < 2^17 and d <= 2^13. Otherwise d is a power of two
// and the quotient a shift. Made on the host (Plan), so a thread divides by
// a runtime divisor with one multiply-high or shift and never computes the
// constant.
template <bool MIXED>
struct Div {
  int d;
  unsigned m;  // MIXED: ceil(2^32 / d), 0 for d == 1; else log2 d
  Div() = default;
  explicit Div(int d_) : d(d_), m(0) {
    if (MIXED)
      m = d_ == 1 ? 0u : 0xFFFFFFFFu / (unsigned)d_ + 1u;
    else
      while ((1 << m) < d_) ++m;
  }
  __device__ __forceinline__ int div(int x) const {
    if constexpr (MIXED)
      return d == 1 ? x : (int)__umulhi((unsigned)x, m);
    else
      return x >> m;
  }
};

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
// a + s b
__device__ __forceinline__ float2 axpy(float2 a, float s, float2 b) {
  return make_float2(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y));
}
// a * (-i) for the forward transform, a * (+i) for the inverse
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = add(a0, a2), t1 = sub(a0, a2);
  const float2 t2 = add(a1, a3), t3 = rot<INV>(sub(a1, a3));
  a0 = add(t0, t2);
  a2 = sub(t0, t2);
  a1 = add(t1, t3);
  a3 = sub(t1, t3);
}

// The odd radices: with t+_k = v[k] + v[R-k], t-_k = v[k] - v[R-k] and
// c_k, s_k = cos, sin(2 pi k / R), output m and R - m are
//   a_m -+ i b_m,  a_m = v[0] + sum_k c_{km} t+_k,  b_m = sum_k s_{km} t-_k
// (-+ for the forward transform; the inverse swaps the signs; c and s
// indices mod R, s_{R-j} = -s_j).
template <bool INV>
__device__ __forceinline__ void dft3(float2 (&v)[3]) {
  constexpr float s1 = 0.86602540378443864676f;
  const float2 tp = add(v[1], v[2]);
  const float2 b = scale(rot<INV>(sub(v[1], v[2])), s1);
  const float2 a = axpy(v[0], -0.5f, tp);
  v[0] = add(v[0], tp);
  v[1] = add(a, b);
  v[2] = sub(a, b);
}

template <bool INV>
__device__ __forceinline__ void dft5(float2 (&v)[5]) {
  constexpr float c1 = 0.30901699437494742410f, c2 = -0.80901699437494742410f;
  constexpr float s1 = 0.95105651629515357212f, s2 = 0.58778525229247312917f;
  const float2 p1 = add(v[1], v[4]), p2 = add(v[2], v[3]);
  const float2 m1 = rot<INV>(sub(v[1], v[4])), m2 = rot<INV>(sub(v[2], v[3]));
  const float2 a1 = axpy(axpy(v[0], c1, p1), c2, p2);
  const float2 a2 = axpy(axpy(v[0], c2, p1), c1, p2);
  const float2 b1 = axpy(scale(m1, s1), s2, m2);
  const float2 b2 = axpy(scale(m1, s2), -s1, m2);
  v[0] = add(v[0], add(p1, p2));
  v[1] = add(a1, b1);
  v[4] = sub(a1, b1);
  v[2] = add(a2, b2);
  v[3] = sub(a2, b2);
}

template <bool INV>
__device__ __forceinline__ void dft7(float2 (&v)[7]) {
  constexpr float c1 = 0.62348980185873353053f, c2 = -0.22252093395631440429f,
                  c3 = -0.90096886790241912624f;
  constexpr float s1 = 0.78183148246802980871f, s2 = 0.97492791218182360702f,
                  s3 = 0.43388373911755812048f;
  const float2 p1 = add(v[1], v[6]), p2 = add(v[2], v[5]), p3 = add(v[3], v[4]);
  const float2 m1 = rot<INV>(sub(v[1], v[6])), m2 = rot<INV>(sub(v[2], v[5])),
               m3 = rot<INV>(sub(v[3], v[4]));
  const float2 a1 = axpy(axpy(axpy(v[0], c1, p1), c2, p2), c3, p3);
  const float2 a2 = axpy(axpy(axpy(v[0], c2, p1), c3, p2), c1, p3);
  const float2 a3 = axpy(axpy(axpy(v[0], c3, p1), c1, p2), c2, p3);
  const float2 b1 = axpy(axpy(scale(m1, s1), s2, m2), s3, m3);
  const float2 b2 = axpy(axpy(scale(m1, s2), -s3, m2), -s1, m3);
  const float2 b3 = axpy(axpy(scale(m1, s3), -s1, m2), s2, m3);
  v[0] = add(v[0], add(p1, add(p2, p3)));
  v[1] = add(a1, b1);
  v[6] = sub(a1, b1);
  v[2] = add(a2, b2);
  v[5] = sub(a2, b2);
  v[3] = add(a3, b3);
  v[4] = sub(a3, b3);
}

// cos and sin(2 pi j / R) for R = 11, 13 and j < R: float32 constants
// rounded from float64 (folded into the instructions: every j is a
// constant of the unrolled loops)
template <int R>
__device__ __forceinline__ float2 root(int j) {
  if constexpr (R == 11) {
    constexpr float c[11] = {
        1.0f, 0.841253532831181168862f, 0.415415013001886425529f,
        -0.142314838273285140444f, -0.654860733945285064057f, -0.95949297361449738989f,
        -0.95949297361449738989f, -0.654860733945285064057f, -0.142314838273285140444f,
        0.415415013001886425529f, 0.841253532831181168862f};
    constexpr float s[11] = {
        0.0f, 0.540640817455597582108f, 0.909631995354518371412f,
        0.989821441880932732376f, 0.755749574354258283774f, 0.281732556841429697711f,
        -0.281732556841429697711f, -0.755749574354258283774f, -0.989821441880932732376f,
        -0.909631995354518371412f, -0.540640817455597582108f};
    return make_float2(c[j], s[j]);
  } else {
    static_assert(R == 13, "radix 11 or 13");
    constexpr float c[13] = {
        1.0f, 0.8854560256532098959f, 0.568064746731155802512f,
        0.120536680255323053349f, -0.35460488704253562597f, -0.748510748171101098635f,
        -0.970941817426052027157f, -0.970941817426052027157f, -0.748510748171101098635f,
        -0.35460488704253562597f, 0.120536680255323053349f, 0.568064746731155802512f,
        0.8854560256532098959f};
    constexpr float s[13] = {
        0.0f, 0.464723172043768545656f, 0.82298386589365639458f,
        0.992708874098053992801f, 0.93501624268541482344f, 0.663122658240795202377f,
        0.239315664287557767149f, -0.239315664287557767149f, -0.663122658240795202377f,
        -0.93501624268541482344f, -0.992708874098053992801f, -0.82298386589365639458f,
        -0.464723172043768545656f};
    return make_float2(c[j], s[j]);
  }
}

// radix 11 and 13 by the odd radices' formula above, m and k in unrolled
// loops: H = R/2 pairs t+_k, t-_k, then each output pair (m, R - m)
template <int R, bool INV>
__device__ __forceinline__ void dft_odd(float2 (&v)[R]) {
  constexpr int H = R / 2;
  float2 tp[H], tm[H];
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    tp[k - 1] = add(v[k], v[R - k]);
    tm[k - 1] = rot<INV>(sub(v[k], v[R - k]));
  }
  const float2 v0 = v[0];
  float2 sum = v0;
#pragma unroll
  for (int k = 0; k < H; ++k) sum = add(sum, tp[k]);
  v[0] = sum;
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    float2 a = v0, b = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      const float2 w = root<R>((k * m) % R);
      a = axpy(a, w.x, tp[k - 1]);
      b = axpy(b, w.y, tm[k - 1]);
    }
    v[m] = add(a, b);
    v[R - m] = sub(a, b);
  }
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = add(t, v[1]);
    v[1] = sub(t, v[1]);
  } else if constexpr (R == 3) {
    dft3<INV>(v);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 5) {
    dft5<INV>(v);
  } else if constexpr (R == 7) {
    dft7<INV>(v);
  } else if constexpr (R == 11 || R == 13) {
    dft_odd<R, INV>(v);
  } else {
    static_assert(R == 8, "radix 2, 3, 4, 5, 7, 8, 11 or 13");
    constexpr float c = 0.70710678118654752440f;
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<INV>(e0, e1, e2, e3);
    dft4<INV>(o0, o1, o2, o3);
    // o_k *= W8^k, W8 = e^{-i pi/4} (conjugated for the inverse)
    o1 = INV ? make_float2(c * (o1.x - o1.y), c * (o1.x + o1.y))
             : make_float2(c * (o1.x + o1.y), c * (o1.y - o1.x));
    o2 = rot<INV>(o2);
    o3 = INV ? make_float2(-c * (o3.x + o3.y), c * (o3.x - o3.y))
             : make_float2(c * (o3.y - o3.x), -c * (o3.x + o3.y));
    v[0] = add(e0, o0);
    v[4] = sub(e0, o0);
    v[1] = add(e1, o1);
    v[5] = sub(e1, o1);
    v[2] = add(e2, o2);
    v[6] = sub(e2, o2);
    v[3] = add(e3, o3);
    v[7] = sub(e3, o3);
  }
}

// The stages of an m-point FFT and the constants of its index math, made
// once per launch on the host (make_plan) and passed by value: a kernel
// parameter, read from the constant bank. Stage s has radix radix[s] and
// sub-transform size ns[s], in fft_frames' order: the power-of-two part of
// m first (8 while at least 8 of it remain, then 4 or 2), then the 3s,
// 5s, 7s, 11s and 13s, then the 17s, 19s, 23s, 29s and 31s.
constexpr int MAX_STAGES = 12;  // m <= 8192 takes at most 9 (m = 2 x 3^8)
template <bool MIXED>
struct Plan {
  int n_stages;
  int radix[MAX_STAGES];
  int ns[MAX_STAGES];
  int tstep[MAX_STAGES];      // tw index step per (j mod ns) * r: 2 M / (ns R)
  Div<MIXED> mr[MAX_STAGES];  // M / R
  Div<MIXED> nsd[MAX_STAGES]; // ns
  Div<MIXED> m, half, warps;  // M, (M + 1) / 2, a segment's warps
  Div<MIXED> fpsd;            // fps (stage_large's items)
  int threads;                // threads of a segment
  int fps;                    // frame slots a segment owns
  int segs;                   // whole segments of a block
};

// block_warps: the block's warps (WARPS, or a big block's)
template <bool MIXED>
inline Plan<MIXED> make_plan(int m, int warps, int block_warps = WARPS) {
  Plan<MIXED> p{};
  int ns = 1;
  const auto add = [&](int r) {
    p.radix[p.n_stages] = r;
    p.ns[p.n_stages] = ns;
    p.tstep[p.n_stages] = 2 * (m / (ns * r));
    p.mr[p.n_stages] = Div<MIXED>(m / r);
    p.nsd[p.n_stages] = Div<MIXED>(ns);
    ++p.n_stages;
    ns *= r;
  };
  for (int left = m & -m; left > 1; left = (m & -m) / ns) add(left >= 8 ? 8 : left);
  for (int r : {3, 5, 7, 11, 13, 17, 19, 23, 29, 31})
    while ((m / ns) % r == 0) add(r);
  p.m = Div<MIXED>(m);
  p.half = Div<MIXED>((m + 1) / 2);
  p.warps = Div<MIXED>(warps);
  p.threads = warps * 32;
  p.fps = warps * 32 * PP / m;
  p.fpsd = Div<MIXED>(p.fps);
  p.segs = block_warps / warps;
  return p;
}

// The threads of a block split into segments of `warps` consecutive warps
// (geometry.py's fft_seg_warps: the count that fits the most frames in a
// block, the fewest warps on a tie). A segment owns fps = warps * 32 * PP / M
// whole frame slots, frames [id * fps, (id + 1) * fps), and runs their FFT
// alone, synchronising with __syncwarp (one warp) or a named barrier of its
// own. The warps past the last whole segment (WARPS mod warps of them) own
// no frame and take no segment barrier. A thread keeps three indices in
// registers; the segment's shape stays in the plan (the constant bank), so
// it costs no register under the 40-register budget.
struct Seg {
  int lane;  // thread index in the segment
  int id;    // segment index in the block
  int f0;    // the segment's first frame slot
};

template <bool MIXED>
__device__ __forceinline__ Seg segment(const Plan<MIXED>& p) {
  Seg s;
  s.id = p.warps.div(threadIdx.x >> 5);
  s.lane = threadIdx.x - s.id * p.threads;
  s.f0 = s.id * p.fps;
  return s;
}

// frames of the segment among the first n_frames of the block (none for
// the idle warps past the last whole segment)
template <bool MIXED>
__device__ __forceinline__ int seg_frames(const Seg& s, const Plan<MIXED>& p, int n_frames) {
  return s.id < p.segs ? min(max(n_frames - s.f0, 0), p.fps) : 0;
}

template <bool MIXED>
__device__ __forceinline__ void seg_sync(const Seg& s, const Plan<MIXED>& p) {
  if (p.threads == 32) {
    __syncwarp();
  } else if (s.id < p.segs) {  // named barrier 1 + id (0 is __syncthreads')
    asm volatile("bar.sync %0, %1;" ::"r"(1 + s.id), "r"(p.threads) : "memory");
  }
}

// The stages' twiddles laid out in the order their threads read them:
// stage s (sub-transform size ns, radix R) reads the twiddle of point r of
// butterfly j, tw[(j mod ns) r tstep], at r ns + (j mod ns) - 1, so the
// lanes of a warp (consecutive j) read consecutive entries; stage s's
// entries fill [ns - 1, ns R - 1), and the m - 1 entries of all stages
// follow each other. Every thread of a block of `threads` calls it, once;
// the copies of the table's values keep the stages' arithmetic bitwise.
// stage_of(v, ns, tstep) gives the stage whose entries hold v.
template <class StageOf>
__device__ __forceinline__ void lay_twiddles_by(float2* stw, const float2* __restrict__ tw, int m,
                                                int threads, StageOf stage_of) {
  for (int v = threadIdx.x + 1; v < m; v += threads) {
    int ns, tstep;
    stage_of(v, ns, tstep);
    const int r = v / ns;
    stw[v - 1] = __ldg(tw + (v - r * ns) * r * tstep);
  }
}

// lay_twiddles_by for the stages of a plan
template <bool MIXED>
__device__ __forceinline__ void lay_twiddles(float2* stw, const float2* __restrict__ tw, int m,
                                             const Plan<MIXED>& pl, int threads) {
  lay_twiddles_by(stw, tw, m, threads, [&](int v, int& ns, int& tstep) {
    int s = 0;
    while (s + 1 < pl.n_stages && pl.ns[s + 1] <= v) ++s;
    ns = pl.ns[s];
    tstep = pl.tstep[s];
  });
}

// Point r's twiddle of a butterfly with jm = j mod ns (>= 1) of a stage
// (sub-transform size ns), from the stages' laid table stw (lay_twiddles):
// the plan's tw[jm r tstep]
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ stw, int jm, int r,
                                          int ns) {
  return stw[r * ns + jm - 1];
}

// One radix-R Stockham stage over the segment's nf frames, in place: every
// thread loads its butterflies (at most P: nf * M/R <= threads * PP / R),
// then (after the segment's barrier) stores them. Called by every thread of
// the segment; stw is the stages' laid table (lay_twiddles).
template <int R, bool INV, bool MIXED>
__device__ __forceinline__ void stage(float2* z, int m, int s, int nf,
                                      const float2* __restrict__ stw, const Seg& sg,
                                      const Plan<MIXED>& pl) {
  constexpr int P = (PP + R - 1) / R;  // butterflies a thread holds at most
  const int ns = pl.ns[s];
  const Div<MIXED> dmr = pl.mr[s], dns = pl.nsd[s];
  const int mr = dmr.d;
  const int n_bfly = nf * mr;
  const int base0 = sg.f0 * m;
  float2 v[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = sg.lane + p * pl.threads;
    if (idx < n_bfly) {
      const int f = dmr.div(idx);
      const int j = idx - f * mr;
      const int base = base0 + f * m + j;
#pragma unroll
      for (int r = 0; r < R; ++r) v[p][r] = z[pad(base + r * mr)];
      const int jm = j - dns.div(j) * ns;
      if (jm) {
#pragma unroll
        for (int r = 1; r < R; ++r) {
          float2 w = twiddle(stw, jm, r, ns);
          if (INV) w.y = -w.y;
          v[p][r] = cmul(v[p][r], w);
        }
      }
      dft<R, INV>(v[p]);
    }
  }
  seg_sync(sg, pl);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = sg.lane + p * pl.threads;
    if (idx < n_bfly) {
      const int f = dmr.div(idx);
      const int j = idx - f * mr;
      const int jm = j - dns.div(j) * ns;
      const int d = base0 + f * m + (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) z[pad(d + r * ns)] = v[p][r];
    }
  }
  seg_sync(sg, pl);
}

// One stage of a large radix R (17 to 31) over the segment's nf frames,
// in place in z through the other buffer sc (the segment's share: R rows
// of nb = fps M/R values, one a butterfly). Its items are spread over all
// the segment's threads, so no lane idles on the few butterflies (M/R a
// slot) and no thread holds R values:
//   fold, item (k, b) of butterfly b = f M/R + j: row 0 the point v[0],
//     and for k = 1 .. H = R/2 rows k and H + k t+_k = v[k] + v[R-k] and
//     t-_k = v[k] - v[R-k] of the twiddled points (as stage loads them);
//   sum, item (m, b), after the segment's barrier: output 0 = v[0] + sum
//     t+_k (m = 0), or outputs m and R - m = a -+ i b, a = v[0] + sum_k
//     c_{km} t+_k, b = sum_k s_{km} t-_k (rot<INV>; k m mod R stepped by
//     m), stored at stage's autosorted positions.
// c_q, s_q = cos, sin(2 pi q / R) are the twiddle table's tw[q 2M/R]
// (conjugated: tw[k] = e^{-2 pi i k / 2M}), built in float64 on the host
// and rounded once to float32. An item's m (k) is it / nb, so a warp's
// lanes share it and read the same root. Called by every thread of the
// segment.
template <int R, bool INV, bool MIXED>
__device__ __forceinline__ void stage_large(float2* z, float2* __restrict__ sc, int m, int s,
                                            int nf, const float2* __restrict__ tw,
                                            const Seg& sg, const Plan<MIXED>& pl) {
  constexpr int H = R / 2;
  const int ns = pl.ns[s], tstep = pl.tstep[s];
  const Div<MIXED> dmr = pl.mr[s], dns = pl.nsd[s];
  const int mr = dmr.d;
  const int nb = pl.fps * mr;  // butterflies of a full segment: a scratch row
  const int items = (H + 1) * nb;
  const int base0 = sg.f0 * m;
  // R rows of nb: fps M values, contiguous from the segment's first point
  // of sc: within the span of the segment's own (padded) points, so no
  // other segment's points, which its stages may be writing to sc
  // meanwhile, share an address with them
  float2* S = sc + pad(base0);
  for (int it = sg.lane; it < items; it += pl.threads) {
    const int k = pl.fpsd.div(dmr.div(it));  // it / nb
    const int b = it - k * nb;
    const int f = dmr.div(b);
    if (f >= nf) continue;
    const int j = b - f * mr;
    const int base = base0 + f * m + j;
    if (k == 0) {
      S[b] = z[pad(base)];
      continue;
    }
    float2 lo = z[pad(base + k * mr)], hi = z[pad(base + (R - k) * mr)];
    const int jm = j - dns.div(j) * ns;
    if (jm) {
      float2 wl = __ldg(tw + jm * k * tstep), wh = __ldg(tw + jm * (R - k) * tstep);
      if (INV) wl.y = -wl.y, wh.y = -wh.y;
      lo = cmul(lo, wl);
      hi = cmul(hi, wh);
    }
    S[k * nb + b] = add(lo, hi);
    S[(H + k) * nb + b] = sub(lo, hi);
  }
  seg_sync(sg, pl);
  const int rstep = tstep * ns;  // tw index of e^{-2 pi i / R}: 2M / R
  for (int it = sg.lane; it < items; it += pl.threads) {
    const int mm = pl.fpsd.div(dmr.div(it));  // it / nb
    const int b = it - mm * nb;
    const int f = dmr.div(b);
    if (f >= nf) continue;
    const int j = b - f * mr;
    const int jm = j - dns.div(j) * ns;
    const int d = base0 + f * m + (j - jm) * R + jm;
    const float2 v0 = S[b];
    if (mm == 0) {
      float2 sum = v0;
#pragma unroll 4
      for (int k = 1; k <= H; ++k) sum = add(sum, S[k * nb + b]);
      z[pad(d)] = sum;
      continue;
    }
    float2 a = v0, bs = make_float2(0.f, 0.f);
    int q = 0;  // k mm mod R
    // 4 pairs a step: their loads in flight together, and no more live
    // values than the 64-register budget holds (all H at once spill)
#pragma unroll 4
    for (int k = 1; k <= H; ++k) {
      q += mm;
      if (q >= R) q -= R;
      const float2 w = __ldg(tw + q * rstep);  // (c_q, -s_q)
      a = axpy(a, w.x, S[k * nb + b]);
      bs = axpy(bs, -w.y, S[(H + k) * nb + b]);
    }
    bs = rot<INV>(bs);
    z[pad(d + mm * ns)] = add(a, bs);
    z[pad(d + (R - mm) * ns)] = sub(a, bs);
  }
  seg_sync(sg, pl);
}

// The M-point complex DFT (INV: the unscaled inverse) of the segment's
// frames among the first n_frames of the block, in place, natural order in
// and out, from the stages' laid table stw. The caller has synchronised the
// segment after filling its frames; they are synchronised on return.
template <bool INV, int ODD>
__device__ __forceinline__ void fft_frames(float2* z, int m, int n_frames,
                                           const float2* __restrict__ stw, const Seg& sg,
                                           const Plan<ODD != 1>& pl) {
  constexpr bool MIXED = ODD != 1;
  const int nf = seg_frames(sg, pl, n_frames);
  for (int s = 0; s < pl.n_stages; ++s) {
    switch (pl.radix[s]) {
      case 8: stage<8, INV, MIXED>(z, m, s, nf, stw, sg, pl); break;
      case 4: stage<4, INV, MIXED>(z, m, s, nf, stw, sg, pl); break;
      case 2: stage<2, INV, MIXED>(z, m, s, nf, stw, sg, pl); break;
      case 3: if constexpr (ODD % 3 == 0) stage<3, INV, true>(z, m, s, nf, stw, sg, pl); break;
      case 5: if constexpr (ODD % 5 == 0) stage<5, INV, true>(z, m, s, nf, stw, sg, pl); break;
      case 7: if constexpr (ODD % 7 == 0) stage<7, INV, true>(z, m, s, nf, stw, sg, pl); break;
      case 11: if constexpr (ODD % 11 == 0) stage<11, INV, true>(z, m, s, nf, stw, sg, pl); break;
      case 13: if constexpr (ODD % 13 == 0) stage<13, INV, true>(z, m, s, nf, stw, sg, pl); break;
    }
  }
}

// One radix-R Stockham stage as stage computes it, out of place, src to
// dst: each thread stores a butterfly's outputs as soon as it has them, so
// no values are held across a barrier (stage's, at 64 registers, spill).
template <int R, bool INV>
__device__ __forceinline__ void stage_oop(const float2* __restrict__ src,
                                          float2* __restrict__ dst, int m, int s, int nf,
                                          const float2* __restrict__ stw, const Seg& sg,
                                          const Plan<true>& pl) {
  const int ns = pl.ns[s];
  const Div<true> dmr = pl.mr[s], dns = pl.nsd[s];
  const int mr = dmr.d;
  const int n_bfly = nf * mr;
  const int base0 = sg.f0 * m;
  for (int idx = sg.lane; idx < n_bfly; idx += pl.threads) {
    const int f = dmr.div(idx);
    const int j = idx - f * mr;
    const int base = base0 + f * m + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[pad(base + r * mr)];
    const int jm = j - dns.div(j) * ns;
    if (jm) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        float2 w = twiddle(stw, jm, r, ns);
        if (INV) w.y = -w.y;
        v[r] = cmul(v[r], w);
      }
    }
    dft<R, INV>(v);
    const int d = base0 + f * m + (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad(d + r * ns)] = v[r];
  }
  seg_sync(sg, pl);
}

// fft_frames out of place (the complex-frame kernels, A's real-FFT
// kernel): the same stages in the same order, the small radices' from one
// of z and the scratch sc (a block's PADDED values) to the other, reading
// the stages' laid table stw, a large radix's stage_large folding into the
// other buffer and summing back, its roots from the plan's table twh
// (LARGE: a build whose m may have one; the others leave them out).
// Returns the buffer that holds the result (z or sc).
template <bool INV, int ODD, bool LARGE = true>
__device__ __forceinline__ float2* fft_frames_large(float2* z, float2* sc, int m, int n_frames,
                                                    const float2* __restrict__ stw,
                                                    const Seg& sg, const Plan<true>& pl,
                                                    const float2* __restrict__ twh = nullptr) {
  const int nf = seg_frames(sg, pl, n_frames);
  float2* cur = z;
  float2* other = sc;
  for (int s = 0; s < pl.n_stages; ++s) {
    const int r = pl.radix[s];
    switch (r) {
      case 17: if constexpr (LARGE) stage_large<17, INV, true>(cur, other, m, s, nf, twh, sg, pl); continue;
      case 19: if constexpr (LARGE) stage_large<19, INV, true>(cur, other, m, s, nf, twh, sg, pl); continue;
      case 23: if constexpr (LARGE) stage_large<23, INV, true>(cur, other, m, s, nf, twh, sg, pl); continue;
      case 29: if constexpr (LARGE) stage_large<29, INV, true>(cur, other, m, s, nf, twh, sg, pl); continue;
      case 31: if constexpr (LARGE) stage_large<31, INV, true>(cur, other, m, s, nf, twh, sg, pl); continue;
      case 8: stage_oop<8, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 4: stage_oop<4, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 2: stage_oop<2, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 3: if constexpr (ODD % 3 == 0) stage_oop<3, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 5: if constexpr (ODD % 5 == 0) stage_oop<5, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 7: if constexpr (ODD % 7 == 0) stage_oop<7, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 11: if constexpr (ODD % 11 == 0) stage_oop<11, INV>(cur, other, m, s, nf, stw, sg, pl); break;
      case 13: if constexpr (ODD % 13 == 0) stage_oop<13, INV>(cur, other, m, s, nf, stw, sg, pl); break;
    }
    float2* t = cur;  // a small radix's stage: the result in the other buffer
    cur = other;
    other = t;
  }
  return cur;
}

// The product of the distinct odd primes of m, 1 for a power of two.
inline int odd_primes(int m) {
  int odd = 1;
  for (int p : {3, 5, 7, 11, 13})
    if (m % p == 0) odd *= p;
  return odd;
}

// f(std::integral_constant<int, odd_primes(m)>()): the real-FFT kernels'
// pick of the build for M, one for each of the 8 sets of 3, 5 and 7
// (real_kernel: no M with 11 or 13 reaches them)
template <class F>
auto with_odd_primes(int m, F f) {
  switch (odd_primes(m)) {
    case 3: return f(std::integral_constant<int, 3>());
    case 5: return f(std::integral_constant<int, 5>());
    case 7: return f(std::integral_constant<int, 7>());
    case 15: return f(std::integral_constant<int, 15>());
    case 21: return f(std::integral_constant<int, 21>());
    case 35: return f(std::integral_constant<int, 35>());
    case 105: return f(std::integral_constant<int, 105>());
    default: return f(std::integral_constant<int, 1>());
  }
}

// Whether m has a large prime factor (17, 19, 23, 29 or 31): the
// complex-frame kernels' LARGE builds, which run stage_large.
inline bool large_primes(int m) {
  for (int p : {17, 19, 23, 29, 31})
    if (m % p == 0) return true;
  return false;
}

// The small odd primes' build beside the large radices: 1 (the
// power-of-two stages alone, m = 551 = 19 x 29 at n_fft 1102), 15 for a
// set within 3 and 5, 105 for one with 7 and 15015 for one with 11 or 13:
// the largest small radix sets the registers (radix 8, 3 and 5 hold 8-10
// values a thread, 7 14, 11 and 13 22-26), and each larger set adds none.
inline int large_build(int odd) {
  if (odd % 11 == 0 || odd % 13 == 0) return 15015;
  if (odd % 7 == 0) return 105;
  return odd == 1 ? 1 : 15;
}

// The complex-frame kernels' build of a set of odd primes: the set itself
// within 3, 5 and 7; a set with 11 or 13 takes 3 x 5 x 7 x 11 (1155), x 13
// (1365) or both (15015), three builds in place of 24: the radix-11 or -13
// butterfly sets their registers, and the smaller radices add none.
inline int build_primes(int odd) {
  if (odd % 11 && odd % 13) return odd;
  return 105 * (odd % 11 ? 1 : 11) * (odd % 13 ? 1 : 13);
}

// g(std::integral_constant<int, odd>()) for odd among SETS, else an
// invalid-value error
template <int... SETS, class G>
int with_set(int odd, G g) {
  int out = (int)cudaErrorInvalidValue;
  (void)((odd == SETS && ((out = g(std::integral_constant<int, SETS>())), true)) || ...);
  return out;
}

// f(ODD, PAIRED, CHIRP, BIG, LARGE) as integral constants: the
// complex-frame kernels' build for n_fft with frame slots of `slot` points
// (fft_n(n_fft) on the FFT route, the chirp length on the chirp route; the
// caller has checked the pair). PAIRED: an odd n_fft, two frames a slot;
// BIG: a slot past ELEMS; LARGE: a slot with a prime factor from 17 to 31
// (within ELEMS), its small odd primes' build by large_build. The builds:
// one for each set of build_primes a slot takes (a chirp length 2^a or
// 2^a 3^b, an odd n_fft one with an odd prime or none, n_fft 1's single
// point, an even n_fft one with 11 or 13), one for each large_build beside
// the large radices, and in a big
// block a chirp length of 8192, or a slot on the FFT route (4097 to 8191
// points with no cluster shape, so none a multiple of 4: the rest take the
// cluster route), odd or even, with all five odd radices.
template <class F>
int with_cplx_build(int n_fft, int slot, F f) {
  using Y = std::true_type;
  using N = std::false_type;
  using std::integral_constant;
  const bool paired = n_fft % 2, chirp = slot != fft_n(n_fft), big = slot > ELEMS;
  const int odd = build_primes(odd_primes(slot));
  if (big) {
    if (!chirp)
      return paired ? f(integral_constant<int, 15015>(), Y(), N(), Y(), N())
                    : f(integral_constant<int, 15015>(), N(), N(), Y(), N());
    return paired ? f(integral_constant<int, 1>(), Y(), Y(), Y(), N())
                  : f(integral_constant<int, 1>(), N(), Y(), Y(), N());
  }
  const auto build = [&](auto pr, auto ch, auto lg) {
    return [&f, pr, ch, lg](auto o) { return f(o, pr, ch, N(), lg); };
  };
  if (chirp) return paired ? with_set<1, 3>(odd, build(Y(), Y(), N())) : with_set<1, 3>(odd, build(N(), Y(), N()));
  if (large_primes(slot)) {
    const int lo = large_build(odd_primes(slot));
    return paired ? with_set<1, 15, 105, 15015>(lo, build(Y(), N(), Y()))
                  : with_set<1, 15, 105, 15015>(lo, build(N(), N(), Y()));
  }
  if (paired) return with_set<1, 3, 5, 7, 15, 21, 35, 105, 1155, 1365, 15015>(odd, build(Y(), N(), N()));
  return with_set<1155, 1365, 15015>(odd, build(N(), N(), N()));
}

// Whether the complex-frame kernels take n_fft with slots of `slot`
// points: on the FFT route a slot of fft_n(n_fft) points (not the real
// kernels' n_fft), on the chirp route a valid chirp length.
inline bool cplx_slot_ok(int n_fft, int slot) {
  const Route r = route_of(n_fft);
  const int n = fft_n(n_fft);
  if (r == ROUTE_FFT) return slot == n && !real_kernel(n_fft);
  return r == ROUTE_CHIRP && chirp_length_ok(n, slot);
}

// frame slots of m points a block of block_warps warps holds with segments
// of `warps` warps, or 0 if a segment cannot hold one slot or, for a power
// of two m (whose Divs shift), `warps` is not a power of two
inline int fft_block_frames(int warps, int m, int block_warps = WARPS) {
  if (warps < 1 || warps > block_warps || (!(m & (m - 1)) && (warps & (warps - 1)))) return 0;
  return (block_warps / warps) * (warps * 32 * PP / m);
}

// Kernel A's real-FFT unpack. With E = (Z[k] + conj Z[M-k]) / 2 and O = -i
// (Z[k] - conj Z[M-k]) / 2 (the spectra of the even and odd samples) and w
// = e^{-2 pi i k/N}: X[k] = E + w O and X[M-k] = conj(E - w O).
__device__ __forceinline__ void split(float2 zk, float2 zm, float2 w, float2& lo,
                                      float2& hi) {
  const float2 ev = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 od = make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x));
  const float2 wo = cmul(w, od);
  lo = add(ev, wo);
  hi = conj(sub(ev, wo));
}

// Kernel D's real-FFT pre-step. With S = Y[k] + conj Y[M-k], D = Y[k] -
// conj Y[M-k], v = conj w = e^{2 pi i k/N} and t = i v D: Z'[k] = (S + t) /
// 2, Z'[M-k] = conj(S - t) / 2.
__device__ __forceinline__ void unsplit(float2 yk, float2 ym, float2 w, float2& lo,
                                        float2& hi) {
  const float2 s = make_float2(yk.x + ym.x, yk.y - ym.y);
  const float2 vd = cmul(conj(w), make_float2(yk.x - ym.x, yk.y + ym.y));
  const float2 t = make_float2(-vd.y, vd.x);
  lo = scale(add(s, t), 0.5f);
  hi = scale(conj(sub(s, t)), 0.5f);
}

}  // namespace nrf
