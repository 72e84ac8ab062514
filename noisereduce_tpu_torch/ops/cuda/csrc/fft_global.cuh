// The global chirp route of kernels A and D (spectra_global.cu,
// istft_global.cu): the transform of a frame slot of n points for an n past
// CHIRP_MAX_N points that the cluster route does not take (fft_route.cuh:
// ROUTE_GLOBAL_CHIRP; n_fft 40005, 65538, 144000, 192000, ...), as the
// chirp-z convolution of the cluster chirp route (fft_cluster.cuh::
// cluster_convolve) over a length L = L1 L2 >= 2n - 1 whose factors each
// fit a block (global_split). A cluster holds at most 8 big blocks, so no
// cluster FFT takes such an L; here the exchange between the four-step
// FFT's passes goes through a float2 scratch in device memory instead of
// distributed shared memory, and nothing bounds L but the two factors.
//
// Input point j = j2 + L2 j1 (column j2 < L2, its point j1 < L1), output
// point k = k1 + L1 k2 (row k1 < L1, its point k2 < L2), each slot's
// scratch L values, row k1 at k1 L2 (rows contiguous):
//   pass 1, columns: a block takes a tile of tc adjacent columns
//     [c0, c0 + tc) and their points from the caller's gather
//     (consecutive threads on consecutive columns: consecutive samples,
//     bins or chirp values), runs the L1-point FFTs and writes each point
//     k1 of column j2 times w_L^{j2 k1} to the scratch at k1 L2 + j2, the
//     twiddle from a table in that same layout (both reads and writes
//     contiguous runs of a tile);
//   pass 2, rows (global_rows_kernel): a block copies rb whole rows in
//     (contiguous), runs the L2-point FFTs, multiplies each point by the
//     filter spectrum H[k1 + L1 k2] from the host's table laid out in this
//     pass's order (rb rows interleaved, so its reads coalesce), runs the
//     unscaled L2-point inverses and copies the rows back: the forward
//     transform's second half and the inverse's first half in one round
//     trip of the scratch;
//   pass 3, columns again: the same tiles read column j2's points k1
//     times w_L^{-j2 k1} and run the unscaled L1-point inverses; the
//     result's point j2 + L2 j1 goes to the caller's emit.
// Every stage is fft_cluster.cuh's cstage (the radix-R Stockham step of
// fft_smem.cuh out of place between a block's two buffers, batch index
// fastest at an odd leading dimension, one butterfly a thread at a time),
// so the arithmetic is the cluster routes'; a build compiles the radices of
// L's odd primes only (with_chirp_build: 1, 3, 5 or 15).
//
// The passes run over a group of slots at a time, one launch of each pass a
// group (the wrapper's group, geometry.py::global_group): every slot while
// the scratch stays within a bound of device memory. Groups whose scratch
// stayed in the card's 50 MB L2 ran 13-20% slower at n_fft 40005 on 960 s
// than one launch over every slot (PERF.md): their round trips hit L2, but
// 4 launches a group each end on a partial wave. Persistent blocks walking
// each launch's items, as many as the card holds, ran kernel A's passes
// 10-17% slower at 40005 on 960 s and in L2 groups gained 1.5% (PERF.md):
// one block an item. By launch, kernel A at
// 40005 on 960 s spends 2.82 ms in pass 1, 3.35 in pass 2, 2.33 in pass 3
// and 0.73 in its unpack, against 0.63, 1.25, 0.94 and 0.19 ms for their
// bytes at 3.35 TB/s: the passes' stages and barriers bound them, not the
// scratch.
#pragma once

#include "fft_cluster.cuh"

namespace nrf {

constexpr int GLOBAL_THREADS = CLUSTER_THREADS;  // threads of a block: cstage's stride
constexpr int GLOBAL_ELEMS = BLOCK_SLOTS;        // points a block's tile or rows hold at most

// The shape of a launch, made on the host (make_glob) and passed by value
struct Glob {
  int n;             // the transform's points (fft_n)
  int L, L1, L2;     // the chirp length and its split
  int tc, ldt;       // columns of a tile (GLOBAL_ELEMS / L1, at most L2), made odd
  int tiles;         // tiles of a slot
  int rb, ldr;       // rows of a row block (GLOBAL_ELEMS / L2, at most L1), made odd
  int row_blocks;    // row blocks of a slot
  int buffer;        // float2 values of each of a block's two buffers (even)
  Div<true> dtc, drb, dl2;
  Plan<true> p1, p2;  // the L1- and L2-point FFTs
};

// The shape for n_fft and a chirp length L of the global chirp route
// (must match geometry.py::global_shape); false for any other pair.
inline bool make_glob(int n_fft, int L, Glob& g) {
  g = Glob{};
  const int n = fft_n(n_fft);
  if (route_of(n_fft) != ROUTE_GLOBAL_CHIRP || !chirp_length_ok(n, L)) return false;
  global_split(L, g.L1, g.L2);
  g.n = n;
  g.L = L;
  g.tc = GLOBAL_ELEMS / g.L1 < g.L2 ? GLOBAL_ELEMS / g.L1 : g.L2;
  g.ldt = g.tc | 1;
  g.tiles = (g.L2 + g.tc - 1) / g.tc;
  g.rb = GLOBAL_ELEMS / g.L2 < g.L1 ? GLOBAL_ELEMS / g.L2 : g.L1;
  g.ldr = g.rb | 1;
  g.row_blocks = (g.L1 + g.rb - 1) / g.rb;
  g.buffer = g.L1 * g.ldt > g.L2 * g.ldr ? g.L1 * g.ldt : g.L2 * g.ldr;
  g.buffer += g.buffer & 1;
  g.dtc = Div<true>(g.tc);
  g.drb = Div<true>(g.rb);
  g.dl2 = Div<true>(g.L2);
  // a segment of warps holding at least one slot, so that the plan's slot
  // counts are whole (cstage reads only its stages)
  g.p1 = make_plan<true>(g.L1, (g.L1 + 255) / 256, (g.L1 + 255) / 256);
  g.p2 = make_plan<true>(g.L2, (g.L2 + 255) / 256, (g.L2 + 255) / 256);
  return true;
}

// bytes of dynamic shared memory of a block of any pass: its two buffers
inline size_t global_smem(const Glob& g) { return sizeof(float2) * 2 * (size_t)g.buffer; }

// A block's FFTs of nb interleaved batches (point i of batch b at i ld + b):
// the first stage loads first(b, i) and writes dst, the stages then
// alternate between dst and spare. Every thread of the block calls it.
// Returns the buffer that holds the result, with the block synchronised
// and the other buffer free.
template <bool INV, int ODD, class Load>
__device__ __forceinline__ float2* block_fft(float2* dst, float2* spare, Load first,
                                             const Plan<true>& p, const Div<true>& dnb, int ld,
                                             const float2* __restrict__ tw) {
  cstage_any<INV, ODD>(first, dst, p, 0, dnb, ld, tw);
  for (int s = 1; s < p.n_stages; ++s) {
    __syncthreads();
    const float2* src = dst;
    cstage_any<INV, ODD>([&](int b, int i) { return src[i * ld + b]; }, spare, p, s, dnb, ld,
                         tw);
    float2* t = dst;
    dst = spare;
    spare = t;
  }
  __syncthreads();
  return dst;
}

// Pass 1 of a block's tile [c0, c0 + tc): gather(col, j1) gives point j1 of
// column c0 + col (zero for a column past L2: the caller's); each point k1
// of a column j2 < L2 goes to rows[k1 L2 + j2] times twl[k1 L2 + j2] =
// w_L^{j2 k1}.
template <int ODD, class Gather>
__device__ __forceinline__ void global_columns(float2* a, float2* b, const Glob& g, int c0,
                                               Gather gather, const float2* __restrict__ tw1,
                                               const float2* __restrict__ twl,
                                               float2* __restrict__ rows) {
  const float2* y = block_fft<false, ODD>(a, b, gather, g.p1, g.dtc, g.ldt, tw1);
  const int cols = min(g.tc, g.L2 - c0);
  for (int e = threadIdx.x; e < g.L1 * g.tc; e += GLOBAL_THREADS) {
    const int k1 = g.dtc.div(e);
    const int col = e - k1 * g.tc;
    if (col < cols) {
      const int at = k1 * g.L2 + c0 + col;
      rows[at] = cmul(y[k1 * g.ldt + col], __ldg(twl + at));
    }
  }
}

// Pass 3 of a block's tile [c0, c0 + tc): column j2's points k1 from
// rows[k1 L2 + j2] times conj twl[k1 L2 + j2], the unscaled L1-point
// inverses, and emit(j, v) for each point j = j2 + L2 j1 of the result
// (j2 < L2), consecutive threads on consecutive j2. The emit may write the
// addresses this block read (the same set: j2 + L2 m, m < L1); no other
// block reads them.
template <int ODD, class Emit>
__device__ __forceinline__ void global_columns_inverse(float2* a, float2* b, const Glob& g,
                                                       int c0, const float2* rows,
                                                       const float2* __restrict__ tw1,
                                                       const float2* __restrict__ twl,
                                                       Emit emit) {
  const int cols = min(g.tc, g.L2 - c0);
  const float2* y = block_fft<true, ODD>(
      a, b,
      [&](int col, int k1) {
        if (col >= cols) return make_float2(0.f, 0.f);
        const int at = k1 * g.L2 + c0 + col;
        return cmul(rows[at], conj(__ldg(twl + at)));
      },
      g.p1, g.dtc, g.ldt, tw1);
  for (int e = threadIdx.x; e < g.L1 * g.tc; e += GLOBAL_THREADS) {
    const int j1 = g.dtc.div(e);
    const int col = e - j1 * g.tc;
    if (col < cols) emit(c0 + col + g.L2 * j1, y[j1 * g.ldt + col]);
  }
}

}  // namespace nrf

namespace {

// Pass 2: block (s, q) of a launch takes rows [q rb, (q + 1) rb) of slot
// s's scratch (the group's slot s at scratch + s L), its L2-point FFTs,
// the product with filt (the host's filter spectrum FFT_L(h) / L laid out
// in this pass's order: row block q's point k2 of row r at (q L2 + k2) rb
// + r holds H[q rb + r + L1 k2], zero past L1; CONJ: its conjugate, kernel
// D's), the unscaled L2-point inverses, back in place. Three blocks an SM
// where shared memory allows (40 registers a thread, where two blocks took
// 56-59): the stages of two blocks left the SM short of warps to switch
// to, and a third ran kernels A and D 2.3-5.3% faster at n_fft 40005 on
// 960 s, 65538 and 192000, though the builds with radix 3 spill 44 B
// (PERF.md); the column passes at three ran D 8% slower at 192000.
template <bool CONJ, int ODD>
__global__ void __launch_bounds__(nrf::GLOBAL_THREADS, 3)
    global_rows_kernel(float2* __restrict__ scratch, const float2* __restrict__ filt,
                       const float2* __restrict__ tw2, const nrf::Glob g) {
  extern __shared__ __align__(16) float2 smem2[];
  float2* const a = smem2;
  float2* const b = smem2 + g.buffer;
  const int s = blockIdx.x / g.row_blocks;
  const int q = blockIdx.x - s * g.row_blocks;
  const int nr = min(g.rb, g.L1 - q * g.rb);
  float2* const rows = scratch + (long long)s * g.L + (long long)q * g.rb * g.L2;
  // the block's rows, point j2 of row r at j2 ldr + r (zero past L1)
  for (int e = threadIdx.x; e < g.rb * g.L2; e += nrf::GLOBAL_THREADS) {
    const int r = g.dl2.div(e);
    b[(e - r * g.L2) * g.ldr + r] = r < nr ? rows[e] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* staged = b;
  float2* x = nrf::block_fft<false, ODD>(
      a, b, [&](int r, int j2) { return staged[j2 * g.ldr + r]; }, g.p2, g.drb, g.ldr, tw2);
  const float2* held = x;
  const float2* const h = filt + (long long)q * g.L2 * g.rb;
  const float2* v = nrf::block_fft<true, ODD>(
      x == a ? b : a, x,
      [&](int r, int k2) {
        float2 w = __ldg(h + k2 * g.rb + r);
        if (CONJ) w.y = -w.y;
        return nrf::cmul(held[k2 * g.ldr + r], w);
      },
      g.p2, g.drb, g.ldr, tw2);
  for (int e = threadIdx.x; e < nr * g.L2; e += nrf::GLOBAL_THREADS) {
    const int r = g.dl2.div(e);
    rows[e] = v[(e - r * g.L2) * g.ldr + r];
  }
}

// Launch kernel over `blocks` blocks of GLOBAL_THREADS with smem bytes of
// dynamic shared memory on st; returns the launch's error code.
template <class K, class... A>
int launch_global(K kernel, long long blocks, size_t smem, cudaStream_t st, A... args) {
  if (blocks < 1) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, nrf::GLOBAL_THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// Set the dynamic shared memory limit of each kernel to smem bytes (n_fft
// of one build take different sizes); the first error, or 0.
template <class... K>
int global_smem_limit(size_t smem, K... kernels) {
  int err = 0;
  (void)((err = (int)cudaFuncSetAttribute(kernels, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem),
          err == 0) &&
         ...);
  return err;
}

}  // namespace
