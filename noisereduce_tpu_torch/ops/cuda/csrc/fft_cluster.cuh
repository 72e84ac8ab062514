// The cluster route of kernels A and D (spectra_cluster.cu,
// istft_cluster.cu): one n-point transform of a frame slot across a thread
// block cluster, for an n with no prime factor above 13 that is past a big
// block (fft_route.cuh: n_fft 16386 to 131072; 40000 takes c = 4 blocks,
// n = 100 x 200).
//
// A four-step FFT, n = n1 n2 (cluster_shape: c divides n1 and n2), input
// point j = j1 + n1 j2, output point k = k2 + n2 k1:
//   1. Y[j1, k2] = sum_j2 x[j1 + n1 j2] w_n2^{j2 k2}: block q takes the
//      columns j1 in [q cols, (q + 1) cols), cols = n1 / c, and their
//      n2-point FFTs;
//   2. Y[j1, k2] *= w_n^{j1 k2} (conjugated for the inverse), and
//   3. the exchange: block q takes the rows k2 in [q rows, (q + 1) rows),
//      rows = n2 / c, of every column from the block that holds it
//      (cluster.map_shared_rank: distributed shared memory): one contiguous
//      run of another block's buffer each, pulled 16 bytes a thread, then
//      twiddled in step 4's first stage;
//   4. X[k2 + n2 k1] = sum_j1 Y'[j1, k2] w_n1^{j1 k1}: the n1-point FFTs of
//      its rows.
// Output point k then lies in block (k mod n2) / rows, row k mod n2 - q
// rows, point k / n2 (cluster_point).
//
// The chirp route (fft_route.cuh: ROUTE_CLUSTER_CHIRP) takes a circular
// convolution of length L = n1 n2 in that order (cluster_convolve): the
// four steps above, the product with the filter spectrum laid out in the
// order they leave it, then the unscaled inverse back to natural order,
// the n1-point inverses of the block's rows, the conjugate twiddle, an
// exchange back to columns and the n2-point inverses of the columns. Two
// exchanges a slot, one a transform; point j then lies in block (j mod
// n1) / cols, column j mod n1 - q cols, point j / n1
// (cluster_column_point).
//
// Layout: a block's batch of FFTs is interleaved, batch index fastest:
// point j2 of column col at j2 ldc + col (step 1), point j1 (then k1) of
// row r at j1 ldr + r (step 4), with ldc and ldr the batch counts made
// odd, so that a warp's consecutive threads take consecutive batches (and
// consecutive points of the signal or of a bin row: the gathers coalesce),
// and a column of the layout, read with an odd stride, meets no bank
// conflict. Each stage is a radix-R Stockham step of fft_smem.cuh (the
// same radix order, twiddle table and R-point formulas, so the same
// arithmetic) taken out of place between the block's two buffers, one
// butterfly a thread at a time: one block barrier a stage and a
// butterfly's registers only. Step 1's first stage takes its points from
// the caller's gather: the planes, the signal, or kernel A's samples that
// cp.async staged in the free buffer.
//
// Clusters are persistent: the grid holds the clusters that fit on the card
// at once (cudaOccupancyMaxActiveClusters), and cluster i takes slots i, i +
// G, i + 2G, ... (G clusters). A block's buffer that other blocks read must
// outlive their reads: a split cluster barrier (arrive after the reads,
// wait before the buffer is next written) ends the pull, and another
// kernel A's partner reads of step 4's output across slots. Blocks of
// CLUSTER_THREADS threads, two an SM where shared memory allows (64
// registers a thread; 1024 threads, one an SM, ran slower at n_fft 40000:
// PERF.md), and each build compiles only the radices of its set
// (cluster_build), so no stage carries the registers of a radix it never
// runs.
#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "fft_smem.cuh"

namespace nrf {

namespace cg = cooperative_groups;

constexpr int CLUSTER_THREADS = 512;  // threads of a cluster block

// blocks an SM may hold of a build of the odd primes `odd` (cluster_build):
// 2 (64 registers a thread) for the sets within 3, 5 and 7, 1 (128) for the
// build with radix 11 and 13
constexpr int cluster_min_blocks(int odd) { return odd % 11 ? 2 : 1; }

// The build of n's transform: the odd primes of n as they are for a set
// within {3, 5}, 105 for any other set within 3, 5 and 7, 15015 for a set
// with 11 or 13 (must match geometry.py::cluster_build)
inline int cluster_build(int n) {
  const int odd = odd_primes(n);
  if (odd % 11 == 0 || odd % 13 == 0) return 15015;
  return odd % 7 == 0 ? 105 : odd;
}

// f(std::integral_constant<int, cluster_build(n)>())
template <class F>
auto with_cluster_build(int n, F f) {
  switch (cluster_build(n)) {
    case 1: return f(std::integral_constant<int, 1>());
    case 3: return f(std::integral_constant<int, 3>());
    case 5: return f(std::integral_constant<int, 5>());
    case 15: return f(std::integral_constant<int, 15>());
    case 105: return f(std::integral_constant<int, 105>());
    default: return f(std::integral_constant<int, 15015>());
  }
}

// The same for a cluster chirp length L (2^a 3^b 5^c: the builds 1, 3, 5
// and 15 only, so no chirp build carries radix 7, 11 or 13)
template <class F>
auto with_chirp_build(int L, F f) {
  switch (cluster_build(L)) {
    case 3: return f(std::integral_constant<int, 3>());
    case 5: return f(std::integral_constant<int, 5>());
    case 15: return f(std::integral_constant<int, 15>());
    default: return f(std::integral_constant<int, 1>());
  }
}

// The shape of a launch, made on the host (make_four) and passed by value
struct Four {
  int n, n1, n2, c;        // n: the FFT's points (the chirp length L on the chirp route)
  int pts;                 // the transform's points: n, or fewer than L / 2 on the chirp route
  int cols, rows;          // n1 / c columns of n2 points, n2 / c rows of n1 points a block
  int ldc, ldr;            // cols, rows made odd: the layouts' leading dimensions
  int buffer;              // float2 values of each of a block's two buffers (even)
  int run;                 // rows ldc: a block's rows of one block's step-1 buffer
  bool wide;               // run even: the pull moves 16-byte values
  bool back_wide;          // cols ldr even: the chirp's exchange back moves 16-byte values
  Div<true> dn2, dcols, drows, dpull;  // dpull: run in the pull's values
  Div<true> dn1, dback;    // dback: cols ldr in the exchange back's values
  Plan<true> p2, p1;       // the stages of the n2- and n1-point FFTs
};

// float2 values of a buffer: step 1's n2 x ldc and step 4's n1 x ldr,
// whichever is larger, made even so that the second buffer starts on 16
// bytes (must match geometry.py::cluster_layout)
inline bool make_four(int n, Four& f) {
  f = Four{};
  if (!cluster_shape(n, f.c, f.n1, f.n2)) return false;
  f.n = n;
  f.cols = f.n1 / f.c;
  f.rows = f.n2 / f.c;
  f.ldc = f.cols | 1;
  f.ldr = f.rows | 1;
  f.buffer = f.n2 * f.ldc > f.n1 * f.ldr ? f.n2 * f.ldc : f.n1 * f.ldr;
  f.buffer += f.buffer & 1;
  f.run = f.rows * f.ldc;
  f.wide = f.run % 2 == 0;
  f.dpull = Div<true>(f.wide ? f.run / 2 : f.run);
  f.pts = n;
  const int back = f.cols * f.ldr;
  f.back_wide = back % 2 == 0;
  f.dback = Div<true>(f.back_wide ? back / 2 : back);
  f.dn1 = Div<true>(f.n1);
  f.dn2 = Div<true>(f.n2);
  f.dcols = Div<true>(f.cols);
  f.drows = Div<true>(f.rows);
  f.p2 = make_plan<true>(f.n2, 1, 1);
  f.p1 = make_plan<true>(f.n1, 1, 1);
  return true;
}

// The shape of a launch for n_fft and an FFT of slot points: on the
// cluster route (CHIRP false) n = fft_n(n_fft), on the cluster chirp route
// a chirp length (chirp_length_ok). False for any other pair.
template <bool CHIRP>
inline bool make_four_of(int n_fft, int slot, Four& f) {
  const int n = fft_n(n_fft);
  const bool ok = CHIRP ? route_of(n_fft) == ROUTE_CLUSTER_CHIRP && chirp_length_ok(n, slot)
                        : route_of(n_fft) == ROUTE_CLUSTER && slot == n;
  if (!ok || !make_four(slot, f)) return false;
  f.pts = n;
  return true;
}

// bytes of dynamic shared memory of a cluster block: its two buffers
inline size_t cluster_smem(const Four& f) { return sizeof(float2) * 2 * (size_t)f.buffer; }

// The split cluster barrier: every thread of the cluster arrives (release:
// its reads and writes of shared memory are done), then waits (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// One radix-R Stockham stage s of `pl` over nb interleaved batches (batch
// b, point i at i ld + b of dst), out of place: butterfly (b, j) loads
// load(b, j + r m/R), twiddles by tw[jm r tstep] (jm = j mod ns; the
// inverse conjugates), takes the R-point DFT and stores at
// ((j - jm) R + jm + r ns) ld + b. Consecutive threads take consecutive
// batches, one butterfly at a time (two at a time spilled and ran slower:
// PERF.md). Every thread of the block calls it; the caller synchronises.
template <int R, bool INV, class Load>
__device__ __forceinline__ void cstage(Load load, float2* __restrict__ dst, const Plan<true>& pl,
                                       int s, const Div<true>& dnb, int ld,
                                       const float2* __restrict__ tw) {
  const int ns = pl.ns[s], tstep = pl.tstep[s];
  const Div<true> dmr = pl.mr[s], dns = pl.nsd[s];
  const int mr = dmr.d, nb = dnb.d;
  const int total = nb * mr;
  for (int idx = threadIdx.x; idx < total; idx += CLUSTER_THREADS) {
    const int j = dnb.div(idx);
    const int b = idx - j * nb;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = load(b, j + r * mr);
    const int jm = j - dns.div(j) * ns;
    if (jm) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        float2 w = __ldg(tw + jm * r * tstep);
        if (INV) w.y = -w.y;
        v[r] = cmul(v[r], w);
      }
    }
    dft<R, INV>(v);
    const int d = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[(d + r * ns) * ld + b] = v[r];
  }
}

constexpr int PULL = 2;  // values a thread of the pull has in flight

// Step 3's pull: this block's rows of every column, from each block o's
// step-1 buffer `held`: rows k2 in [rank rows, (rank + 1) rows), one
// contiguous run of `run` values from rank run on, into `into` at o run
// (drun: run in V values; the chirp's exchange back pulls columns the
// same way). V: float2, or float4 (two float2) where run is even.
// Consecutive threads read consecutive values of another block's shared
// memory, PULL of them in flight a thread (4 spilled: PERF.md).
template <class V>
__device__ __forceinline__ void pull(V* into, const float2* held, cg::cluster_group& cl,
                                     const Div<true>& drun, int c, int rank) {
  const int run = drun.d;
  const int total = c * run;
  for (int e0 = threadIdx.x; e0 < total; e0 += PULL * CLUSTER_THREADS) {
    V v[PULL];
#pragma unroll
    for (int u = 0; u < PULL; ++u) {
      const int e = e0 + u * CLUSTER_THREADS;
      if (e < total) {
        const int o = drun.div(e);
        v[u] = reinterpret_cast<const V*>(cl.map_shared_rank(held, o))[rank * run + e - o * run];
      }
    }
#pragma unroll
    for (int u = 0; u < PULL; ++u)
      if (e0 + u * CLUSTER_THREADS < total) into[e0 + u * CLUSTER_THREADS] = v[u];
  }
}

// stage s of `pl` at its radix, among the radices of the build ODD
template <bool INV, int ODD, class Load>
__device__ __forceinline__ void cstage_any(Load load, float2* __restrict__ dst,
                                           const Plan<true>& pl, int s, const Div<true>& dnb,
                                           int ld, const float2* __restrict__ tw) {
  switch (pl.radix[s]) {
    case 8: cstage<8, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 4: cstage<4, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 2: cstage<2, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 3: if constexpr (ODD % 3 == 0) cstage<3, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 5: if constexpr (ODD % 5 == 0) cstage<5, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 7: if constexpr (ODD % 7 == 0) cstage<7, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 11: if constexpr (ODD % 11 == 0) cstage<11, INV>(load, dst, pl, s, dnb, ld, tw); break;
    case 13: if constexpr (ODD % 13 == 0) cstage<13, INV>(load, dst, pl, s, dnb, ld, tw); break;
  }
}

// The slot's transform (INV: the unscaled inverse) across the cluster:
// step 1's first stage takes point j2 of column col from gather(col, j2)
// (which may read b) and writes buffer a; the stages then alternate
// between a and b. Every thread of the block calls it.
// Returns the buffer that holds the block's rows of the output, point k1
// of row r at k1 ldr + r, with the block synchronised (not the cluster),
// no cluster barrier outstanding, and the other buffer free (no block
// reads it).
template <bool INV, int ODD, class Gather>
__device__ __forceinline__ float2* cluster_fft(float2* a, float2* b, cg::cluster_group& cl,
                                               const Four& f, int rank, Gather gather,
                                               const float2* __restrict__ tw1,
                                               const float2* __restrict__ tw2,
                                               const float2* __restrict__ twn) {
  cstage_any<INV, ODD>(gather, a, f.p2, 0, f.dcols, f.ldc, tw2);
  for (int s = 1; s < f.p2.n_stages; ++s) {
    __syncthreads();
    const float2* src = a;
    cstage_any<INV, ODD>([&](int col, int i) { return src[i * f.ldc + col]; }, b, f.p2, s,
                         f.dcols, f.ldc, tw2);
    float2* t = a;
    a = b;
    b = t;
  }
  cl.sync();  // every block's columns are transformed
  // step 3: this block's rows of every column, pulled into b
  if (f.wide)
    pull(reinterpret_cast<float4*>(b), a, cl, f.dpull, f.c, rank);
  else
    pull(b, a, cl, f.dpull, f.c, rank);
  cluster_arrive();  // this block's reads of the cluster's step-1 buffers are done
  cluster_wait();    // ... and every block's: a is free, b complete
  // step 2 in step 4's first stage: row r = k2 - rank rows of column j1,
  // from the run of the block that held it, times w_n^{j1 k2}
  const float2* pulled = b;
  cstage_any<INV, ODD>(
      [&](int r, int j1) {
        const int owner = f.dcols.div(j1);
        float2 t = __ldg(twn + j1 * (rank * f.rows + r));  // j1 k2 < n
        if (INV) t.y = -t.y;
        return cmul(pulled[owner * f.run + r * f.ldc + j1 - owner * f.cols], t);
      },
      a, f.p1, 0, f.drows, f.ldr, tw1);
  for (int s = 1; s < f.p1.n_stages; ++s) {
    __syncthreads();
    const float2* src = a;
    cstage_any<INV, ODD>([&](int r, int i) { return src[i * f.ldr + r]; }, b, f.p1, s,
                         f.drows, f.ldr, tw1);
    float2* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  return a;
}

// Output point k of the slot's transform, from the block of the cluster
// that holds it (buffer w of the same offset in every block)
__device__ __forceinline__ float2 cluster_point(const float2* w, cg::cluster_group& cl,
                                                const Four& f, int k) {
  const int k1 = f.dn2.div(k);
  const int k2 = k - k1 * f.n2;
  const int owner = f.drows.div(k2);
  const float2* src = cl.map_shared_rank(w, owner);
  return src[k1 * f.ldr + k2 - owner * f.rows];
}

// The chirp route's circular convolution of the slot across the cluster:
// the forward transform of gather's points (cluster_fft), each point of
// the block's rows times the filter spectrum in the order the transform
// leaves it (block q's point k1 of row r at filt[(q n1 + k1) rows + r],
// holding H[k], k = q rows + r + n2 k1; CONJ: its conjugate), in the first
// stage of the n1-point inverses of the rows; then the conjugate twiddle
// w_n^{-j1 k2} and the exchange back (block q takes the columns j1 in
// [q cols, (q + 1) cols) of every block's rows: one contiguous run of cols
// ldr values from q cols ldr on, pulled as step 3 pulls), twiddled in the
// first stage of the n2-point inverses of the columns. Every thread of the
// block calls it. Returns the buffer that holds the block's columns of
// the unscaled result in natural order, point j = j1 + n1 j2 at j2 ldc +
// j1 - q cols, with the block synchronised (not the cluster), no cluster
// barrier outstanding, and the other buffer free.
template <bool CONJ, int ODD, class Gather>
__device__ __forceinline__ float2* cluster_convolve(float2* a, float2* b, cg::cluster_group& cl,
                                                    const Four& f, int rank, Gather gather,
                                                    const float2* __restrict__ filt,
                                                    const float2* __restrict__ tw1,
                                                    const float2* __restrict__ tw2,
                                                    const float2* __restrict__ twn) {
  float2* x = cluster_fft<false, ODD>(a, b, cl, f, rank, gather, tw1, tw2, twn);
  float2* y = x == a ? b : a;  // free: no block reads it
  const float2* const h = filt + rank * f.n1 * f.rows;
  const float2* held = x;
  cstage_any<true, ODD>(
      [&](int r, int k1) {
        float2 w = __ldg(h + k1 * f.rows + r);
        if (CONJ) w.y = -w.y;
        return cmul(held[k1 * f.ldr + r], w);
      },
      y, f.p1, 0, f.drows, f.ldr, tw1);
  for (int s = 1; s < f.p1.n_stages; ++s) {
    __syncthreads();
    const float2* src = y;
    cstage_any<true, ODD>([&](int r, int i) { return src[i * f.ldr + r]; }, x, f.p1, s,
                          f.drows, f.ldr, tw1);
    float2* t = x;
    x = y;
    y = t;
  }
  cl.sync();  // every block's rows are inverted, in y
  // the exchange back: this block's columns of every block's rows, into x
  if (f.back_wide)
    pull(reinterpret_cast<float4*>(x), y, cl, f.dback, f.c, rank);
  else
    pull(x, y, cl, f.dback, f.c, rank);
  cluster_arrive();  // this block's reads of the cluster's row buffers are done
  cluster_wait();    // ... and every block's: y is free, x complete
  // column col's point k2 (row r = k2 - o rows of block o), times w_n^{-j1 k2}
  const int back = f.cols * f.ldr;
  const float2* pulled = x;
  cstage_any<true, ODD>(
      [&](int col, int k2) {
        const int owner = f.drows.div(k2);
        float2 t = __ldg(twn + (rank * f.cols + col) * k2);  // j1 k2 < n
        t.y = -t.y;
        return cmul(pulled[owner * back + col * f.ldr + k2 - owner * f.rows], t);
      },
      y, f.p2, 0, f.dcols, f.ldc, tw2);
  for (int s = 1; s < f.p2.n_stages; ++s) {
    __syncthreads();
    const float2* src = y;
    cstage_any<true, ODD>([&](int col, int i) { return src[i * f.ldc + col]; }, x, f.p2, s,
                          f.dcols, f.ldc, tw2);
    float2* t = x;
    x = y;
    y = t;
  }
  __syncthreads();
  return y;
}

// Point j of the chirp route's convolution (cluster_convolve), from the
// block of the cluster that holds it (buffer w of the same offset in
// every block)
__device__ __forceinline__ float2 cluster_column_point(const float2* w, cg::cluster_group& cl,
                                                       const Four& f, int j) {
  const int j2 = f.dn1.div(j);
  const int j1 = j - j2 * f.n1;
  const int owner = f.dcols.div(j1);
  const float2* src = cl.map_shared_rank(w, owner);
  return src[j2 * f.ldc + j1 - owner * f.cols];
}

// Clusters of c blocks of `kernel` with smem bytes of dynamic shared memory
// that the current device holds at once, cached by kernel, size and device;
// a negative CUDA error code if the query fails.
template <class K>
int active_clusters(K kernel, size_t smem, int c) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), smem, c, dev);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)c);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (n < 1) return -(int)cudaErrorInvalidConfiguration;
  known[key] = n;
  return n;
}

// Launch `kernel` as persistent clusters of f.c blocks of CLUSTER_THREADS
// with smem bytes of dynamic shared memory over `slots` slots: the
// clusters that fit at once, at most one a slot. The shared memory limit
// is set at every launch: n_fft of one build take different sizes. Returns
// the launch's error code.
template <class K, class... A>
int launch_clusters(K kernel, long long slots, size_t smem, cudaStream_t st, int c,
                    A... args) {
  const int fit = active_clusters(kernel, smem, c);
  if (fit < 0) return -fit;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long clusters = slots < fit ? slots : fit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * c));
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace nrf
