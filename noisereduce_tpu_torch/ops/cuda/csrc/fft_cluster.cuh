// The cluster route of kernels A and D (spectra_cluster.cu,
// istft_cluster.cu): one n-point transform of a frame slot across a thread
// block cluster, for an n with no prime factor above 13 that is past a big
// block (fft_route.cuh: n_fft 16386 to 131072; 40000 takes c = 4 blocks,
// n = 100 x 200).
//
// A four-step FFT, n = n1 n2 (cluster_shape: c divides n1 and n2), input
// point j = j1 + n1 j2, output point k = k2 + n2 k1:
//   1. Y[j1, k2] = sum_j2 x[j1 + n1 j2] w_n2^{j2 k2}: block q holds the
//      columns j1 in [q cols, (q + 1) cols), cols = n1 / c, as `cols` slots
//      of n2 points of its first buffer z and takes their n2-point FFTs
//      with fft_smem.cuh's stages (the whole block one segment);
//   2. Y[j1, k2] *= w_n^{j1 k2} (conjugated for the inverse), and
//   3. the exchange: after cluster.sync() block q copies the rows k2 in
//      [q rows, (q + 1) rows), rows = n2 / c, of every column from the
//      block that holds it (cluster.map_shared_rank: distributed shared
//      memory) into its second buffer w, row r = k2 - q rows at r n1,
//      twiddled on the way;
//   4. X[k2 + n2 k1] = sum_j1 Y'[j1, k2] w_n1^{j1 k1}: the n1-point FFTs of
//      its rows, in place.
// Output point k then lies in block (k mod n2) / rows, row k mod n2 - q
// rows, point k / n2 (cluster_point); the unpack of kernel A and the
// overlap-add of kernel D read it there after another cluster.sync(), and
// a last cluster.sync() keeps every block's shared memory alive until the
// cluster's reads of it are done.
//
// Each block holds n / c points in each buffer, at most a big block's
// 8192 (1024 threads, PP points a thread, as Blk<true>): two buffers of
// 8192 padded points are 139 KB. The stages are those of the complex-frame
// kernels' big build with every odd radix (ODD 15015, multiply-high Divs).
#pragma once

#include <cooperative_groups.h>

#include "fft_smem.cuh"

namespace nrf {

namespace cg = cooperative_groups;

using Cluster = Blk<true>;  // a block of the cluster route

// float2 values of one of a block's two buffers: n / c points, padded
inline int cluster_buffer(int points) { return points + points / 16 + 1; }

// The shape of a launch, made on the host (make_four) and passed by value
struct Four {
  int n, n1, n2, c;
  int cols, rows;          // n1 / c columns of n2 points, n2 / c rows of n1 points a block
  int buffer;              // float2 values of each buffer (cluster_buffer)
  Div<true> dn1, dn2, dcols, drows;
  Plan<true> p2, p1;       // the n2- and n1-point FFTs, the block one segment
};

inline bool make_four(int n, Four& f) {
  f = Four{};
  if (!cluster_shape(n, f.c, f.n1, f.n2)) return false;
  f.n = n;
  f.cols = f.n1 / f.c;
  f.rows = f.n2 / f.c;
  f.buffer = cluster_buffer(n / f.c);
  f.dn1 = Div<true>(f.n1);
  f.dn2 = Div<true>(f.n2);
  f.dcols = Div<true>(f.cols);
  f.drows = Div<true>(f.rows);
  f.p2 = make_plan<true>(f.n2, Cluster::WARPS, Cluster::WARPS);
  f.p1 = make_plan<true>(f.n1, Cluster::WARPS, Cluster::WARPS);
  return true;
}

// Steps 2 and 3: the block's rows of every column, from the block that
// holds the column, twiddled by w_n^{j1 k2} (tw: e^{-2 pi i k / n}, k < n),
// into w. Reads the cluster's first buffers: call it between two
// cluster.sync()s.
template <bool INV>
__device__ __forceinline__ void exchange(float2* w, float2* z, cg::cluster_group& cl,
                                         const Four& f, int rank,
                                         const float2* __restrict__ tw) {
  const int total = f.rows * f.n1;
  for (int e = threadIdx.x; e < total; e += Cluster::THREADS) {
    const int j1 = f.drows.div(e);  // consecutive threads: consecutive rows of a column
    const int r = e - j1 * f.rows;
    const int k2 = rank * f.rows + r;
    const int owner = f.dcols.div(j1);
    const float2* src = cl.map_shared_rank(z, owner);
    float2 t = __ldg(tw + j1 * k2);  // j1 k2 < n
    if (INV) t.y = -t.y;
    w[pad(r * f.n1 + j1)] = cmul(src[pad((j1 - owner * f.cols) * f.n2 + k2)], t);
  }
}

// Output point k of the slot's transform, from the block of the cluster
// that holds it (its second buffer w)
__device__ __forceinline__ float2 cluster_point(float2* w, cg::cluster_group& cl,
                                                const Four& f, int k) {
  const int k1 = f.dn2.div(k);
  const int k2 = k - k1 * f.n2;
  const int owner = f.drows.div(k2);
  const float2* src = cl.map_shared_rank(w, owner);
  return src[pad((k2 - owner * f.rows) * f.n1 + k1)];
}

// The slot's transform (INV: the unscaled inverse) once step 1's input
// sits in z, columns j1 in [rank cols, (rank + 1) cols), column f at f n2:
// every thread of the block calls it; z is synchronised by the caller.
// Returns with the block's rows of the output in w and the cluster
// synchronised, so that any block may read them (cluster_point).
template <bool INV>
__device__ __forceinline__ void cluster_fft(float2* z, float2* w, cg::cluster_group& cl,
                                            const Four& f, int rank,
                                            const float2* __restrict__ tw1,
                                            const float2* __restrict__ tw2,
                                            const float2* __restrict__ twn) {
  const Seg sg = segment(f.p2);
  fft_frames<INV, 15015>(z, f.n2, f.cols, tw2, sg, f.p2);
  cl.sync();
  exchange<INV>(w, z, cl, f, rank, twn);
  __syncthreads();
  fft_frames<INV, 15015>(w, f.n1, f.rows, tw1, segment(f.p1), f.p1);
  cl.sync();
}

// Launch `kernel` on grid blocks of Cluster::THREADS in clusters of f.c
// blocks with smem bytes of dynamic shared memory. Returns the launch's
// error code.
template <class K, class... A>
int launch_clusters(K kernel, long long grid, size_t smem, cudaStream_t st, int c,
                    A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(Cluster::THREADS);
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
