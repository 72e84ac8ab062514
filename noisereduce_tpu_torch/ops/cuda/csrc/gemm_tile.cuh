// Tiled FP32 matrix product core shared by kernels A (spectra) and
// D (istft_ola) on their product route, which serves only the n_fft that
// neither the FFT nor the chirp-z route takes (fft_route.cuh: below 64,
// above 8192, an odd n_fft above 4096 with a prime factor above 13).
//
// Both kernels are implicit products C = A @ B: A is never materialized
// (kernel A reads frames straight from the signal, kernel D reads masked
// spectra rows of r neighbouring frames), B is a dense constant table in
// device memory (the windowed DFT / inverse-DFT basis, a few MB, resident in
// the 50 MB L2). The core is the plain shared-memory tiling: a 256-thread
// block computes a BM x BN tile of C in BK-deep steps, each thread an 8 x 8
// register tile. Accumulation is FP32 FMA throughout; no tensor cores (the
// TF32 question per dot site is open, ROADMAP.md).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace nrt {

// must match noisereduce_tpu_torch/ops/cuda/geometry.py
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;

// One BM x BN tile of C = A @ B at (m0, n0).
//
// Loader: ``Row row(int m)`` precomputes what row m needs (called once per
// thread; m may be >= M), ``float at(const Row&, int k)`` returns A[m, k]
// (zero outside A). B: row-major (K x ldb), K a multiple of BK, ldb a
// multiple of BN, zero padded. Epilogue: ``operator()(int m, int n, float)``
// stores one element and itself discards m >= M or padded columns.
//
// Thread (ty, tx) of the 16 x 16 grid owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4, so the float4 reads of a
// k-row of As are warp broadcasts and those of Bs are conflict free.
template <class Loader, class Epilogue>
__device__ __forceinline__ void gemm_tile(const Loader& ld,
                                          const float* __restrict__ btab,
                                          int ldb, int K, int m0, int n0,
                                          const Epilogue& epi) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // A tile: thread loads row a_row, k = a_k .. a_k + 3
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  // B tile: thread loads k-row b_row, columns b_col .. b_col + 3
  const int b_row = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const typename Loader::Row row = ld.row(m0 + a_row);
  const float* bptr = btab + (size_t)b_row * ldb + n0 + b_col;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = ld.at(row, k0 + a_k + i);
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) =
        __ldg(reinterpret_cast<const float4*>(bptr + (size_t)k0 * ldb));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      epi(m, n, acc[i][j]);
    }
  }
}

}  // namespace nrt
