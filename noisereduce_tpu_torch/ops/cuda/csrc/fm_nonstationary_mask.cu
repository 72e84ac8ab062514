// Kernel G: fm_nonstationary_mask — filtfilt noise floor and sigmoid mask
// of a frequency-major spectrogram, no time smoothing.
//
// Replaces: noisereduce_tpu/ops/pallas_mask.py::_mask_kernel (:84-149),
// launched by ::_fused_mask_cvjp (pallas_call at :229).
//
// Per column (row, bin) of a (rows, n_bins, n_frames) plane, time
// contiguous:
//   |Z|[t]  = sqrt(re^2 + im^2)   (interleaved complex64), or the input
//             itself (a float32 magnitude plane)
//   y[0] = |Z|[0],      y[t] = b |Z|[t] + (1-b) y[t-1]      (forward)
//   w[T-1] = y[T-1],    w[t] = b y[t] + (1-b) w[t+1]         (backward)
//   mask[t] = sigmoid(((|Z|[t] - w[t]) / w'[t] - thresh) * slope),
//             w' = w with zeros replaced by 1 (silence gives finite values)
// The carries y and w are doubles, as in kernel B: a float carry takes about
// 1/b roundings into each value. y is rounded to float once before the
// backward walk.
//
// Bound on this card: bytes. A handful of FLOPs per element; the function
// reads Z once (8 B a cell, 4 B for a magnitude plane) and writes the mask
// once (4 B): 12 B a cell, 1.22 GB at 77 x 513 x 2,579.
//
// Design. A column is contiguous in time, so a block stages a stretch of
// frames of its columns into shared memory as |Z|, in 16-byte loads along
// time (coalesced), and then every thread walks a region of lane_len
// consecutive frames of one column there. The recurrences are linear, so
// regions combine as kernel B's segments do (nonstationary_mask.cu): with
// a = 1 - b, a region of n frames maps the y carried into it to y at its
// end, y -> a^n y + yl, and gives w[r0] = a^n w[r1] + R(n) y[r0 - 1] + wl,
// R(n) = b a sum_{j<n} a^(2j), where yl and wl are the region's own
// recurrences from zero carries (wl summed forward as sum b a^u yl[u]).
// These affine maps compose: the 32 x W lanes of a column (W warps) scan
// them with warp shuffles, forward for y and backward for w, the warps'
// aggregates through shared memory, all in double. So every lane gets the
// exact y before its region and w after it, and no partials go to device
// memory. Each lane then walks its region forward for y, rounded to float
// into a second shared-memory plane, and backward for w, which it writes
// over y. Regions are odd, so the 32 lanes of a warp read 32 different
// banks. Last, all threads turn |Z| and w into the mask four frames at a
// time, off the serial walks, its divisions on the IEEE fast path
// (time_tiles.cuh, the same bits), and write it out in 16-byte stores.
// Every thread walks; no warp waits while another walks. No atomics: two
// calls give the same bits.
//
// Two routes (geometry.py::fm_mask_plan):
//  - resident, one launch: a block holds `cols` whole columns (8, 4, 2 or
//    1; 8 / cols warps a column), as many as keep a region within 16
//    frames, one column past 4,096 frames. Z is read once and the mask
//    written once: the bound's 12 B a cell. At the row-6 cell (2,579
//    frames) a block is one column, regions of 11 frames, 20.9 KB of
//    shared memory, and eight blocks share an SM (at most 32 registers).
//    Short columns share a block: 256 x 257 columns of 501 frames, 4 a
//    block, take 0.211 ms on an H100 against 0.482 at one a block (PERF.md).
//  - tiled, three launches, for a column too long to hold (past 29,020
//    frames): a block takes a tile of 256 regions of 15 frames of one
//    column.
//    1. partials: each tile from zero carries, its y at the end and w at
//       the start, to a (2, tiles, columns) double buffer;
//    2. carries: a thread per column composes them in order into the exact
//       y before and w after each tile (host constants a^n, R(n) of a tile);
//    3. final: each tile staged again, scanned from its exact carries, and
//       its mask written. 20 B a cell.
// The TPU kernel's 128 x 128 lower-triangular MXU blocks have no
// counterpart: the scalar recurrence costs one double FMA a step, and a
// tensor core would round the carries to TF32.
#include "time_tiles.cuh"

namespace {

using time_tiles::div_by;
using time_tiles::mag_of;
using time_tiles::ratio_of;
using time_tiles::rcp_refined;

constexpr int THREADS = 256;   // a block (geometry.py's FM_THREADS)
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;      // 16-byte loads a thread issues before it uses any
constexpr int MIN_BLOCKS = 8;  // blocks an SM must hold: at most 32 registers
constexpr unsigned FULL = 0xffffffffu;

enum Mode { RESIDENT, PARTIALS, FINAL };

// Host constants (kernels.py::_fm_constants, float64): a = 1 - b, b; a^n
// and R(n) of a full region (n = lane_len) and of the short region that
// ends the column or its last tile; a^n and R(n) of a full tile and of the
// last tile (tiled route).
struct Consts {
  double a, b, aL, rL, aN, rN, aT, rT, aU, rU;
};

// Frame o of z: (re, im) of a complex plane, or (|Z|, 0) of a magnitude
// plane; and its |Z|.
template <bool CPLX>
__device__ __forceinline__ float2 frame(const float* __restrict__ z, long long o) {
  return CPLX ? __ldg(reinterpret_cast<const float2*>(z) + o) : make_float2(__ldg(z + o), 0.f);
}

template <bool CPLX>
__device__ __forceinline__ float magnitude(float2 v) {
  return CPLX ? mag_of(v.x, v.y) : v.x;
}

__device__ __forceinline__ float mask_of(float mag, float w, float thresh, float slope) {
  const float y = 1.f + expf(-((ratio_of(mag, w) - thresh) * slope));
  return isinf(y) ? 0.f : div_by(1.f, y, rcp_refined(y));  // 1 / y
}

// One block: `cols` columns of a stretch of frames [t0, t0 + tl), which are
// contiguous in the plane (the resident route's whole columns, or one tile
// of one column). Shared memory: the warps' scan aggregates, then two
// planes of the block's frames, column c at c * tl: |Z|, and y, then w.
// Each plane starts g0 mod 4 words past a 16-byte boundary, so that 16-byte
// pieces of the output are 16-byte pieces of both.
template <bool CPLX, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fm_mask_kernel(const float* __restrict__ z, double* __restrict__ parts,
                   float* __restrict__ out, long long n_cols, int n_frames,
                   int cols, int lane_len, int tile_len, int n_tiles, Consts k,
                   float thresh, float slope) {
  extern __shared__ double agg[];  // per warp (A, B) forward, then (A, C)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  long long c0;  // the block's first column
  int t0, tl, tile = 0;
  if (MODE == RESIDENT) {
    c0 = (long long)blockIdx.x * cols;
    t0 = 0;
    tl = n_frames;
  } else {
    c0 = blockIdx.x / n_tiles;
    tile = (int)(blockIdx.x - c0 * n_tiles);
    t0 = tile * tile_len;
    tl = min(tile_len, n_frames - t0);
  }
  const int ncol = (int)min((long long)cols, n_cols - c0);
  const long long g0 = c0 * n_frames + t0;
  const int total = ncol * tl;
  float* zs = reinterpret_cast<float*>(agg + 4 * WARPS) + (int)(g0 % 4);
  float* ys = zs + (cols * tl + 3) / 4 * 4;

  // stage |Z| in 16-byte loads of P frames, aligned in device memory (z
  // itself may start off a 16-byte boundary); a thread issues UNROLL before
  // it uses any (the square root may branch, which would keep the next
  // load back). The frames before the first 16-byte boundary and after the
  // last go one a thread.
  constexpr int P = CPLX ? 2 : 4;
  const float* zg = z + (CPLX ? 2 : 1) * g0;  // the stretch's first frame
  const int head = min(total, (int)((16 - (reinterpret_cast<size_t>(zg) & 15)) & 15) / (16 / P));
  const int pieces = (total - head) / P;
  const float4* zv = reinterpret_cast<const float4*>(zg + (CPLX ? 2 : 1) * head);
  for (int i0 = tid; i0 < pieces; i0 += THREADS * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * THREADS < pieces) v[u] = __ldg(zv + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u * THREADS < pieces) {
        float* d = zs + head + P * (i0 + u * THREADS);
        if (CPLX) {
          d[0] = mag_of(v[u].x, v[u].y);
          d[1] = mag_of(v[u].z, v[u].w);
        } else {
          d[0] = v[u].x, d[1] = v[u].y, d[2] = v[u].z, d[3] = v[u].w;
        }
      }
    }
  }
  if (tid < total - pieces * P) {
    const int i = tid < head ? tid : tid + pieces * P;
    zs[i] = magnitude<CPLX>(frame<CPLX>(z, g0 + i));
  }
  __syncthreads();

  // this thread's region [r0, r0 + n) of column c of the block
  const int W = WARPS / cols;
  const int c = warp / W, wc = warp - c * W, w0 = c * W;
  const bool live = c < ncol;
  const int r0 = (wc * 32 + lane) * lane_len;
  const int n = live ? max(0, min(lane_len, tl - r0)) : 0;
  const float* zc = zs + c * tl + r0;
  float* yc = ys + c * tl + r0;
  const double a = k.a, b = k.b;

  // 1. the region from zero carries: yl at its end, wl at its start
  double yl = 0.0, wl = 0.0, pw = b;
#pragma unroll 4
  for (int u = 0; u < n; ++u) {
    yl = fma(a, yl, b * (double)zc[u]);
    wl = fma(pw, yl, wl);
    pw *= a;
  }
  const double an = n == lane_len ? k.aL : n == 0 ? 1.0 : k.aN;
  const double rn = n == lane_len ? k.rL : n == 0 ? 0.0 : k.rN;

  // 2. y: scan of the maps y -> A y + B over the column's lanes, in order
  double A = an, B = yl;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double pa = __shfl_up_sync(FULL, A, d), pb = __shfl_up_sync(FULL, B, d);
    if (lane >= d) {
      B = fma(A, pb, B);
      A *= pa;
    }
  }
  const double ea = __shfl_up_sync(FULL, A, 1), eb = __shfl_up_sync(FULL, B, 1);
  if (lane == 31) {
    agg[2 * warp] = A;
    agg[2 * warp + 1] = B;
  }
  __syncthreads();
  // y carried into the stretch: y[-1] = |Z|[0] (so y[0] = |Z|[0]), the
  // tile's exact carry, or 0 for the partials
  double y = MODE == RESIDENT ? (live ? (double)zs[c * tl] : 0.0)
             : MODE == FINAL  ? parts[(long long)tile * n_cols + c0]
                              : 0.0;
  for (int q = 0; q < wc; ++q) y = fma(agg[2 * (w0 + q)], y, agg[2 * (w0 + q) + 1]);
  const double y_in = lane == 0 ? y : fma(ea, y, eb);  // y before the region
  for (int q = wc; q < W; ++q) y = fma(agg[2 * (w0 + q)], y, agg[2 * (w0 + q) + 1]);
  const double y_end = y;  // y at the stretch's last frame

  // 3. w: scan of the maps w -> A w + C over the lanes, from the end
  A = an;
  double C = fma(rn, y_in, wl);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double pa = __shfl_down_sync(FULL, A, d), pc = __shfl_down_sync(FULL, C, d);
    if (lane + d < 32) {
      C = fma(A, pc, C);
      A *= pa;
    }
  }
  const double fa = __shfl_down_sync(FULL, A, 1), fc = __shfl_down_sync(FULL, C, 1);
  if (lane == 0) {
    agg[2 * (WARPS + warp)] = A;
    agg[2 * (WARPS + warp) + 1] = C;
  }
  __syncthreads();
  // w after the stretch: w[T] = y[T-1] (so w[T-1] = y[T-1]), the tile's
  // exact carry, or 0 for the partials
  double w = MODE == RESIDENT ? y_end
             : MODE == FINAL  ? parts[((long long)n_tiles + tile) * n_cols + c0]
                              : 0.0;
  for (int q = W - 1; q > wc; --q)
    w = fma(agg[2 * (WARPS + w0 + q)], w, agg[2 * (WARPS + w0 + q) + 1]);
  if (MODE == PARTIALS) {  // one column a block: the tile's maps at zero
    if (tid == 0) {
      parts[(long long)tile * n_cols + c0] = y_end;
      parts[((long long)n_tiles + tile) * n_cols + c0] =
          fma(agg[2 * WARPS], w, agg[2 * WARPS + 1]);
    }
    return;
  }

  // 4. the region again: y forward from the exact y before it, rounded to
  // float; w backward from the exact w after it over that y, written over
  // it as float
  const int tf = t0 + r0;  // the frame of the region's start
  double yd = y_in;
#pragma unroll 4
  for (int u = 0; u < n; ++u) {
    const double m = zc[u];
    yd = tf + u == 0 ? m : fma(a, yd, b * m);
    yc[u] = (float)yd;
  }
  double wd = lane == 31 ? w : fma(fa, w, fc);
#pragma unroll 4
  for (int u = n - 1; u >= 0; --u) {
    const double yt = yc[u];
    wd = tf + u == n_frames - 1 ? yt : fma(a, wd, b * yt);
    yc[u] = (float)wd;
  }
  __syncthreads();

  // 5. the masks, four frames a thread, out in 16-byte stores (16-byte
  // pieces of both planes), the frames outside them one a thread
  const int ohead = (int)min((long long)total, (4 - g0 % 4) % 4);
  const int opieces = (total - ohead) / 4;
  float4* ov = reinterpret_cast<float4*>(out + g0 + ohead);
  const float4* zq = reinterpret_cast<const float4*>(zs + ohead);
  const float4* wq = reinterpret_cast<const float4*>(ys + ohead);
  for (int i = tid; i < opieces; i += THREADS) {
    const float4 m = zq[i], v = wq[i];
    ov[i] = make_float4(mask_of(m.x, v.x, thresh, slope), mask_of(m.y, v.y, thresh, slope),
                        mask_of(m.z, v.z, thresh, slope), mask_of(m.w, v.w, thresh, slope));
  }
  if (tid < total - opieces * 4) {
    const int i = tid < ohead ? tid : tid + opieces * 4;
    out[g0 + i] = mask_of(zs[i], ys[i], thresh, slope);
  }
}

// The tiled route's column pass: a thread per column walks its tiles'
// partials forward for y and backward for w with the tile constants, and
// leaves y before (slot 0) and w after (slot 1) each tile in place.
template <bool CPLX>
__global__ void __launch_bounds__(128)
    fm_carries_kernel(const float* __restrict__ z, double* __restrict__ parts,
                      long long n_cols, int n_frames, int n_tiles, Consts k) {
  const long long col = (long long)blockIdx.x * 128 + threadIdx.x;
  if (col >= n_cols) return;
  double* py = parts + col;  // tile q's slot 0 at py[q * n_cols]
  double* pw = parts + (long long)n_tiles * n_cols + col;
  double y = magnitude<CPLX>(frame<CPLX>(z, col * n_frames));  // y[-1] = |Z|[0]
  for (int q = 0; q < n_tiles; ++q) {
    const double end = py[q * n_cols];
    py[q * n_cols] = y;
    y = fma(q == n_tiles - 1 ? k.aU : k.aT, y, end);
  }
  double w = y;  // w[T] = y[T-1]
  for (int q = n_tiles - 1; q >= 0; --q) {
    const bool last = q == n_tiles - 1;
    const double start = pw[q * n_cols];
    pw[q * n_cols] = w;
    w = fma(last ? k.aU : k.aT, w, fma(last ? k.rU : k.rT, py[q * n_cols], start));
  }
}

template <typename K>
int allow_smem(K kernel, int smem) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool CPLX>
int launch(const float* z, double* parts, float* out, long long n_cols,
           int n_frames, int cols, int lane_len, int tile_len, int n_tiles,
           const Consts& k, float thresh, float slope, int smem, cudaStream_t st) {
  int err;
  if (!parts) {
    if ((err = allow_smem(fm_mask_kernel<CPLX, RESIDENT>, smem))) return err;
    fm_mask_kernel<CPLX, RESIDENT><<<(unsigned)((n_cols + cols - 1) / cols), THREADS,
                                     smem, st>>>(z, parts, out, n_cols, n_frames, cols,
                                                 lane_len, tile_len, n_tiles, k, thresh,
                                                 slope);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)(n_cols * n_tiles);
  if ((err = allow_smem(fm_mask_kernel<CPLX, PARTIALS>, smem))) return err;
  fm_mask_kernel<CPLX, PARTIALS><<<blocks, THREADS, smem, st>>>(
      z, parts, out, n_cols, n_frames, 1, lane_len, tile_len, n_tiles, k, thresh, slope);
  if ((err = (int)cudaGetLastError())) return err;
  fm_carries_kernel<CPLX><<<(unsigned)((n_cols + 127) / 128), 128, 0, st>>>(
      z, parts, n_cols, n_frames, n_tiles, k);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(fm_mask_kernel<CPLX, FINAL>, smem))) return err;
  fm_mask_kernel<CPLX, FINAL><<<blocks, THREADS, smem, st>>>(
      z, parts, out, n_cols, n_frames, 1, lane_len, tile_len, n_tiles, k, thresh, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// z: (n_cols, n_frames) interleaved complex64 (is_complex 1) or float32
// magnitudes (0); out: (n_cols, n_frames) f32. parts: null for the resident
// route (one launch, `cols` columns a block, tile_len = n_frames, n_tiles
// 1); else a (2, n_tiles, n_cols) f64 buffer for the tiled route (three
// launches, one column and one tile of tile_len = 256 * lane_len frames a
// block). lane_len: frames of a thread's region; k: 10 host doubles
// (struct Consts); smem: the dynamic shared memory of a block. Returns the
// first launch's cudaGetLastError() that is not 0.
extern "C" int nr_fm_nonstationary_mask(const float* z, int is_complex, double* parts,
                                        float* out, long long n_cols, int n_frames,
                                        int cols, int lane_len, int tile_len, int n_tiles,
                                        const double* k, float thresh, float slope,
                                        int smem, void* stream) {
  if (n_cols <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const Consts c{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7], k[8], k[9]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_complex ? launch<true>(z, parts, out, n_cols, n_frames, cols, lane_len,
                                   tile_len, n_tiles, c, thresh, slope, smem, st)
                    : launch<false>(z, parts, out, n_cols, n_frames, cols, lane_len,
                                    tile_len, n_tiles, c, thresh, slope, smem, st);
}
