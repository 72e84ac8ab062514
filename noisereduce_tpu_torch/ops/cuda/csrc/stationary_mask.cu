// Kernel E: stationary_mask — dB spectrogram, per-bin dynamic-range floor,
// binary threshold mask, prop_decrease blend and time smoothing.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_as_kernel passes A and B
// and its self-statistics pass (:565-628) and its ::_time_smooth_phase
// (:630): the stationary variant of the merged TPU gate kernel
// (dispatch.py::_merged_gate_from_blocks, :242) and of the torch-convention
// gate (torch_dispatch.py::_merged_torch_impl, :382; _fused_torch_impl, :526).
//
// Per (view, bin) column of the time-major spectra:
//   dB[t]  = log(sqrt(re^2 + im^2) + eps) * (20 / ln 10)   (kernels.py:573)
//   mx     = max over t < n_frames of dB[t]
//   c[t]   = max(dB[t], mx - top_db)     (top_db 80 scipy engine, 40 torch)
//   m[t]   = prop * 1[c[t] > thr] + (1 - prop)
//            (blend BEFORE smoothing: the stationary order)
//   out[t] = sum_d taps[d] m[t + d - n],  zero outside [0, n_frames)
// thr is row (view / views_per_row) of a (rows, n_bins) plane, or one
// (n_bins,) row shared by every view (thr_stride 0), or, with thr null, the
// column's own statistics (TorchGate with no noise clip):
//   thr = mean(c) + n_std * std(c), std with ddof 1,
// from double sums of c - mx and its square (the shift keeps the one-pass
// variance from cancelling: a float one-pass sum of squares of dB values
// near -100 loses most of its digits), compared in double.
//
// Bound on this card: bytes. It must read re and im once and write the mask
// once: 1.22 GB for 960 s of 48 kHz audio (77 views x 2,579 frames x 513
// bins), 0.36 ms at 3.35 TB/s (0.81 GB, 0.24 ms from the bf16 build's bf16
// re/im, widened as they load, planes.cuh); a few FLOPs per element. Design
// (time_tiles.cuh): each column's time axis is cut into segments of a thread
// each, so the whole plane's loads are in flight at once.
//   1. maxima: per (view, segment, bin) the max of dB, to a small buffer;
//   2. a thread per column takes the max over its segments. The max is
//      exact and order-free, so mx is bitwise the column walk's;
//   own statistics only: 3. per (view, segment, bin) the double sums of
//      c - mx and its square; 4. a thread per column adds them in segment
//      order and forms thr (the sums' order moves thr by ~1e-16 relative);
//   5. final: a block of 4 consecutive segments (a warp each) and a halo
//      of n_taps/2 frames on each side of the run: floor, compare, blend
//      into one shared-memory tile, a barrier, then each segment's taps'
//      chain from the tile to out. With one tap the blend goes straight to
//      out. A halo whose tile does not fit takes the blend to a plane and
//      one more launch to smooth it.
// re and im are read twice (three times with own statistics) and the mask
// written once: 21 B a cell at the headline with the halo (29 B). The
// compare in double of a float dB with thr is the float compare with thr
// rounded toward -inf, so it runs in float. With a given threshold the
// output is bitwise the column walk's: the same db_of, max, compare and
// tap chain.
//
// The products and the sum of the squared magnitude round separately
// (__fmul_rn / __fadd_rn, no FMA contraction), as the plain version's
// elementwise ops do, so the binary compare flips only where logf itself
// differs by an ulp.
#include <math_constants.h>

#include "time_tiles.cuh"

namespace {

using namespace time_tiles;

constexpr int SEG = 64;  // frames of a segment (geometry.py's SEG_E)

__device__ __forceinline__ float db_of(float zr, float zi, float eps,
                                       float k20) {
  const float p = __fadd_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi));
  return __fmul_rn(logf(__fadd_rn(sqrtf(p), eps)), k20);
}

template <class T>  // the planes' type (planes.cuh)
__global__ void __launch_bounds__(PART_COLS)
    db_max_kernel(const T* __restrict__ re, const T* __restrict__ im,
                  float* __restrict__ maxima, int views, int n_frames,
                  int n_bins, int n_segs, float eps, float k20) {
  const Cell c = cell_of(PART_COLS, views, n_frames, n_bins);
  if (!c.live) return;
  const int t0 = c.q * SEG;
  float mx = -CUDART_INF_F;
  walk(re, im, c.base, n_bins, t0, min(n_frames, t0 + SEG),
       [&](int, float zr, float zi) { mx = fmaxf(mx, db_of(zr, zi, eps, k20)); });
  maxima[part_at(0, c.col, c.q, views, n_segs, n_bins)] = mx;
}

__global__ void __launch_bounds__(PART_COLS)
    db_max_combine_kernel(const float* __restrict__ maxima,
                          float* __restrict__ mx, int views, int n_bins,
                          int n_segs) {
  const long long col = (long long)blockIdx.x * PART_COLS + threadIdx.x;
  if (col >= (long long)views * n_bins) return;
  float m = -CUDART_INF_F;
  for (int q = 0; q < n_segs; ++q)
    m = fmaxf(m, maxima[part_at(0, (int)col, q, views, n_segs, n_bins)]);
  mx[col] = m;
}

template <class T>
__global__ void __launch_bounds__(PART_COLS)
    db_stats_kernel(const T* __restrict__ re, const T* __restrict__ im,
                    const float* __restrict__ mx, double* __restrict__ sums,
                    int views, int n_frames, int n_bins, int n_segs, float eps,
                    float k20, float top_db) {
  const Cell c = cell_of(PART_COLS, views, n_frames, n_bins);
  if (!c.live) return;
  const int t0 = c.q * SEG;
  const float m = mx[c.col];
  const float floor_db = __fsub_rn(m, top_db);
  double s1 = 0.0, s2 = 0.0;
  walk(re, im, c.base, n_bins, t0, min(n_frames, t0 + SEG),
       [&](int, float zr, float zi) {
         const double d =
             (double)fmaxf(db_of(zr, zi, eps, k20), floor_db) - (double)m;
         s1 += d;
         s2 = fma(d, d, s2);
       });
  sums[part_at(0, c.col, c.q, views, n_segs, n_bins)] = s1;
  sums[part_at(1, c.col, c.q, views, n_segs, n_bins)] = s2;
}

__global__ void __launch_bounds__(PART_COLS)
    db_stats_combine_kernel(const double* __restrict__ sums,
                            const float* __restrict__ mx,
                            double* __restrict__ th, int views, int n_frames,
                            int n_bins, int n_segs, double n_std) {
  const long long col = (long long)blockIdx.x * PART_COLS + threadIdx.x;
  if (col >= (long long)views * n_bins) return;
  double s1 = 0.0, s2 = 0.0;
  for (int q = 0; q < n_segs; ++q) {
    s1 += sums[part_at(0, (int)col, q, views, n_segs, n_bins)];
    s2 += sums[part_at(1, (int)col, q, views, n_segs, n_bins)];
  }
  const double n = (double)n_frames;
  const double var = fmax(s2 - s1 * s1 / n, 0.0) / fmax(n - 1.0, 1.0);
  th[col] = (double)mx[col] + s1 / n + sqrt(var) * n_std;
}

template <class T>
__global__ void __launch_bounds__(TILE_COLS * TILE_SEGS)
    stationary_final_kernel(const T* __restrict__ re,
                            const T* __restrict__ im,
                            const float* __restrict__ mx,
                            const float* __restrict__ thr,
                            long long thr_stride, int views_per_row,
                            const double* __restrict__ th_own,
                            float* __restrict__ out,
                            const float* __restrict__ taps, int n_taps,
                            int halo, int views, int n_frames, int n_bins,
                            int n_segs, float prop, float one_minus_prop,
                            float eps, float k20, float top_db) {
  extern __shared__ float tile[];  // per frame: the blended mask
  const FinalCell c = final_cell(views, n_frames, n_bins, n_segs);
  const int v = c.col / n_bins;
  const int f = c.col - v * n_bins;
  const float floor_db = __fsub_rn(mx[c.col], top_db);
  // db > th in double, for a float db, is db > th rounded toward -inf:
  // no float lies in (that, th]; a float threshold stays itself
  const float th = thr != nullptr
                       ? __ldg(thr + (long long)(v / views_per_row) * thr_stride + f)
                       : __double2float_rd(th_own[c.col]);
  const int t0 = c.q * SEG;
  const int t1 = min(n_frames, t0 + SEG);
  auto blend = [&](float zr, float zi) {
    const float db = fmaxf(db_of(zr, zi, eps, k20), floor_db);
    return __fadd_rn(db > th ? prop : 0.f, one_minus_prop);
  };
  if (n_taps == 1) {  // straight to out (the same for every thread)
    if (!c.live) return;
    const float scale = taps ? __ldg(taps) : 1.f;
    walk(re, im, c.base, n_bins, t0, t1, [&](int t, float zr, float zi) {
      out[c.base + (long long)t * n_bins] = __fmul_rn(blend(zr, zi), scale);
    });
    return;
  }
  // the tile holds the block's frames with their halo, one word a frame:
  // this thread's segment, and the halo before (first warp) or after (last
  // warp) the block within the plane
  const int off = halo - c.q0 * SEG;
  float* col = tile + threadIdx.x % TILE_COLS;
  if (c.live) {
    const int fs = c.first ? max(0, t0 - halo) : t0;
    const int fe = c.last ? min(n_frames, t1 + halo) : t1;
    walk(re, im, c.base, n_bins, fs, fe, [&](int t, float zr, float zi) {
      col[(t + off) * TILE_COLS] = __fmul_rn(blend(zr, zi), 1.f);
    });
    if (c.first) zero_frames<1>(col, t0 - halo, fs, off);
    if (c.last) zero_frames<1>(col, fe, t1 + halo, off);
  }
  __syncthreads();  // the neighbouring segments' frames are in the tile
  if (c.live)
    smooth_from_tile<1>(col + (t0 - halo + off) * TILE_COLS, t0, t1, taps, n_taps,
                        out, c.base, n_bins);
}

}  // namespace

// plane: the type of re and im (planes.cuh: 0 float32, 1 bfloat16); re/im:
// (views, n_frames, n_bins); out: the same, f32; thr: f32, row r at thr + r
// * thr_stride (thr_stride 0: one shared row), or null for each column's
// own statistics with n_std; taps: (n_taps,) f32, n_taps odd. Work buffers,
// n_segs = ceil(n_frames / SEG): maxima (views, n_segs, n_bins) f32, mx
// (views, n_bins) f32; with thr null also sums (2, views, n_segs, n_bins)
// f64 and th (views, n_bins) f64. raw: null when the final pass smooths
// from its tile (halo n_taps / 2, smem bytes); else a (views, n_frames,
// n_bins) f32 plane for the blended mask (halo 0), smoothed into out by one
// more launch. Returns the first launch's cudaGetLastError() that is not 0.
extern "C" int nr_stationary_mask(int plane, const void* re_p, const void* im_p,
                                  const float* thr, long long thr_stride,
                                  int views_per_row, float* maxima, float* mx,
                                  double* sums, double* th, float* raw,
                                  float* out, const float* taps, int n_taps,
                                  int halo, int views, int n_frames,
                                  int n_bins, float prop, float one_minus_prop,
                                  float eps, float k20, float top_db,
                                  double n_std, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long columns = (long long)views * n_bins;
  if (columns <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_segs = (n_frames + SEG - 1) / SEG;
  const unsigned part_blocks = (unsigned)blocks_of(columns, PART_COLS, n_segs);
  const unsigned col_blocks = (unsigned)blocks_of(columns, PART_COLS, 1);
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const T* re = static_cast<const T*>(re_p);
    const T* im = static_cast<const T*>(im_p);
    int err;
    db_max_kernel<T><<<part_blocks, PART_COLS, 0, st>>>(re, im, maxima, views,
                                                        n_frames, n_bins, n_segs,
                                                        eps, k20);
    if ((err = (int)cudaGetLastError())) return err;
    db_max_combine_kernel<<<col_blocks, PART_COLS, 0, st>>>(maxima, mx, views,
                                                            n_bins, n_segs);
    if ((err = (int)cudaGetLastError())) return err;
    if (thr == nullptr) {
      db_stats_kernel<T><<<part_blocks, PART_COLS, 0, st>>>(
          re, im, mx, sums, views, n_frames, n_bins, n_segs, eps, k20, top_db);
      if ((err = (int)cudaGetLastError())) return err;
      db_stats_combine_kernel<<<col_blocks, PART_COLS, 0, st>>>(
          sums, mx, th, views, n_frames, n_bins, n_segs, n_std);
      if ((err = (int)cudaGetLastError())) return err;
    }
    if ((err = (int)cudaFuncSetAttribute(
             stationary_final_kernel<T>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
    stationary_final_kernel<T><<<(unsigned)blocks_of(columns, TILE_COLS,
                                                      (n_segs + TILE_SEGS - 1) / TILE_SEGS),
                                 TILE_COLS * TILE_SEGS, smem, st>>>(
        re, im, mx, thr, thr_stride, views_per_row, th, raw ? raw : out,
        raw ? nullptr : taps, raw ? 1 : n_taps, halo, views, n_frames, n_bins,
        n_segs, prop, one_minus_prop, eps, k20, top_db);
    if ((err = (int)cudaGetLastError()) || !raw) return err;
    return smooth_plane(raw, out, taps, n_taps, views,
                        n_frames, n_bins, st);
  });
}
