// Kernel B: nonstationary_mask — filtfilt noise floor, sigmoid mask and
// time smoothing.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_am_kernel phase 3
// (:443-525, IIR floor + sigmoid) and ::_time_smooth_phase (:375).
//
// Per (row, bin) column of the time-major spectra:
//   |Z|[t]  = sqrt(re^2 + im^2)
//   y[0] = |Z|[0],      y[t] = b |Z|[t] + (1-b) y[t-1]      (forward)
//   w[T-1] = y[T-1],    w[t] = b y[t] + (1-b) w[t+1]         (backward)
//   raw[t] = sigmoid(((|Z|[t] - w[t]) / w'[t] - thresh) * slope),
//            w' = w with zeros replaced by 1 (silence gives finite zeros)
//   out[t] = sum_d taps[d] raw[t + d - n],  zero outside [0, n_frames)
//
// The IIR state y and w is carried in double precision: a float32 carry
// takes about 1/b roundings into each value (b ~ 0.003 at 48 kHz), and the
// sigmoid slope turns that into ~4e-5 of mask error; the TPU kernel's
// blockwise dots round far fewer times. y is rounded to float once before
// the backward pass, as the column walk of earlier versions stored it.
//
// Bound on this card: bytes. A handful of FLOPs per element; the function
// reads re and im once and writes the mask once (12 B a cell, 1.22 GB at the
// 960 s headline shape; 8 B a cell, 0.81 GB, from bf16 re/im in the bf16
// build, widened to float32 where they are used, planes.cuh). Design
// (time_tiles.cuh): the time axis of each
// column is cut into segments of a thread each, so the whole plane's loads
// are in flight at once, not one frame of 40,000 columns. The recurrences
// are linear, so segments combine as in the TPU kernel's blockwise carry
// chain (kernels.py:476-524). With a = 1 - b, for segment [t0, t1):
//   y[t] = yl[t] + a^(t-t0+1) y[t0-1]
//   w[t] = wl[t] + R(t-t0) y[t0-1] + a^(t1-t) w[t1],
//   R(p) = b a^(p+1) sum_{k=0}^{t1-t0-p-1} a^(2k)   (host constants)
// where yl and wl are the segment's own recurrences from zero carries.
//   1. partials: one pass over re/im writes per (row, segment, bin) the
//      segment's yl at its end and at offset p_f, and wl at its start and at
//      offset p_b, in double (wl is summed forward as sum b a^k yl);
//   2. carries: a thread per column walks its segments forward for y and
//      backward for w with the host's float64 constants, and leaves y at
//      offset p_f and w at offset p_b of each segment;
//   3. final: a block of 4 consecutive segments (a warp each) stages them
//      and a halo of h = n_taps/2 frames on each side of the run in one
//      shared-memory tile (cp.async of 4-byte words: float32 values, or
//      the words that hold the bf16 elements, whose forward walk takes
//      each element out of its word). Each thread runs y forward from the
//      exact y[t0-1] and w backward from w[t1]; the first warp starts at
//      y[t0-h-1] (offset p_f = (-h-1) mod L of an earlier segment) and the
//      last ends at w[t1+h] (offset p_b = h mod L of a later one). Each
//      thread turns its frames into the raw mask in place; after a barrier
//      each smooths its segment from the tile in the tap order of the
//      plain version. A halo whose tile does not fit takes h = 0, the raw
//      mask to a plane, and one more launch to smooth it
//      (time_tiles.cuh::smooth_plane).
// The partials cannot see y's rounding to float, so the carries are those
// of the unrounded y: about one float32 rounding of the floor, against one
// ulp before. The kernel moves re and im twice (the final pass with its
// halo) and the mask once: 21 B a cell at the headline (L 40, h 9).
// Tensor cores are not the lever: the TPU kernel's in-segment
// lower-triangular products would run in TF32 or bf16 here, which the
// float64 carry rules out. What holds the final pass back is its serial
// walks: two float64 chains a frame with four float <-> double
// conversions, a sqrt, a division, an exp and a reciprocal (the XU pipe's
// 16 a clock an SM), over a tile of 8 B a frame that leaves 512 threads
// an SM.
#include "time_tiles.cuh"

namespace {

using namespace time_tiles;

constexpr int SEG = 40;  // frames of a segment (geometry.py's SEG_B)

// Host constants (kernels.py::_ewma_constants, float64): a = 1 - b, b, and
// for a full segment (length L) and the last one (length N): a^n, R(0, n),
// R(p_b, n), a^(n - p_b); a^(p_f + 1).
struct Ewma {
  double a, b, apf1, aL, r0L, rpL, apL, aN, r0N, rpN, apN;
};

template <class T>  // the planes' type (planes.cuh)
__global__ void __launch_bounds__(PART_COLS)
    ewma_partials_kernel(const T* __restrict__ re,
                         const T* __restrict__ im,
                         double* __restrict__ parts, int rows, int n_frames,
                         int n_bins, int n_segs, int p_f, int p_b, Ewma k) {
  const Cell c = cell_of(PART_COLS, rows, n_frames, n_bins);
  if (!c.live) return;
  const int t0 = c.q * SEG;
  const int t1 = min(n_frames, t0 + SEG);
  double yl = 0.0, fh = 0.0, bk = 0.0, bh = 0.0;
  double pw = k.b, pw2 = k.b;  // b a^(t - t0), b a^(t - t0 - p_b)
  walk(re, im, c.base, n_bins, t0, t1, [&](int t, float zr, float zi) {
    const int u = t - t0;
    yl = fma(k.a, yl, k.b * mag_of(zr, zi));
    bk = fma(pw, yl, bk);
    pw *= k.a;
    if (u >= p_b) {
      bh = fma(pw2, yl, bh);
      pw2 *= k.a;
    }
    if (u == p_f) fh = yl;
  });
  parts[part_at(0, c.col, c.q, rows, n_segs, n_bins)] = yl;
  parts[part_at(1, c.col, c.q, rows, n_segs, n_bins)] = fh;
  parts[part_at(2, c.col, c.q, rows, n_segs, n_bins)] = bk;
  parts[part_at(3, c.col, c.q, rows, n_segs, n_bins)] = bh;
}

template <class T>
__global__ void __launch_bounds__(PART_COLS)
    ewma_carries_kernel(const T* __restrict__ re,
                        const T* __restrict__ im,
                        double* __restrict__ parts, int rows, int n_frames,
                        int n_bins, int n_segs, int p_f, int p_b, Ewma k) {
  const long long col = (long long)blockIdx.x * PART_COLS + threadIdx.x;
  if (col >= (long long)rows * n_bins) return;
  const int row = (int)(col / n_bins);
  const long long bin = col - (long long)row * n_bins;
  const long long base = (long long)row * n_frames * n_bins + bin;
  // partial j of segment q at p[j * slot + q * n_bins]
  double* p = parts + (long long)row * n_segs * n_bins + bin;
  const long long slot = (long long)rows * n_segs * n_bins;
  const int n_last = n_frames - (n_segs - 1) * SEG;
  // forward: Y_q = y[t0 - 1], with y[-1] = |Z|[0] (so y[0] = |Z|[0])
  double y = mag_of(planes::ld(re + base), planes::ld(im + base));
  for (int q0 = 0; q0 < n_segs; q0 += CARRY_BATCH) {
    double yl_end[CARRY_BATCH], fh[CARRY_BATCH];
#pragma unroll
    for (int i = 0; i < CARRY_BATCH; ++i) {
      if (q0 + i < n_segs) {
        yl_end[i] = p[(q0 + i) * (long long)n_bins];
        fh[i] = p[slot + (q0 + i) * (long long)n_bins];
      }
    }
#pragma unroll
    for (int i = 0; i < CARRY_BATCH; ++i) {
      const int q = q0 + i;
      if (q >= n_segs) break;
      const bool last = q == n_segs - 1;
      if (p_f < (last ? n_last : SEG))  // y at offset p_f
        p[slot + q * (long long)n_bins] = fma(k.apf1, y, fh[i]);
      p[q * (long long)n_bins] = y;
      y = fma(last ? k.aN : k.aL, y, yl_end[i]);
    }
  }
  // backward: w[T] = y[T-1] (so w[T-1] = y[T-1]); W = w[t1]
  double w = y;
  for (int q0 = n_segs - 1; q0 >= 0; q0 -= CARRY_BATCH) {
    double yq[CARRY_BATCH], bk[CARRY_BATCH], bh[CARRY_BATCH];
#pragma unroll
    for (int i = 0; i < CARRY_BATCH; ++i) {
      if (q0 - i >= 0) {
        yq[i] = p[(q0 - i) * (long long)n_bins];
        bk[i] = p[2 * slot + (q0 - i) * (long long)n_bins];
        bh[i] = p[3 * slot + (q0 - i) * (long long)n_bins];
      }
    }
#pragma unroll
    for (int i = 0; i < CARRY_BATCH; ++i) {
      const int q = q0 - i;
      if (q < 0) break;
      const bool last = q == n_segs - 1;
      if (p_b < (last ? n_last : SEG))  // w at offset p_b
        p[3 * slot + q * (long long)n_bins] =
            fma(last ? k.apN : k.apL, w, fma(last ? k.rpN : k.rpL, yq[i], bh[i]));
      w = fma(last ? k.aN : k.aL, w, fma(last ? k.r0N : k.r0L, yq[i], bk[i]));
      p[2 * slot + q * (long long)n_bins] = w;  // w[t0]
    }
  }
}

template <class T>
__global__ void __launch_bounds__(TILE_COLS * TILE_SEGS)
    nonstationary_final_kernel(const T* __restrict__ re,
                               const T* __restrict__ im,
                               const double* __restrict__ parts,
                               float* __restrict__ out,
                               const float* __restrict__ taps, int n_taps,
                               int halo, int rows, int n_frames, int n_bins,
                               int n_segs, double a, double bd, float thresh,
                               float slope) {
  extern __shared__ float tile[];  // per frame: im, y, then the raw mask
                                   // (word 0); re, then |Z| (word 1)
  const FinalCell c = final_cell(rows, n_frames, n_bins, n_segs);
  const int t0 = c.q * SEG;
  const int t1 = min(n_frames, t0 + SEG);
  const int off = halo - c.q0 * SEG;  // frame t at word pair t + off
  float* col = tile + threadIdx.x % TILE_COLS;
  if (c.live) {
    // this thread's frames [fs, fe): its segment, and the halo before
    // (first warp) or after (last warp) the block within the plane
    const int fs = c.first ? max(0, t0 - halo) : t0;
    const int fe = c.last ? min(n_frames, t1 + halo) : t1;
    stage(re, im, c.base, n_bins, fs, fe, col, off);
    const Staged<T> sre(re, c.base, n_bins), sim(im, c.base, n_bins);

    // forward from y[fs - 1]: at offset p_f of an earlier segment before a
    // halo, else y[t0 - 1]; y over im (word 0), |Z| over re (word 1)
    double y = fs == 0 ? 0.0
               : fs < t0 ? parts[part_at(1, c.col, (fs - 1) / SEG, rows, n_segs, n_bins)]
                         : parts[part_at(0, c.col, c.q, rows, n_segs, n_bins)];
#pragma unroll 4
    for (int t = fs; t < fe; ++t) {
      float* cy = col + 2 * (t + off) * TILE_COLS;
      const float mag = mag_of(sre(cy[TILE_COLS], t), sim(cy[0], t));
      y = (t == 0) ? (double)mag : fma(a, y, bd * mag);
      cy[0] = (float)y;
      cy[TILE_COLS] = mag;
    }

    // backward from w[fe]: at offset p_b of a later segment after a halo,
    // else w[t1], the next segment's w[t0]; the raw mask over y in place
    double wd = fe == n_frames ? 0.0
                : fe > t1 ? parts[part_at(3, c.col, fe / SEG, rows, n_segs, n_bins)]
                          : parts[part_at(2, c.col, c.q + 1, rows, n_segs, n_bins)];
#pragma unroll 4
    for (int t = fe - 1; t >= fs; --t) {
      float* cy = col + 2 * (t + off) * TILE_COLS;
      const double yt = cy[0];
      wd = (t == n_frames - 1) ? yt : fma(a, wd, bd * yt);
      const float w = (float)wd;
      const float ratio = (cy[TILE_COLS] - w) / (w == 0.f ? 1.f : w);
      const float z = (ratio - thresh) * slope;
      cy[0] = 1.f / (1.f + expf(-z));
    }
    if (c.first) zero_frames<2>(col, t0 - halo, fs, off);
    if (c.last) zero_frames<2>(col, fe, t1 + halo, off);
  }
  __syncthreads();  // the neighbouring segments' frames are in the tile
  if (c.live)
    smooth_from_tile<2>(col + 2 * (t0 - halo + off) * TILE_COLS, t0, t1, taps,
                        n_taps, out, c.base, n_bins);
}

}  // namespace

// plane: the type of re and im (planes.cuh: 0 float32, 1 bfloat16); re/im:
// (rows, n_frames, n_bins); out: the same, f32; parts: (4, rows, n_segs,
// n_bins) f64 with n_segs = ceil(n_frames / SEG); taps: (n_taps,) f32,
// n_taps odd; k: 11 host doubles (struct Ewma); p_f = (-h-1) mod SEG, p_b =
// h mod SEG for the final pass's halo h. raw: null when the final pass
// smooths from its tile (h = n_taps / 2, smem bytes of tile); else a (rows,
// n_frames, n_bins) f32 plane for the raw mask (h = 0), smoothed into out
// by one more launch. Returns the first launch's cudaGetLastError() that is
// not 0.
extern "C" int nr_nonstationary_mask(int plane, const void* re_p, const void* im_p,
                                     double* parts, float* raw, float* out,
                                     const float* taps, int n_taps, int rows,
                                     int n_frames, int n_bins, int halo,
                                     int p_f, int p_b, const double* k,
                                     float thresh, float slope, int smem,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long columns = (long long)rows * n_bins;
  if (columns <= 0 || n_frames <= 0) return (int)cudaGetLastError();
  const int n_segs = (n_frames + SEG - 1) / SEG;
  const Ewma e{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7], k[8], k[9], k[10]};
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const T* re = static_cast<const T*>(re_p);
    const T* im = static_cast<const T*>(im_p);
    int err;
    ewma_partials_kernel<T><<<(unsigned)blocks_of(columns, PART_COLS, n_segs),
                              PART_COLS, 0, st>>>(re, im, parts, rows, n_frames,
                                                  n_bins, n_segs, p_f, p_b, e);
    if ((err = (int)cudaGetLastError())) return err;
    ewma_carries_kernel<T><<<(unsigned)blocks_of(columns, PART_COLS, 1), PART_COLS,
                             0, st>>>(re, im, parts, rows, n_frames, n_bins, n_segs,
                                      p_f, p_b, e);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = (int)cudaFuncSetAttribute(
             nonstationary_final_kernel<T>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
    nonstationary_final_kernel<T><<<(unsigned)blocks_of(columns, TILE_COLS,
                                                         (n_segs + TILE_SEGS - 1) / TILE_SEGS),
                                    TILE_COLS * TILE_SEGS, smem, st>>>(
        re, im, parts, raw ? raw : out, raw ? nullptr : taps, raw ? 1 : n_taps,
        halo, rows, n_frames, n_bins, n_segs, e.a, e.b, thresh, slope);
    if ((err = (int)cudaGetLastError()) || !raw) return err;
    return smooth_plane(raw, out, taps, n_taps, rows, n_frames, n_bins, st);
  });
}
