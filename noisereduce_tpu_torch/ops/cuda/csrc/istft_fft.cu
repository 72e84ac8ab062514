// Kernel D, FFT route: mask apply, inverse real FFT, overlap-add, envelope
// division and the output window, for a power-of-two n_fft (64 to 8192).
// istft_ola.cu (the DFT product) serves the other n_fft.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331).
//
// Computes what istft_ola.cu computes: with Y = Z * mask and y_t =
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
// written once (1.22 + 0.185 GB at the 960 s headline: 0.42 ms at 3.35 TB/s).
// Design: one block per run of `run` consecutive output hop blocks of one
// row (run * hop <= 8192 floats; 32 at hop 256). The block inverts the
// frames that cover its run, the run plus r - 1 halo frames (9% recomputed
// at run 32, r 4), in groups of ELEMS / (N/2) frames (8 at n_fft 1024):
//   load   Y = Z * mask, each of re, im, mask read once, coalesced along the
//          group's contiguous rows;
//   pre    Z'[k] = (Y[k] + conj Y[M-k]) / 2 + i e^{2 pi i k/N} (Y[k] - conj Y[M-k]) / 2,
//          in place, one thread per pair (k, M-k), which also gives
//          Z'[M-k] = conj of the same with the second term negated;
//   FFT    the unscaled N/2-point inverse of fft_smem.cuh, whose output holds
//          M * (y[2m] + i y[2m+1]); post carries the 1/M;
//   add    each output sample of the run, owned by one thread, sums its
//          frames' post[u] y_t[u] in ascending t into a shared-memory
//          accumulator.
// No atomics: every sample sums the same products in the same order
// whatever run or group its frames land in, so the output is the same from
// run to run and a row's output does not depend on the other rows. The
// epilogue divides by the envelope (a host table for blocks where all r
// frames exist; at the edges the window's squares of the frames that exist,
// summed in the table's order: float32 for torch, as torch.istft sums it)
// and writes the run's samples once, coalesced.
#include "fft_smem.cuh"

namespace {

// With S = Y[k] + conj Y[M-k], D = Y[k] - conj Y[M-k], v = conj w =
// e^{2 pi i k/N} and t = i v D: Z'[k] = (S + t) / 2, Z'[M-k] = conj(S - t) / 2.
__device__ __forceinline__ void unsplit(float2 yk, float2 ym, float2 w, float2& lo,
                                        float2& hi) {
  const float2 s = make_float2(yk.x + ym.x, yk.y - ym.y);
  const float2 vd = nrf::cmul(nrf::conj(w), make_float2(yk.x - ym.x, yk.y + ym.y));
  const float2 t = make_float2(-vd.y, vd.x);
  lo = nrf::scale(nrf::add(s, t), 0.5f);
  hi = nrf::scale(nrf::conj(nrf::sub(s, t)), 0.5f);
}

__global__ void __launch_bounds__(nrf::THREADS, nrf::MIN_BLOCKS)
    istft_fft_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     const float* __restrict__ mask, int n_frames, int n_bins,
                     int log2m, int hop, int r, int bpad, int j0, int n_out,
                     int run, int n_runs, long long out_off, long long out_len,
                     long long istft_len, float env_floor,
                     const float* __restrict__ post,
                     const float* __restrict__ wsq,
                     const float* __restrict__ env_int,
                     const float2* __restrict__ tw, float* __restrict__ out) {
  extern __shared__ __align__(16) float2 smem2[];
  const int M = 1 << log2m;
  const int G = nrf::ELEMS >> log2m;  // frames a group holds
  float2* z = smem2;
  float2* nyq = z + nrf::PADDED;  // Y[M] of each frame
  float* acc = reinterpret_cast<float*>(nyq + G);
  const float* zf = reinterpret_cast<const float*>(z);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_runs;
  const int ja = j0 + (blockIdx.x - b * n_runs) * run;
  const int je = min(run, j0 + n_out - ja);
  const int n_acc = je * hop;
  for (int l = tid; l < n_acc; l += nrf::THREADS) acc[l] = 0.f;

  const int t_lo = max(0, ja - r + 1);
  const int t_hi = min(n_frames - 1, ja + je - 1);
  const long long row = (long long)b * n_frames * n_bins;
  // each segment of threads loads, transforms and inverts its own frames
  const nrf::Seg sg = nrf::segment(log2m);
  const int step = 1 << sg.log2t;
  const int f0 = sg.first >> log2m;  // the segment's first frame slot
  const int f_seg = max(1, (step << nrf::LOG2PP) >> log2m);
  for (int tg = t_lo; tg <= t_hi; tg += G) {
    const int ge = min(G, t_hi - tg + 1);
    const int f1 = min(ge, f0 + f_seg);
    // Y = Z * mask of the segment's frames, along their contiguous rows
    const long long o0 = row + (long long)tg * n_bins;
    for (int e = f0 * n_bins + sg.lane; e < f1 * n_bins; e += step) {
      const int f = e / n_bins;
      const int k = e - f * n_bins;
      const float m = __ldg(mask + o0 + e);
      const float2 y = make_float2(__ldg(re + o0 + e) * m,
                                   (k == 0 || k == M) ? 0.f : __ldg(im + o0 + e) * m);
      if (k < M)
        z[nrf::pad((f << log2m) + k)] = y;
      else
        nyq[f] = y;
    }
    nrf::seg_sync(sg);
    // pre-step, in place: slot k < M/2 of frame f turns the pair (k, M - k)
    // (slot 0: 0 with Y[M], and M/2)
    for (int e = (f0 << (log2m - 1)) + sg.lane; e < f1 << (log2m - 1); e += step) {
      const int f = e >> (log2m - 1);
      const int k = e & (M / 2 - 1);
      const int base = f << log2m;
      const int lk = nrf::pad(base + k);
      const int lm = nrf::pad(base + M - k);
      float2 lo, hi;
      unsplit(z[lk], k == 0 ? nyq[f] : z[lm], __ldg(tw + k), lo, hi);
      z[lk] = lo;
      if (k != 0) {
        z[lm] = hi;
      } else {
        const int lh = nrf::pad(base + M / 2);
        unsplit(z[lh], z[lh], __ldg(tw + M / 2), lo, hi);
        z[lh] = lo;
      }
    }
    nrf::seg_sync(sg);

    nrf::fft_frames<true>(z, log2m, ge, tw, sg);
    __syncthreads();  // the overlap-add reads every frame of the group

    // overlap-add: sample l (hop block ja + l/hop) takes frames
    // t in [jj - r + 1, jj] of this group, ascending; y_t[u] is float u of
    // frame t's row
    const int l_lo = max(0, (tg - ja) * hop);
    const int l_hi = min(n_acc, (tg + ge - 1 - ja + r) * hop);
    for (int l = (l_lo / nrf::THREADS) * nrf::THREADS + tid; l < l_hi;
         l += nrf::THREADS) {
      if (l < l_lo) continue;
      const int jb = l / hop;
      const int q = l - jb * hop;
      const int jj = ja + jb;
      const int ta = max(tg, jj - r + 1);
      const int tb = min(tg + ge - 1, jj);
      float a = acc[l];
      for (int t = ta; t <= tb; ++t) {
        const int u = (jj - t) * hop + q;
        const int L = nrf::pad(((t - tg) << log2m) + (u >> 1));
        a = fmaf(__ldg(post + u), zf[2 * L + (u & 1)], a);
      }
      acc[l] = a;
    }
    __syncthreads();  // before the next group overwrites the planes
  }

  // envelope division and the trimmed output window
  for (int l = tid; l < n_acc; l += nrf::THREADS) {
    const int jb = l / hop;
    const int q = l - jb * hop;
    const int jj = ja + jb;
    const long long s = (long long)jj * hop + q - bpad;
    const long long o = s - out_off;
    if (o < 0 || o >= out_len) continue;
    float y = 0.f;
    if (s < istft_len) {
      float env;
      if (jj - r + 1 >= 0 && jj < n_frames) {
        env = __ldg(env_int + q);
      } else {
        env = 0.f;  // frames in ascending t, as the table sums them
        for (int i = r - 1; i >= 0; --i) {
          const int t = jj - i;
          if (t >= 0 && t < n_frames) env += __ldg(wsq + i * hop + q);
        }
      }
      y = acc[l] / (env > env_floor ? env : 1.f);
    }
    out[(long long)b * out_len + o] = y;
  }
}

}  // namespace

// re/im/mask: (rows, n_frames, n_bins) f32; post, wsq: (r * hop,) f32;
// env_int: (hop,) f32; tw: (n_fft,) complex f32; out: (rows, out_len) f32.
// run * hop must not exceed 8192. Returns cudaGetLastError() after the
// launch.
extern "C" int nr_istft_fft(const float* re, const float* im, const float* mask,
                            int rows, int n_frames, int n_bins, int n_fft,
                            int hop, int r, int bpad, int j0, int n_out,
                            int run, long long out_off, long long out_len,
                            long long istft_len, float env_floor,
                            const float* post, const float* wsq,
                            const float* env_int, const float* tw, float* out,
                            void* stream) {
  int log2m = 0;
  while ((2 << log2m) < n_fft) ++log2m;
  if ((2 << log2m) != n_fft || n_fft < 64 || n_fft > 2 * nrf::ELEMS || run < 1 ||
      (long long)run * hop > 8192)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_out <= 0) return (int)cudaGetLastError();
  const int n_runs = (n_out + run - 1) / run;
  const int G = nrf::ELEMS >> log2m;
  const size_t smem =
      sizeof(float2) * (nrf::PADDED + G) + sizeof(float) * (size_t)run * hop;
  cudaError_t err = cudaFuncSetAttribute(
      istft_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  istft_fft_kernel<<<(unsigned)((long long)rows * n_runs), nrf::THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      re, im, mask, n_frames, n_bins, log2m, hop, r, bpad, j0, n_out, run,
      n_runs, out_off, out_len, istft_len, env_floor, post, wsq, env_int,
      reinterpret_cast<const float2*>(tw), out);
  return (int)cudaGetLastError();
}
