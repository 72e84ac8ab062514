// Kernel D, complex-frame kernels: mask apply, inverse FFT, overlap-add,
// envelope division and the output window, for the n_fft of the FFT route
// that istft_fft.cu does not serve (M with a factor 11 or 13, and every odd
// n_fft whose prime factors are at most 13) and for the chirp-z route
// (fft_route.cuh).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does; the TPU kernel takes any n_fft as a DFT product
// (noisereduce_tpu/ops/pallas/geometry.py:146).
//
// Computes what istft_fft.cu computes, with the same runs of output hop
// blocks, groups of frames, overlap-add in ascending frame order (the
// output is the same whatever the run), envelope and trim. A frame slot of
// T points holds one inverse transform of n complex points:
// - even N: n = M = N/2; Y = Z * mask (no imaginary DC or Nyquist part)
//   turned into Z' by fft_smem.cuh::unsplit, whose inverse holds
//   M (y[2m] + i y[2m+1]), as istft_fft.cu does;
// - odd N (PAIRED): n = N, two frames a slot, 2s and 2s + 1 (groups start
//   at an even frame, and a zero frame stands in past the last), so a
//   frame has the same partner in every run and the output does not depend
//   on the run: the Hermitian spectra of frames a and b as
//   W[k] = Y_a[k] + i Y_b[k], W[N-k] = conj Y_a[k] + i conj Y_b[k]
//   (k < (N + 1) / 2; the imaginary DC parts dropped), whose inverse holds
//   N (y_a + i y_b).
// On the FFT route T = n and the slot takes fft_smem.cuh's unscaled n-point
// inverse. On the chirp route T = L >= 2n - 1 and the inverse is
//   y_j = c_j sum_k (W_k c_k) cbar_{j-k},  c_j = e^{i pi j^2 / n},
// the conjugate of kernel A's: W times c (zero past n), the L-point FFT,
// times conj filt (FFT_L(cbar wrapped) / L), the unscaled inverse, and
// the first n points times c_j, from the same host tables as kernel A
// (conjugated here). post carries 1/n either way.
//
// Bound on this card: bytes, as istft_fft.cu, and its bf16 build as
// istft_fft.cu's. Design: as istft_fft.cu; a
// slot past 4096 points takes a big block of 1024 threads and 8192 points
// (fft_smem.cuh::Blk), one slot a group.
#include "fft_smem.cuh"
#include "planes.cuh"

namespace {

template <int ODD, bool PAIRED, bool CHIRP, bool BIG, class P>  // P: the plane type
__global__ void __launch_bounds__(nrf::Blk<BIG>::THREADS, nrf::min_blocks(ODD, BIG))
    istft_cplx_kernel(const P* __restrict__ re, const P* __restrict__ im,
                      const float* __restrict__ mask, int n_frames, int n_bins, int n,
                      int hop, int r, int bpad, int j0, int n_out, int run, int n_runs,
                      long long out_off, long long out_len, long long istft_len,
                      float env_floor, const float* __restrict__ post,
                      const float* __restrict__ wsq, const float* __restrict__ env_int,
                      const float2* __restrict__ tw, const float2* __restrict__ tws,
                      const float2* __restrict__ chirp, const float2* __restrict__ filt,
                      P* __restrict__ out, const nrf::Plan<ODD != 1> plan,
                      const nrf::Div<true> dh, const nrf::Div<true> dnb) {
  using B = nrf::Blk<BIG>;
  constexpr int FPS = PAIRED ? 2 : 1;  // frames a slot holds
  extern __shared__ __align__(16) float2 smem2[];
  const int T = plan.m.d;  // points a slot: n, or the chirp length
  // each segment of threads loads, transforms and inverts its own slots
  const nrf::Seg sg = nrf::segment(plan);
  const int S = plan.segs * plan.fps;  // slots a group holds
  const int G = FPS * S;               // frames a group holds
  float2* z = smem2;
  float2* nyq = z + B::PADDED;  // Y[M] of each slot (even N)
  float* acc = reinterpret_cast<float*>(nyq + S);
  const float* zf = reinterpret_cast<const float*>(z);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_runs;
  const int ja = j0 + (blockIdx.x - b * n_runs) * run;
  const int je = min(run, j0 + n_out - ja);
  const int n_acc = je * hop;
  for (int l = tid; l < n_acc; l += B::THREADS) acc[l] = 0.f;

  const int t_lo = max(0, ja - r + 1) & (PAIRED ? ~1 : ~0);  // even when PAIRED
  const int t_hi = min(n_frames - 1, ja + je - 1);
  const long long row = (long long)b * n_frames * n_bins;
  for (int tg = t_lo; tg <= t_hi; tg += G) {
    const int ge = min(G, t_hi - tg + 1);
    const int n_slots = (ge + FPS - 1) / FPS;
    const int nf = nrf::seg_frames(sg, plan, n_slots);
    const int first = sg.f0 * T;  // the segment's first point
    // the segment's frames, along their contiguous rows
    const long long o0 = row + (long long)(tg + FPS * sg.f0) * n_bins;
    if constexpr (PAIRED) {
      // slot bin k: W[k] and W[N - k] from bin k of frames a and b
      for (int e = sg.lane; e < nf * n_bins; e += plan.threads) {
        const int sl = dnb.div(e);
        const int k = e - sl * n_bins;
        const long long oa = o0 + (long long)(FPS - 1) * sl * n_bins + e;
        const float ma = __ldg(mask + oa);
        const float2 ya =
            make_float2(planes::ld(re + oa) * ma, k ? planes::ld(im + oa) * ma : 0.f);
        float2 yb = make_float2(0.f, 0.f);
        if (tg + FPS * (sg.f0 + sl) + 1 < n_frames) {
          const float mb = __ldg(mask + oa + n_bins);
          yb = make_float2(planes::ld(re + oa + n_bins) * mb,
                           k ? planes::ld(im + oa + n_bins) * mb : 0.f);
        }
        const int base = first + sl * T;
        float2 w = make_float2(ya.x - yb.y, ya.y + yb.x);
        if constexpr (CHIRP) w = nrf::cmul(w, nrf::conj(__ldg(chirp + k)));
        z[nrf::pad(base + k)] = w;
        if (k) {
          w = make_float2(ya.x + yb.y, yb.x - ya.y);
          if constexpr (CHIRP) w = nrf::cmul(w, nrf::conj(__ldg(chirp + n - k)));
          z[nrf::pad(base + n - k)] = w;
        }
      }
    } else {
      // Y = Z * mask
      for (int e = sg.lane; e < nf * n_bins; e += plan.threads) {
        const int sl = dnb.div(e);
        const int k = e - sl * n_bins;
        const float mk = __ldg(mask + o0 + e);
        const float2 y = make_float2(planes::ld(re + o0 + e) * mk,
                                     (k == 0 || k == n) ? 0.f : planes::ld(im + o0 + e) * mk);
        if (k < n)
          z[nrf::pad(first + sl * T + k)] = y;
        else
          nyq[sg.f0 + sl] = y;
      }
    }
    if constexpr (CHIRP) {  // zero past n
      for (int e = sg.lane; e < nf * T; e += plan.threads)
        if (e - plan.m.div(e) * T >= n) z[nrf::pad(first + e)] = make_float2(0.f, 0.f);
    }
    nrf::seg_sync(sg, plan);
    if constexpr (!PAIRED) {
      // pre-step, in place: pair (k, n - k) (k = 0: with Y[M], and n/2 for
      // an even n), times c_k on the chirp route
      for (int e = sg.lane; e < nf * dh.d; e += plan.threads) {
        const int sl = dh.div(e);
        const int k = e - sl * dh.d;
        const int base = first + sl * T;
        const int lk = nrf::pad(base + k);
        const int lm = nrf::pad(base + n - k);
        float2 lo, hi;
        nrf::unsplit(z[lk], k == 0 ? nyq[sg.f0 + sl] : z[lm], __ldg(tws + k), lo, hi);
        if constexpr (CHIRP) lo = nrf::cmul(lo, nrf::conj(__ldg(chirp + k)));
        z[lk] = lo;
        if (k != 0) {
          if constexpr (CHIRP) hi = nrf::cmul(hi, nrf::conj(__ldg(chirp + n - k)));
          z[lm] = hi;
        } else if (!(n & 1)) {
          const int lh = nrf::pad(base + n / 2);
          nrf::unsplit(z[lh], z[lh], __ldg(tws + n / 2), lo, hi);
          if constexpr (CHIRP) lo = nrf::cmul(lo, nrf::conj(__ldg(chirp + n / 2)));
          z[lh] = lo;
        }
      }
      nrf::seg_sync(sg, plan);
    }

    if constexpr (CHIRP) {
      nrf::fft_frames<false, ODD>(z, T, n_slots, tw, sg, plan);
      for (int e = sg.lane; e < nf * T; e += plan.threads) {
        const int l = nrf::pad(first + e);
        z[l] = nrf::cmul(z[l], nrf::conj(__ldg(filt + (e - plan.m.div(e) * T))));
      }
      nrf::seg_sync(sg, plan);
      nrf::fft_frames<true, ODD>(z, T, n_slots, tw, sg, plan);
      for (int e = sg.lane; e < nf * T; e += plan.threads) {
        const int q = e - plan.m.div(e) * T;
        if (q < n) {
          const int l = nrf::pad(first + e);
          z[l] = nrf::cmul(z[l], nrf::conj(__ldg(chirp + q)));
        }
      }
    } else {
      nrf::fft_frames<true, ODD>(z, T, n_slots, tw, sg, plan);
    }
    __syncthreads();  // the overlap-add reads every slot of the group

    // overlap-add: sample l (hop block ja + l/hop) takes frames
    // t in [jj - r + 1, jj] of this group, ascending; y_t[u] is float u of
    // frame t's slot (even N), or the real (a) or imaginary (b) part of
    // point u of its slot (PAIRED)
    const int l_lo = max(0, (tg - ja) * hop);
    const int l_hi = min(n_acc, (tg + ge - 1 - ja + r) * hop);
    for (int l = (l_lo / B::THREADS) * B::THREADS + tid; l < l_hi; l += B::THREADS) {
      if (l < l_lo) continue;
      const int jb = l / hop;
      const int q = l - jb * hop;
      const int jj = ja + jb;
      const int ta = max(tg, jj - r + 1);
      const int tb = min(tg + ge - 1, jj);
      float a = acc[l];
      for (int t = ta; t <= tb; ++t) {
        const int u = (jj - t) * hop + q;
        const int f = t - tg;
        const float y = PAIRED ? zf[2 * nrf::pad((f >> 1) * T + u) + (f & 1)]
                               : zf[2 * nrf::pad(f * T + (u >> 1)) + (u & 1)];
        a = fmaf(__ldg(post + u), y, a);
      }
      acc[l] = a;
    }
    __syncthreads();  // before the next group overwrites the slots
  }

  // envelope division and the trimmed output window
  for (int l = tid; l < n_acc; l += B::THREADS) {
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
    planes::st(out + (long long)b * out_len + o, y);
  }
}

}  // namespace

// plane: the type of re, im and out (planes.cuh: 0 float32, 1 bfloat16);
// re/im: (rows, n_frames, n_bins); mask: the same, f32; post, wsq: (r *
// hop,) f32; env_int: (hop,) f32; tw: (2 slot,) complex f32, the core's
// table; tws: (n_fft,) complex f32, the unsplit's (even n_fft); chirp: (n,)
// complex f32 and filt: (slot,) complex f32 on the chirp route, else null;
// out: (rows, out_len). slot as nr_spectra_cplx takes it, seg_warps a
// segment of warps that holds a slot, and run * hop at most 8192. Returns
// cudaGetLastError() after the launch.
extern "C" int nr_istft_cplx(int plane, const void* re, const void* im, const float* mask,
                             int rows, int n_frames, int n_bins, int n_fft, int slot,
                             int seg_warps, int hop, int r, int bpad, int j0,
                             int n_out, int run, long long out_off, long long out_len,
                             long long istft_len, float env_floor,
                             const float* post, const float* wsq,
                             const float* env_int, const float* tw, const float* tws,
                             const float* chirp, const float* filt, void* out,
                             void* stream) {
  const int n = nrf::fft_n(n_fft);
  const bool paired = n_fft % 2, big = slot > nrf::ELEMS;
  const int block_warps = big ? nrf::Blk<true>::WARPS : nrf::WARPS;
  const int S = nrf::fft_block_frames(seg_warps, slot, block_warps);
  if (!nrf::cplx_slot_ok(n_fft, slot) || (slot != n && (!chirp || !filt)) || S < 1 ||
      run < 1 || (long long)run * hop > 8192)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n_out <= 0) return (int)cudaGetLastError();
  const int n_runs = (n_out + run - 1) / run;
  return planes::with_plane(plane, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return nrf::with_cplx_build(n_fft, slot, [&](auto odd, auto pr, auto ch, auto bg) {
      constexpr int ODD = decltype(odd)::value;
      constexpr bool BIG = decltype(bg)::value;
      using Bk = nrf::Blk<BIG>;
      const size_t smem =
          sizeof(float2) * (Bk::PADDED + S) + sizeof(float) * (size_t)run * hop;
      const auto kernel =
          istft_cplx_kernel<ODD, decltype(pr)::value, decltype(ch)::value, BIG, T>;
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(unsigned)((long long)rows * n_runs), Bk::THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(re), static_cast<const T*>(im), mask, n_frames, n_bins, n,
          hop, r, bpad, j0, n_out, run, n_runs, out_off, out_len, istft_len, env_floor,
          post, wsq, env_int, reinterpret_cast<const float2*>(tw),
          reinterpret_cast<const float2*>(tws), reinterpret_cast<const float2*>(chirp),
          reinterpret_cast<const float2*>(filt), static_cast<T*>(out),
          nrf::make_plan<ODD != 1>(slot, seg_warps, Bk::WARPS),
          nrf::Div<true>(paired ? n_bins : (n + 1) / 2), nrf::Div<true>(n_bins));
      return (int)cudaGetLastError();
    });
  });
}
