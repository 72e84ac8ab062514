// Kernel D, cluster route (istft_cluster.cuh): the builds and entries of
// an n_fft whose transform's n has no prime factor above 13 and a cluster
// shape past a block (fft_route.cuh: n from 4097 to 65,536 points, e.g.
// n_fft 12000, 16384 and 40000 at 48 kHz, odd 4851).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does (istft_cluster.cuh has the design and the bound).
#include "istft_cluster.cuh"

// plane: the type of re, im and out (planes.cuh: 0 float32, 1 bfloat16);
// re/im: (rows, n_frames, n_bins); mask: the same, f32; post, wsq: (r *
// hop,) f32; env_int: (hop,) f32; tw1, tw2: (2 n1,), (2 n2,) complex f32,
// the stages' tables; twn: (n,) complex f32, e^{-2 pi i k / n}; tws:
// (n_fft,) complex f32, the unsplit's (even n_fft); y: the scratch, (rows,
// n_fr, r * hop) f32, frames t_lo to t_lo + n_fr - 1 (geometry.py::
// cluster_frames: the frames of hop blocks j0 to j0 + n_out - 1, t_lo even
// for an odd n_fft); out: (rows, out_len). The cluster shape comes from
// n_fft (fft_route.cuh::cluster_shape). Returns the first launch error.
extern "C" int nr_istft_cluster(int plane, const void* re, const void* im, const float* mask,
                                int rows, int n_frames, int n_bins, int n_fft, int hop, int r,
                                int bpad, int j0, int n_out, long long out_off,
                                long long out_len, long long istft_len, float env_floor,
                                const float* post, const float* wsq, const float* env_int,
                                const float* tw1, const float* tw2, const float* twn,
                                const float* tws, float* y, int t_lo, int n_fr, void* out,
                                void* stream) {
  return istft_cluster_launch<false>(plane, re, im, mask, rows, n_frames, n_bins, n_fft, hop,
                                     r, bpad, j0, n_out, out_off, out_len, istft_len,
                                     env_floor, post, wsq, env_int, nrf::fft_n(n_fft), tw1, tw2,
                                     twn, tws, nullptr, nullptr, y, t_lo, n_fr, out, stream);
}

// Clusters of kernel D's transform pass for n_fft (plane type `plane`)
// that the current device holds at once; a negative CUDA error code on
// failure.
extern "C" int nr_istft_cluster_capacity(int plane, int n_fft) {
  return istft_cluster_capacity<false>(plane, n_fft, nrf::fft_n(n_fft));
}
