// Kernel A, cluster route (spectra_cluster.cuh): the builds and entries of
// an n_fft whose transform's n has no prime factor above 13 and a cluster
// shape past a block (fft_route.cuh: n from 4097 to 65,536 points, e.g.
// n_fft 12000, 16384 and 40000 at 48 kHz, odd 4851).
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// as spectra_fft.cu does (spectra_cluster.cuh has the design and the
// bound).
#include "spectra_cluster.cuh"

// plane: the type of x, re and im (planes.cuh: 0 float32, 1 bfloat16); x:
// (rows, n_src); ws: (win,) f32; tw1, tw2: (2 n1,), (2 n2,) complex f32,
// the stages' tables of the n1- and n2-point FFTs; twn: (n,) complex f32,
// e^{-2 pi i k / n}; tws: (n_fft,) complex f32, the split's (even n_fft);
// re/im: (rows*n_chunks, n_frames, n_bins). The cluster shape comes from
// n_fft (fft_route.cuh::cluster_shape). Returns the launch's error code.
extern "C" int nr_spectra_cluster(int plane, const void* x, long long n_src, int rows,
                                  int n_chunks, long long chunk_stride, long long view_start,
                                  int view_len, int n_frames, int hop, int bpad, int win,
                                  int n_fft, int n_bins, const float* ws, const float* tw1,
                                  const float* tw2, const float* twn, const float* tws,
                                  void* re, void* im, void* stream) {
  return spectra_cluster_launch<false>(plane, x, n_src, rows, n_chunks, chunk_stride,
                                       view_start, view_len, n_frames, hop, bpad, win, n_fft,
                                       n_bins, nrf::fft_n(n_fft), ws, tw1, tw2, twn, tws,
                                       nullptr, nullptr, re, im, stream);
}

// Clusters of kernel A's build for n_fft (plane type `plane`) that the
// current device holds at once: the persistent grid of a launch with at
// least as many slots; a negative CUDA error code on failure.
extern "C" int nr_spectra_cluster_capacity(int plane, int n_fft) {
  return spectra_cluster_capacity<false>(plane, n_fft, nrf::fft_n(n_fft));
}
