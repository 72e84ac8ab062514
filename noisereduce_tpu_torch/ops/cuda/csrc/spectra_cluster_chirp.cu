// Kernel A, cluster chirp route (spectra_cluster.cuh, CHIRP): the builds
// and entries of an n_fft whose transform's n takes no other route and has
// at most 32,768 points (fft_route.cuh: an n with a prime factor above 13
// past 4096 points, such as n_fft 4801, 4803 or 16386, or a 13-smooth n
// past a big block with no cluster shape, such as 16940): a chirp-z
// transform whose L-point FFT runs across a thread block cluster.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_spectra_phases (:152),
// as spectra_fft.cu does; before this route such an n_fft took the
// DFT-product route (since retired), whose n_fft x n_fft table and O(n_fft) work
// a bin do not scale (spectra_cluster.cuh has the design and the bound).
#include "spectra_cluster.cuh"

// The arguments of nr_spectra_cluster (spectra_cluster.cu), and slot: the
// chirp length L (fft_route.cuh::chirp_length_ok; the cluster shape comes
// from it), whose tables tw1, tw2 and twn (e^{-2 pi i k / L}) are; chirp:
// (n,) complex f32, cbar_j = e^{-i pi (j^2 mod 2n) / n}; filt: (L,) complex
// f32, the filter spectrum FFT_L(c wrapped) / L in the four-step FFT's
// order (fft_cluster.cuh::cluster_convolve). Returns the launch's error
// code.
extern "C" int nr_spectra_cluster_chirp(int plane, const void* x, long long n_src, int rows,
                                        int n_chunks, long long chunk_stride,
                                        long long view_start, int view_len, int n_frames,
                                        int hop, int bpad, int win, int n_fft, int n_bins,
                                        int slot, const float* ws, const float* tw1,
                                        const float* tw2, const float* twn, const float* tws,
                                        const float* chirp, const float* filt, void* re,
                                        void* im, void* stream) {
  return spectra_cluster_launch<true>(plane, x, n_src, rows, n_chunks, chunk_stride,
                                      view_start, view_len, n_frames, hop, bpad, win, n_fft,
                                      n_bins, slot, ws, tw1, tw2, twn, tws, chirp, filt, re, im,
                                      stream);
}

// Clusters of kernel A's chirp build for n_fft and chirp length slot
// (plane type `plane`) that the current device holds at once; a negative
// CUDA error code on failure.
extern "C" int nr_spectra_cluster_chirp_capacity(int plane, int n_fft, int slot) {
  return spectra_cluster_capacity<true>(plane, n_fft, slot);
}
