// Kernel D, cluster chirp route (istft_cluster.cuh, CHIRP): the builds
// and entries of an n_fft whose transform's n takes no other route and has
// at most 32,768 points (fft_route.cuh: n_fft 4801, 4803, 16386, 16940,
// ...): pass 1's inverse as a chirp-z transform whose L-point FFT runs
// across a thread block cluster, then the same overlap-add pass.
//
// Replaces: noisereduce_tpu/ops/pallas/kernels.py::_apply_istft_kernel
// (:736) and the envelope and trim of
// noisereduce_tpu/ops/pallas/dispatch.py::_scipy_istft_tail (:331), as
// istft_fft.cu does; before this route such an n_fft took the product
// route (since retired), whose tables and O(n_fft) work a sample do not
// scale (istft_cluster.cuh has the design and the bound).
#include "istft_cluster.cuh"

// The arguments of nr_istft_cluster (istft_cluster.cu), and slot: the
// chirp length L (fft_route.cuh::chirp_length_ok; the cluster shape comes
// from it), whose tables tw1, tw2 and twn (e^{-2 pi i k / L}) are; chirp
// and filt: kernel A's tables (spectra_cluster_chirp.cu), conjugated here.
// Returns the first launch error.
extern "C" int nr_istft_cluster_chirp(int plane, const void* re, const void* im,
                                      const float* mask, int rows, int n_frames, int n_bins,
                                      int n_fft, int hop, int r, int bpad, int j0, int n_out,
                                      long long out_off, long long out_len, long long istft_len,
                                      float env_floor, const float* post, const float* wsq,
                                      const float* env_int, int slot, const float* tw1,
                                      const float* tw2, const float* twn, const float* tws,
                                      const float* chirp, const float* filt, float* y, int t_lo,
                                      int n_fr, void* out, void* stream) {
  return istft_cluster_launch<true>(plane, re, im, mask, rows, n_frames, n_bins, n_fft, hop, r,
                                    bpad, j0, n_out, out_off, out_len, istft_len, env_floor,
                                    post, wsq, env_int, slot, tw1, tw2, twn, tws, chirp, filt, y,
                                    t_lo, n_fr, out, stream);
}

// Clusters of kernel D's chirp transform pass for n_fft and chirp length
// slot (plane type `plane`) that the current device holds at once; a
// negative CUDA error code on failure.
extern "C" int nr_istft_cluster_chirp_capacity(int plane, int n_fft, int slot) {
  return istft_cluster_capacity<true>(plane, n_fft, slot);
}
