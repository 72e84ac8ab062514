// The routes of kernels A and D by n_fft, and the chirp-z lengths they
// take: plain C++ (no CUDA), included by fft_smem.cuh. geometry.py's
// fft_route and chirp_length state the same rules; tests/test_torch_fft.py
// compiles this header with the host compiler and holds the two to each
// other over every n_fft from 1 to 16384.
//
// A frame's transform has n complex points: n_fft / 2 for an even n_fft
// (the even samples real, the odd imaginary), n_fft for an odd one (two
// frames a transform, one real, one imaginary).
// - FFT route: n has no prime factor above 13; direct mixed-radix stages.
// - chirp route: any other n for which a chirp-z length L >= 2n - 1 fits a
//   block of BIG_SLOTS points; the transform as a circular convolution of
//   length L.
// - product route (the DFT products of spectra.cu / istft_ola.cu): n_fft
//   below MIN_NFFT or above MAX_NFFT, and an odd n_fft above 4096 with a
//   prime factor above 13.
#pragma once

namespace nrf {

enum Route { ROUTE_PRODUCT = 0, ROUTE_FFT = 1, ROUTE_CHIRP = 2 };

constexpr int MIN_NFFT = 64, MAX_NFFT = 8192;
constexpr int BLOCK_SLOTS = 4096;  // complex points a block holds
constexpr int BIG_SLOTS = 8192;    // ... a big block (one slot of 4097 to 8192 points)

// n with every factor in primes[0 .. count) divided out
inline int strip(int n, const int* primes, int count) {
  for (int i = 0; i < count; ++i)
    while (n % primes[i] == 0) n /= primes[i];
  return n;
}

inline bool smooth13(int n) {
  const int p[] = {2, 3, 5, 7, 11, 13};
  return strip(n, p, 6) == 1;
}

inline bool smooth7(int n) {
  const int p[] = {2, 3, 5, 7};
  return strip(n, p, 4) == 1;
}

// complex points of one frame's transform
inline int fft_n(int n_fft) { return n_fft % 2 ? n_fft : n_fft / 2; }

inline Route route_of(int n_fft) {
  if (n_fft < MIN_NFFT || n_fft > MAX_NFFT) return ROUTE_PRODUCT;
  const int n = fft_n(n_fft);
  if (smooth13(n)) return ROUTE_FFT;
  return 2 * n - 1 <= BIG_SLOTS ? ROUTE_CHIRP : ROUTE_PRODUCT;
}

// Whether the real-FFT kernels (spectra_fft.cu, istft_fft.cu) serve n_fft:
// even, its half 2^k 3^a 5^b 7^c. The complex-frame kernels
// (spectra_cplx.cu, istft_cplx.cu) serve the rest of the FFT and chirp routes.
inline bool real_kernel(int n_fft) {
  return route_of(n_fft) == ROUTE_FFT && n_fft % 2 == 0 && smooth7(n_fft / 2);
}

// Whether a kernel takes L as n's chirp-z length: L >= 2n - 1, 2^a 3^b
// within a block, BIG_SLOTS past it (geometry.py::chirp_length picks the
// smallest such L).
inline bool chirp_length_ok(int n, int L) {
  const int p[] = {2, 3};
  if (L < 2 * n - 1) return false;
  return L <= BLOCK_SLOTS ? strip(L, p, 2) == 1 : L == BIG_SLOTS;
}

}  // namespace nrf
