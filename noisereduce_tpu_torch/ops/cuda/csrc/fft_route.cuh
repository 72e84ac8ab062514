// The routes of kernels A and D by n_fft, the chirp-z lengths and the
// cluster shapes they take: plain C++ (no CUDA), included by fft_smem.cuh.
// geometry.py's fft_route, chirp_length and cluster_shape state the same
// rules; tests/test_torch_fft.py compiles this header with the host
// compiler and holds the two to each other over every n_fft from 1 to
// 262144.
//
// A frame's transform has n complex points: n_fft / 2 for an even n_fft
// (the even samples real, the odd imaginary), n_fft for an odd one (two
// frames a transform, one real, one imaginary).
// - FFT route: n has no prime factor above 13 and fits a block of
//   BLOCK_SLOTS points, or is below BIG_SLOTS points with no cluster shape
//   (a big block), or n has no prime factor above 31 (LARGE_RADICES) and
//   fits a block; direct mixed-radix stages in one block.
// - cluster route: n has no prime factor above 13 and a cluster shape,
//   past a block's BLOCK_SLOTS points to a cluster of at most MAX_CLUSTER
//   big blocks (cluster_shape): a four-step FFT, n = n1 n2, across the
//   blocks' shared memory (fft_cluster.cuh). Below BIG_SLOTS too: kernels
//   A and D together ran n_fft 12000 and 16380 in 41% and 60% of the big
//   block's time, and 8192 (n_fft 16384) A in two thirds and D in a third
//   (PERF.md).
// - chirp route: any other n for which a chirp-z length L >= 2n - 1 fits a
//   big block (n to 4096 with a prime factor above 31, 1101, 4106); the
//   transform as a circular convolution of length L.
// - cluster chirp route: any other n of at most CHIRP_MAX_N points (an n
//   with a prime factor above 13 past 4096 points, or a 13-smooth one past
//   a big block with no cluster shape): the chirp-z convolution over a
//   cluster chirp length L (cluster_chirp_length_ok), whose four-step FFT
//   runs across a cluster (fft_cluster.cuh::cluster_convolve).
// - global chirp route: any other n whose 2n - 1 fits GLOBAL_MAX_L (an n
//   past CHIRP_MAX_N points with no cluster shape, to 8,388,608 points):
//   the chirp-z convolution over a global chirp length L = L1 L2
//   (global_chirp_length_ok), a four-step FFT whose two factors each fit a
//   block, the exchange between its passes through device memory
//   (fft_global.cuh).
// An n past GLOBAL_MAX_L / 2 points has no route (ROUTE_NONE): no kernel
// takes it, and geometry.py's kernels_supported sends it to the staged
// twins. Every n_fft from 1 up to there has one: n of 1 to 31 points (an
// n_fft below 64) takes the FFT route, or the chirp route for an odd
// prime n_fft from 37 to 61.
#pragma once

namespace nrf {

enum Route {
  ROUTE_NONE = 0,
  ROUTE_FFT = 1,
  ROUTE_CHIRP = 2,
  ROUTE_CLUSTER = 3,
  ROUTE_CLUSTER_CHIRP = 4,
  ROUTE_GLOBAL_CHIRP = 5
};

constexpr int BLOCK_SLOTS = 4096;  // complex points a block holds
constexpr int BIG_SLOTS = 8192;    // ... a big block (one slot of 4097 to 8192 points)
constexpr int REAL_MAX_NFFT = 2 * BLOCK_SLOTS;  // the real-FFT kernels' largest n_fft
constexpr int MAX_CLUSTER = 8;     // blocks of a cluster (the portable most)
// the most points a cluster chirp takes: L >= 2n - 1 within MAX_CLUSTER big blocks
constexpr int CHIRP_MAX_N = MAX_CLUSTER * BIG_SLOTS / 2;
// the longest global chirp length: L1 = L2 = BLOCK_SLOTS
constexpr long long GLOBAL_MAX_L = (long long)BLOCK_SLOTS * BLOCK_SLOTS;

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

// no prime factor above 31: the radices 17, 19, 23, 29 and 31 beside 13's
inline bool smooth31(int n) {
  const int p[] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31};
  return strip(n, p, 11) == 1;
}

inline bool smooth7(int n) {
  const int p[] = {2, 3, 5, 7};
  return strip(n, p, 4) == 1;
}

// complex points of one frame's transform
inline int fft_n(int n_fft) { return n_fft % 2 ? n_fft : n_fft / 2; }

// The cluster route's shape for n points: c blocks and n = n1 n2 with c
// dividing both factors, so that each block holds n1 / c columns of n2
// points for the first step and n2 / c rows of n1 points for the last,
// n / c points either way, at most a big block's. The fewest blocks from 2
// to MAX_CLUSTER that hold n so, then the largest n1 <= n2. False for an
// n that fits a block's BLOCK_SLOTS, or where no c divides n as it must.
inline bool cluster_shape(int n, int& c, int& n1, int& n2) {
  if (n <= BLOCK_SLOTS) return false;
  for (c = 2; c <= MAX_CLUSTER; ++c) {
    if (n % (c * c) || n / c > BIG_SLOTS) continue;
    const int m = n / (c * c);
    int a = 1;
    for (int d = 1; d * d <= m; ++d)
      if (m % d == 0) a = d;
    n1 = c * a;
    n2 = c * (m / a);
    return true;
  }
  return false;
}

inline Route route_of(int n_fft) {
  const int n = fft_n(n_fft);
  int c, n1, n2;
  if (smooth13(n)) {
    if (cluster_shape(n, c, n1, n2)) return ROUTE_CLUSTER;
    if (n < BIG_SLOTS) return ROUTE_FFT;
  } else if (n <= BLOCK_SLOTS && smooth31(n)) {
    return ROUTE_FFT;
  } else if (2 * n - 1 <= BIG_SLOTS) {
    return ROUTE_CHIRP;
  }
  if (n <= CHIRP_MAX_N) return ROUTE_CLUSTER_CHIRP;
  return 2LL * n - 1 <= GLOBAL_MAX_L ? ROUTE_GLOBAL_CHIRP : ROUTE_NONE;
}

// Whether the real-FFT kernels (spectra_fft.cu, istft_fft.cu) serve n_fft:
// even, from 2 to REAL_MAX_NFFT, its half 2^k 3^a 5^b 7^c. The complex-frame
// kernels (spectra_cplx.cu, istft_cplx.cu) serve the rest of the FFT and
// chirp routes.
inline bool real_kernel(int n_fft) {
  return route_of(n_fft) == ROUTE_FFT && n_fft % 2 == 0 && n_fft <= REAL_MAX_NFFT &&
         smooth7(n_fft / 2);
}

// Whether L is a length of the cluster chirp route: 2^a 3^b 5^c (the
// cluster builds 1, 3, 5 and 15 of fft_cluster.cuh), past a big block,
// within MAX_CLUSTER big blocks, with a cluster shape.
inline bool cluster_chirp_length_ok(int L) {
  const int p[] = {2, 3, 5};
  int c, n1, n2;
  return L > BIG_SLOTS && L <= MAX_CLUSTER * BIG_SLOTS && strip(L, p, 3) == 1 &&
         cluster_shape(L, c, n1, n2);
}

// The global chirp route's split of L = L1 L2: L1 the largest divisor of
// L at most sqrt(L), so L2 >= L1 is the least cofactor. False where L2 does
// not fit a block (then no split of L does). Must match
// geometry.py::global_split.
inline bool global_split(int L, int& L1, int& L2) {
  L1 = 1;
  for (int d = 2; (long long)d * d <= L; ++d)
    if (L % d == 0) L1 = d;
  L2 = L / L1;
  return L2 <= BLOCK_SLOTS;
}

// Whether L is a length of the global chirp route: 2^a 3^b 5^c (the builds
// 1, 3, 5 and 15 of fft_cluster.cuh's stages) whose split fits two blocks.
inline bool global_chirp_length_ok(int L) {
  const int p[] = {2, 3, 5};
  int L1, L2;
  return L > 0 && strip(L, p, 3) == 1 && global_split(L, L1, L2);
}

// Whether a kernel takes L as n's chirp-z length: L >= 2n - 1; for an n
// whose 2n - 1 fits a big block, 2^a 3^b within a block, BIG_SLOTS past
// it; for a longer n to CHIRP_MAX_N, a cluster chirp length; past it a
// global chirp length (geometry.py::chirp_length picks the smallest such L).
inline bool chirp_length_ok(int n, int L) {
  const int p[] = {2, 3};
  if (L < 2 * n - 1) return false;
  if (n > CHIRP_MAX_N) return global_chirp_length_ok(L);
  if (2 * n - 1 > BIG_SLOTS) return cluster_chirp_length_ok(L);
  return L <= BLOCK_SLOTS ? strip(L, p, 2) == 1 : L == BIG_SLOTS;
}

}  // namespace nrf
