// nrcopy — the host's copy of a signal's slab into a pinned slot, for the
// staged transfer of noisereduce_tpu_torch (parallel/host_copy.py).
//
// A slab is every row's samples [a, b) of a strided source: row r's sample
// i lies at src[r] + i * stride[r] bytes. The copy writes them into rows of
// a destination (dst + r * dst_row bytes), in the source's own type or, for
// float64 into float32, rounded to nearest even as the card's cast rounds.
// A persistent pool of threads splits the slab into parts and takes them
// one by one, so a thread that the host runs late takes fewer. Where the
// destination is 16-byte aligned the stores are non-temporal (its unaligned
// head and the tail are not): a normal store reads the destination's line
// before it writes it, so the copy would move three passes over host
// memory, not two. The pool's threads can be bound to a set of CPUs (the
// card's NUMA node).
//
// Exposed as a plain C ABI for ctypes, which releases the GIL around each
// call. Built by utils/io.py::build_library with g++ at first use.

#include <pthread.h>
#include <sched.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <emmintrin.h>
#define NRC_X86 1
#else
#define NRC_X86 0
#endif

#define NRC_API extern "C" __attribute__((visibility("default")))

namespace {

using PartFn = void (*)(const void* ctx, int64_t part);

#if NRC_X86
// round to nearest even, no flush to zero, every exception masked: the
// float64 -> float32 cast of IEEE 754, whatever the calling thread had set
constexpr unsigned kMxcsr = 0x1F80;

struct DefaultFp {
  unsigned saved = _mm_getcsr();
  DefaultFp() { _mm_setcsr(kMxcsr); }
  ~DefaultFp() { _mm_setcsr(saved); }
};
#else
struct DefaultFp {};
#endif

// Made once for the life of the process (never destroyed: its threads wait
// for the next job until the process ends).
class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) threads_.emplace_back([this] { run(); });
  }

  // pin every thread to the CPUs of `cpus`; 0 or the error number
  int bind(const int* cpus, int n) {
    cpu_set_t set;
    CPU_ZERO(&set);
    for (int i = 0; i < n; ++i) CPU_SET(cpus[i], &set);
    for (auto& t : threads_) {
      int rc = pthread_setaffinity_np(t.native_handle(), sizeof(set), &set);
      if (rc != 0) return rc;
    }
    return 0;
  }

  // fn(ctx, p) for every p in [0, n), spread over the threads; returns
  // when every part is done and no thread still holds the job
  void exec(PartFn fn, const void* ctx, int64_t n) {
    std::lock_guard<std::mutex> one(call_);  // one job at a time
    std::unique_lock<std::mutex> lk(m_);
    fn_ = fn;
    ctx_ = ctx;
    n_ = n;
    done_ = 0;
    active_ = 0;
    next_.store(0, std::memory_order_relaxed);
    ++gen_;
    wake_.notify_all();
    finished_.wait(lk, [this] { return done_ == n_ && active_ == 0; });
    n_ = 0;  // a thread that wakes late finds no job
  }

 private:
  void run() {
#if NRC_X86
    _mm_setcsr(kMxcsr);
#endif
    uint64_t seen = 0;
    for (;;) {
      PartFn fn;
      const void* ctx;
      int64_t n;
      {
        std::unique_lock<std::mutex> lk(m_);
        wake_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        if (n_ == 0) continue;
        ++active_;
        fn = fn_;
        ctx = ctx_;
        n = n_;
      }
      int64_t did = 0;
      for (int64_t p; (p = next_.fetch_add(1, std::memory_order_relaxed)) < n; ++did)
        fn(ctx, p);
      std::lock_guard<std::mutex> lk(m_);
      done_ += did;
      if (--active_ == 0 && done_ == n_) finished_.notify_one();
    }
  }

  std::vector<std::thread> threads_;
  std::mutex call_, m_;
  std::condition_variable wake_, finished_;
  uint64_t gen_ = 0;
  PartFn fn_ = nullptr;
  const void* ctx_ = nullptr;
  int64_t n_ = 0, done_ = 0;
  int active_ = 0;
  std::atomic<int64_t> next_{0};
};

template <int N>
struct Bits {
  unsigned char b[N];
};

template <class T>
inline T load(const char* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// n samples of T from s (stride bytes apart) into d
template <class T>
void copy_run(const char* s, int64_t stride, T* d, int64_t n) {
  int64_t i = 0;
#if NRC_X86
  constexpr int64_t k = 16 / sizeof(T);
  while (i < n && !aligned16(d + i)) {
    d[i] = load<T>(s + i * stride);
    ++i;
  }
  if (stride == static_cast<int64_t>(sizeof(T))) {
    const char* p = s + i * stride;
    for (; i + 4 * k <= n; i += 4 * k, p += 64) {
      __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
      __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 16));
      __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 32));
      __m128i e = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 48));
      _mm_stream_si128(reinterpret_cast<__m128i*>(d + i), a);
      _mm_stream_si128(reinterpret_cast<__m128i*>(d + i + k), b);
      _mm_stream_si128(reinterpret_cast<__m128i*>(d + i + 2 * k), c);
      _mm_stream_si128(reinterpret_cast<__m128i*>(d + i + 3 * k), e);
    }
  }
  for (; i + k <= n; i += k) {  // a 16-byte block gathered, then streamed
    alignas(16) T blk[k];
    for (int64_t j = 0; j < k; ++j) blk[j] = load<T>(s + (i + j) * stride);
    _mm_stream_si128(reinterpret_cast<__m128i*>(d + i),
                     _mm_load_si128(reinterpret_cast<const __m128i*>(blk)));
  }
#endif
  if (stride == static_cast<int64_t>(sizeof(T))) {
    std::memcpy(d + i, s + i * stride, (n - i) * sizeof(T));
    return;
  }
  for (; i < n; ++i) d[i] = load<T>(s + i * stride);
}

// n float64 samples from s (stride bytes apart) into float32 d
void cast_run(const char* s, int64_t stride, float* d, int64_t n) {
  int64_t i = 0;
#if NRC_X86
  while (i < n && !aligned16(d + i)) {
    d[i] = static_cast<float>(load<double>(s + i * stride));
    ++i;
  }
  if (stride == 8) {
    const double* p = reinterpret_cast<const double*>(s) + i;
    for (; i + 8 <= n; i += 8, p += 8) {
      __m128 lo = _mm_movelh_ps(_mm_cvtpd_ps(_mm_loadu_pd(p)), _mm_cvtpd_ps(_mm_loadu_pd(p + 2)));
      __m128 hi = _mm_movelh_ps(_mm_cvtpd_ps(_mm_loadu_pd(p + 4)),
                                _mm_cvtpd_ps(_mm_loadu_pd(p + 6)));
      _mm_stream_ps(d + i, lo);
      _mm_stream_ps(d + i + 4, hi);
    }
  }
  for (; i + 4 <= n; i += 4) {
    alignas(16) float blk[4];
    for (int j = 0; j < 4; ++j) blk[j] = static_cast<float>(load<double>(s + (i + j) * stride));
    _mm_stream_ps(d + i, _mm_load_ps(blk));
  }
#endif
  for (; i < n; ++i) d[i] = static_cast<float>(load<double>(s + i * stride));
}

struct Copy {
  const int64_t* src;     // each row's sample a
  const int64_t* stride;  // bytes between a row's samples
  char* dst;
  int64_t dst_row;  // bytes between the destination's rows
  int64_t w, step, per_row;
  int src_size, dst_size;
};

void copy_part(const void* ctx, int64_t part) {
  const Copy& c = *static_cast<const Copy*>(ctx);
  const int64_t r = part / c.per_row;
  const int64_t s = (part % c.per_row) * c.step;
  const int64_t n = (c.w - s < c.step) ? c.w - s : c.step;
  const int64_t stride = c.stride[r];
  const char* src = reinterpret_cast<const char*>(c.src[r]) + s * stride;
  char* dst = c.dst + r * c.dst_row + s * c.dst_size;
  if (c.src_size == 8 && c.dst_size == 4) {
    cast_run(src, stride, reinterpret_cast<float*>(dst), n);
  } else {
    switch (c.src_size) {
      case 1: copy_run(src, stride, reinterpret_cast<Bits<1>*>(dst), n); break;
      case 2: copy_run(src, stride, reinterpret_cast<Bits<2>*>(dst), n); break;
      case 4: copy_run(src, stride, reinterpret_cast<Bits<4>*>(dst), n); break;
      case 8: copy_run(src, stride, reinterpret_cast<Bits<8>*>(dst), n); break;
      default: copy_run(src, stride, reinterpret_cast<Bits<16>*>(dst), n); break;
    }
  }
#if NRC_X86
  _mm_sfence();  // the streamed lines reach memory before the job ends
#endif
}

}  // namespace

NRC_API void* nrc_pool_new(int threads) {
  try {
    return new Pool(threads < 1 ? 1 : threads);
  } catch (...) {
    return nullptr;
  }
}

NRC_API int nrc_pool_bind(void* pool, const int* cpus, int n) {
  return static_cast<Pool*>(pool)->bind(cpus, n);
}

// Every row's w samples from src[r] (stride[r] bytes apart) into row r of
// dst (dst_row bytes apart), in parts of at most `step` samples of one row.
// src_size == dst_size copies the samples' bytes; 8 -> 4 casts float64 to
// float32. A single part runs on the calling thread. 0, or -1 for sizes it
// does not take.
NRC_API int nrc_copy(void* pool, int rows, const int64_t* src, const int64_t* stride,
                     int src_size, int dst_size, void* dst, int64_t dst_row, int64_t w,
                     int64_t step) {
  const bool cast = src_size == 8 && dst_size == 4;
  const bool same = src_size == dst_size &&
                    (src_size == 1 || src_size == 2 || src_size == 4 || src_size == 8 ||
                     src_size == 16);
  if (!cast && !same) return -1;
  if (rows <= 0 || w <= 0) return 0;
  if (step < 1) step = 1;
  const int64_t per_row = (w + step - 1) / step;
  Copy c{src, stride, static_cast<char*>(dst), dst_row, w, step, per_row, src_size, dst_size};
  const int64_t parts = per_row * rows;
  if (parts == 1) {
    DefaultFp fp;
    copy_part(&c, 0);
  } else {
    static_cast<Pool*>(pool)->exec(copy_part, &c, parts);
  }
  return 0;
}
