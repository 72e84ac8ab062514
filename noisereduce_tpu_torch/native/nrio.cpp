// nrio — native IO runtime for noisereduce_tpu.
//
// The reference framework is pure Python; its "runtime" around the DSP is
// joblib + np.memmap (reference spectralgate/base.py:167-226). Here the
// host-side runtime around the XLA compute path is native: a WAV codec
// (PCM16 / PCM24 / PCM32 / float32), dtype conversion, and a streaming
// chunker that hands out halo'd chunk views from a ring buffer so audio can
// be fed to the TPU in fixed-shape batches without Python-loop overhead.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C native   (produces noisereduce_tpu/_native/libnrio.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define NRIO_API extern "C" __attribute__((visibility("default")))

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits_per_sample = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  uint64_t n_frames = 0;
  uint64_t data_offset = 0;
  uint64_t data_bytes = 0;
};

bool parse_wav_header(FILE* f, WavInfo* info) {
  char tag[4];
  uint32_t riff_size;
  if (fread(tag, 1, 4, f) != 4) return false;
  // RF64 (EBU Tech 3306): 64-bit sizes live in a ds64 chunk; the 32-bit
  // RIFF/data size fields are 0xFFFFFFFF placeholders.
  const bool rf64 = memcmp(tag, "RF64", 4) == 0;
  if (!rf64 && memcmp(tag, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return false;

  bool have_fmt = false;
  uint64_t ds64_data_bytes = 0;
  while (true) {
    uint32_t chunk_size;
    if (fread(tag, 1, 4, f) != 4) break;
    if (fread(&chunk_size, 4, 1, f) != 1) break;
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t rate, byte_rate;
      uint16_t block_align, bits;
      if (chunk_size < 16) return false;
      if (fread(&fmt, 2, 1, f) != 1) return false;
      if (fread(&ch, 2, 1, f) != 1) return false;
      if (fread(&rate, 4, 1, f) != 1) return false;
      if (fread(&byte_rate, 4, 1, f) != 1) return false;
      if (fread(&block_align, 2, 1, f) != 1) return false;
      if (fread(&bits, 2, 1, f) != 1) return false;
      if (fmt == 0xFFFE && chunk_size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t ext_size, valid_bits;
        uint32_t channel_mask;
        if (fread(&ext_size, 2, 1, f) != 1) return false;
        if (fread(&valid_bits, 2, 1, f) != 1) return false;
        if (fread(&channel_mask, 4, 1, f) != 1) return false;
        uint8_t guid[16];
        if (fread(guid, 1, 16, f) != 16) return false;
        fmt = guid[0] | (guid[1] << 8);
        // odd-sized chunks carry a pad byte, like the generic skip below
        fseek(f, (long)(chunk_size - 40 + (chunk_size & 1)), SEEK_CUR);
      } else {
        fseek(f, (long)(chunk_size - 16 + (chunk_size & 1)), SEEK_CUR);
      }
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = rate;
      info->bits_per_sample = bits;
      have_fmt = true;
    } else if (memcmp(tag, "ds64", 4) == 0) {
      if (chunk_size < 24) return false;
      uint64_t riff64, data64, samples64;
      if (fread(&riff64, 8, 1, f) != 1) return false;
      if (fread(&data64, 8, 1, f) != 1) return false;
      if (fread(&samples64, 8, 1, f) != 1) return false;
      ds64_data_bytes = data64;
      fseek(f, (long)(chunk_size - 24 + (chunk_size & 1)), SEEK_CUR);
    } else if (memcmp(tag, "data", 4) == 0) {
      info->data_offset = (uint64_t)ftell(f);
      info->data_bytes = (rf64 && chunk_size == 0xFFFFFFFFu)
                             ? ds64_data_bytes
                             : (uint64_t)chunk_size;
      if (!have_fmt) return false;
      uint32_t bytes_per_frame =
          (uint32_t)info->channels * (info->bits_per_sample / 8);
      if (bytes_per_frame == 0) return false;
      info->n_frames = info->data_bytes / bytes_per_frame;
      return true;
    } else {
      fseek(f, (long)(chunk_size + (chunk_size & 1)), SEEK_CUR);
    }
  }
  return false;
}

}  // namespace

// ---------------------------------------------------------------------------
// WAV info / read / write
// ---------------------------------------------------------------------------

// Returns 0 on success. out = [sample_rate, channels, bits, format, n_frames]
NRIO_API int nrio_wav_info(const char* path, int64_t out[5]) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_wav_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  out[0] = info.sample_rate;
  out[1] = info.channels;
  out[2] = info.bits_per_sample;
  out[3] = info.format;
  out[4] = (int64_t)info.n_frames;
  return 0;
}

// Read interleaved audio into a float32 buffer of n_frames*channels,
// converting from the on-disk sample format. start/frames select a frame
// range. Int formats are scaled to [-1, 1) by 2^(bits-1). Returns frames
// read, or negative on error.
NRIO_API int64_t nrio_wav_read_f32(const char* path, float* dst,
                                   int64_t start, int64_t frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav_header(f, &info)) {
    fclose(f);
    return -2;
  }
  const uint32_t ch = info.channels;
  const uint32_t bytes_per_sample = info.bits_per_sample / 8;
  const uint64_t bytes_per_frame = (uint64_t)ch * bytes_per_sample;
  if (start < 0) start = 0;
  if (start > (int64_t)info.n_frames) start = (int64_t)info.n_frames;
  if (frames < 0 || start + frames > (int64_t)info.n_frames)
    frames = (int64_t)info.n_frames - start;

  fseek(f, (long)(info.data_offset + (uint64_t)start * bytes_per_frame),
        SEEK_SET);
  const int64_t total = frames * (int64_t)ch;
  std::vector<uint8_t> raw((size_t)(total * bytes_per_sample));
  size_t got =
      fread(raw.data(), 1, (size_t)(total * bytes_per_sample), f);
  fclose(f);
  const int64_t n = (int64_t)(got / bytes_per_sample);

  if (info.format == 3 && info.bits_per_sample == 32) {
    memcpy(dst, raw.data(), (size_t)n * 4);
  } else if (info.format == 1 && info.bits_per_sample == 16) {
    const int16_t* src = (const int16_t*)raw.data();
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * scale;
  } else if (info.format == 1 && info.bits_per_sample == 32) {
    const int32_t* src = (const int32_t*)raw.data();
    const float scale = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * scale;
  } else if (info.format == 1 && info.bits_per_sample == 24) {
    const uint8_t* src = raw.data();
    const float scale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n; ++i) {
      int32_t v = (int32_t)(src[3 * i] | (src[3 * i + 1] << 8) |
                            (src[3 * i + 2] << 16));
      if (v & 0x800000) v |= (int32_t)0xFF000000;  // sign-extend
      dst[i] = v * scale;
    }
  } else if (info.format == 1 && info.bits_per_sample == 8) {
    const uint8_t* src = raw.data();
    for (int64_t i = 0; i < n; ++i) dst[i] = (src[i] - 128) / 128.0f;
  } else {
    return -3;
  }
  return n / (int64_t)ch;
}

// Raw int16 read (no conversion) — reference-parity path where callers want
// the int16 samples (reference tests read with scipy.io.wavfile).
NRIO_API int64_t nrio_wav_read_i16(const char* path, int16_t* dst,
                                   int64_t start, int64_t frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav_header(f, &info)) {
    fclose(f);
    return -2;
  }
  if (!(info.format == 1 && info.bits_per_sample == 16)) {
    fclose(f);
    return -3;
  }
  const uint32_t ch = info.channels;
  if (start < 0) start = 0;
  if (start > (int64_t)info.n_frames) start = (int64_t)info.n_frames;
  if (frames < 0 || start + frames > (int64_t)info.n_frames)
    frames = (int64_t)info.n_frames - start;
  fseek(f, (long)(info.data_offset + (uint64_t)start * ch * 2), SEEK_SET);
  size_t got = fread(dst, 2, (size_t)(frames * ch), f);
  fclose(f);
  return (int64_t)(got / ch);
}

// Write interleaved float32 [-1,1) as PCM16 (fmt=1) or float32 (fmt=3).
NRIO_API int nrio_wav_write(const char* path, const float* src,
                            int64_t frames, int32_t channels,
                            int32_t sample_rate, int32_t as_float) {
  const uint16_t fmt = as_float ? 3 : 1;
  const uint16_t bits = as_float ? 32 : 16;
  // Classic RIFF carries 32-bit sizes; anything larger would silently
  // truncate to a corrupt header. Refuse (rc=-2) — large streamed outputs
  // go through the Python WavWriter, which switches to RF64.
  const uint64_t data_bytes64 =
      (uint64_t)frames * (uint64_t)channels * (bits / 8);
  if (data_bytes64 > 0xFFFFFFFFull - 36) return -2;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t byte_rate = (uint32_t)sample_rate * channels * (bits / 8);
  const uint16_t block_align = (uint16_t)(channels * (bits / 8));
  const uint32_t data_bytes = (uint32_t)data_bytes64;
  const uint32_t riff = 36 + data_bytes;

  fwrite("RIFF", 1, 4, f);
  fwrite(&riff, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  uint32_t fmt_size = 16;
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  uint16_t ch16 = (uint16_t)channels;
  fwrite(&ch16, 2, 1, f);
  uint32_t sr = (uint32_t)sample_rate;
  fwrite(&sr, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);

  const int64_t n = frames * channels;
  if (as_float) {
    fwrite(src, 4, (size_t)n, f);
  } else {
    std::vector<int16_t> buf((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
      float v = src[i] * 32767.0f;
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32768.0f) v = -32768.0f;
      buf[(size_t)i] = (int16_t)v;
    }
    fwrite(buf.data(), 2, (size_t)n, f);
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming chunker: hands out halo'd fixed-size chunk batches from a file,
// deinterleaved to (channels, chunk + 2*padding) float32 — the exact shape
// the TPU graph consumes (reference chunk semantics: zero-fill outside the
// signal, spectralgate/base.py:130-148).
// ---------------------------------------------------------------------------

struct NrioStream {
  FILE* f = nullptr;
  WavInfo info;
  int64_t chunk = 0;
  int64_t padding = 0;
  int64_t pos = 0;  // next chunk start (frame index)
};

NRIO_API void* nrio_stream_open(const char* path, int64_t chunk,
                                int64_t padding) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new NrioStream();
  if (!parse_wav_header(f, &s->info)) {
    fclose(f);
    delete s;
    return nullptr;
  }
  s->f = f;
  s->chunk = chunk;
  s->padding = padding;
  return s;
}

NRIO_API int64_t nrio_stream_n_chunks(void* handle) {
  auto* s = (NrioStream*)handle;
  if (!s || s->info.n_frames == 0) return 0;
  return ((int64_t)s->info.n_frames - 1) / s->chunk + 1;
}

NRIO_API int nrio_stream_channels(void* handle) {
  return ((NrioStream*)handle)->info.channels;
}

NRIO_API int64_t nrio_stream_frames(void* handle) {
  return (int64_t)((NrioStream*)handle)->info.n_frames;
}

NRIO_API int nrio_stream_rate(void* handle) {
  return (int)((NrioStream*)handle)->info.sample_rate;
}

// Fill dst (channels, chunk + 2*padding) with the next halo'd chunk,
// deinterleaved, zero-filled outside the signal. Returns the chunk index
// filled, or -1 when exhausted.
NRIO_API int64_t nrio_stream_next(void* handle, float* dst) {
  auto* s = (NrioStream*)handle;
  const int64_t n = (int64_t)s->info.n_frames;
  if (s->pos >= n) return -1;
  const int64_t ich = s->pos / s->chunk;
  const int64_t view = s->chunk + 2 * s->padding;
  const int64_t ch = s->info.channels;

  const int64_t want_start = s->pos - s->padding;
  int64_t r_start = want_start < 0 ? 0 : want_start;
  int64_t r_end = want_start + view;
  if (r_end > n) r_end = n;
  const int64_t r_frames = r_end - r_start;

  memset(dst, 0, sizeof(float) * (size_t)(ch * view));
  if (r_frames > 0) {
    std::vector<float> inter((size_t)(r_frames * ch));
    // reuse the converting reader via a seek-window read
    // (duplicate a small amount of fread logic for efficiency)
    const uint32_t bps = s->info.bits_per_sample / 8;
    const uint64_t bpf = (uint64_t)ch * bps;
    fseek(s->f, (long)(s->info.data_offset + (uint64_t)r_start * bpf),
          SEEK_SET);
    std::vector<uint8_t> raw((size_t)(r_frames * (int64_t)bpf));
    size_t got = fread(raw.data(), 1, raw.size(), s->f);
    const int64_t nvals = (int64_t)(got / bps);
    if (s->info.format == 3 && s->info.bits_per_sample == 32) {
      memcpy(inter.data(), raw.data(), (size_t)nvals * 4);
    } else if (s->info.format == 1 && s->info.bits_per_sample == 16) {
      const int16_t* p = (const int16_t*)raw.data();
      const float sc = 1.0f / 32768.0f;
      for (int64_t i = 0; i < nvals; ++i) inter[(size_t)i] = p[i] * sc;
    } else {
      return -2;  // streaming supports PCM16/f32 (use nrio_wav_read_f32)
    }
    // deinterleave into the halo window
    const int64_t off = r_start - want_start;  // zeros before signal start
    for (int64_t t = 0; t < r_frames; ++t)
      for (int64_t c = 0; c < ch; ++c)
        dst[c * view + off + t] = inter[(size_t)(t * ch + c)];
  }
  s->pos += s->chunk;
  return ich;
}

// PCM16 sources only: fill dst (channels, chunk + 2*padding) with the next
// halo'd chunk as RAW int16 samples (no float conversion) — the device feed
// then ships HALF the bytes and the graph multiplies by 1/32768 on chip
// (exact: every int16 is f32-representable and 2^-15 is a power of two, so
// the product is bit-identical to the host conversion above). Returns the
// chunk index, -1 when exhausted, or -2 for non-PCM16 sources (callers fall
// back to the float32 stream).
NRIO_API int64_t nrio_stream_next_i16(void* handle, int16_t* dst) {
  auto* s = (NrioStream*)handle;
  if (!(s->info.format == 1 && s->info.bits_per_sample == 16)) return -2;
  const int64_t n = (int64_t)s->info.n_frames;
  if (s->pos >= n) return -1;
  const int64_t ich = s->pos / s->chunk;
  const int64_t view = s->chunk + 2 * s->padding;
  const int64_t ch = s->info.channels;

  const int64_t want_start = s->pos - s->padding;
  int64_t r_start = want_start < 0 ? 0 : want_start;
  int64_t r_end = want_start + view;
  if (r_end > n) r_end = n;
  const int64_t r_frames = r_end - r_start;

  memset(dst, 0, sizeof(int16_t) * (size_t)(ch * view));
  if (r_frames > 0) {
    const uint64_t bpf = (uint64_t)ch * 2;
    fseek(s->f, (long)(s->info.data_offset + (uint64_t)r_start * bpf),
          SEEK_SET);
    std::vector<int16_t> inter((size_t)(r_frames * ch));
    size_t got = fread(inter.data(), 2, inter.size(), s->f);
    const int64_t r_got = (int64_t)(got / (size_t)ch);
    const int64_t off = r_start - want_start;
    for (int64_t t = 0; t < r_got; ++t)
      for (int64_t c = 0; c < ch; ++c)
        dst[c * view + off + t] = inter[(size_t)(t * ch + c)];
  }
  s->pos += s->chunk;
  return ich;
}

// sample format probe: format * 100 + bits (e.g. 116 = PCM16, 332 = f32)
NRIO_API int nrio_stream_format(void* handle) {
  auto* s = (NrioStream*)handle;
  return (int)s->info.format * 100 + (int)s->info.bits_per_sample;
}

NRIO_API void nrio_stream_close(void* handle) {
  auto* s = (NrioStream*)handle;
  if (s) {
    if (s->f) fclose(s->f);
    delete s;
  }
}

// ---------------------------------------------------------------------------
// Fast dtype conversions (used by the Python wrapper when not reading files)
// ---------------------------------------------------------------------------
NRIO_API void nrio_i16_to_f32(const int16_t* src, float* dst, int64_t n,
                              float scale) {
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * scale;
}

NRIO_API void nrio_f32_to_i16(const float* src, int16_t* dst, int64_t n,
                              float scale) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i] * scale;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = (int16_t)v;
  }
}
