// Native double-buffered IQ stream loader.
//
// The runtime ingests continuous IQ sample streams in planar
// re/im float32 blocks (complex at the device boundary is rejected by the
// production runtime — see yagi_tpu/utils/planar.py). This loader does the
// host-side IO work off the Python thread: a background reader thread
// fills a ring of pre-allocated planar buffers from an interleaved IQ
// capture file (cf32 / ci16 / cu8 wire formats), deinterleaving and
// scaling during the copy, so the Python pipeline only ever blocks when
// the disk cannot keep up with the device.
//
// The reference has no IO layer at all (yagi is a pure in-memory library);
// this is part of the runtime this framework adds (SURVEY.md §2.7).
//
// C ABI (ctypes-friendly, no C++ types across the boundary):
//   void* iql_open(const char* path, int format, long block_samples,
//                  int n_buffers);           // NULL on failure
//   long  iql_next(void* h, float* re, float* im);  // samples copied,
//                                            // 0 = EOF, -1 = error
//   long  iql_total_read(void* h);
//   void  iql_close(void* h);
//
// format: 0 = complex float32 interleaved
//         1 = complex int16 interleaved (scaled by 1/32768)
//         2 = complex uint8 offset-128 interleaved (scaled by 1/128)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum Format { kCf32 = 0, kCi16 = 1, kCu8 = 2 };

struct Buffer {
  std::vector<float> re, im;
  long n = 0;       // valid samples
  bool ready = false;
};

struct Loader {
  FILE* f = nullptr;
  int format = kCf32;
  long block = 0;
  std::vector<Buffer> ring;
  size_t head = 0;  // next buffer the consumer takes
  size_t tail = 0;  // next buffer the reader fills
  std::atomic<bool> eof{false};
  std::atomic<bool> stop{false};
  std::atomic<long> total{0};
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread reader;
  std::vector<unsigned char> raw;

  size_t sample_bytes() const {
    switch (format) {
      case kCi16: return 4;
      case kCu8: return 2;
      default: return 8;
    }
  }

  void convert(const unsigned char* src, long n, Buffer& b) {
    b.re.resize(block);
    b.im.resize(block);
    switch (format) {
      case kCf32: {
        const float* s = reinterpret_cast<const float*>(src);
        for (long i = 0; i < n; ++i) {
          b.re[i] = s[2 * i];
          b.im[i] = s[2 * i + 1];
        }
        break;
      }
      case kCi16: {
        const int16_t* s = reinterpret_cast<const int16_t*>(src);
        const float k = 1.0f / 32768.0f;
        for (long i = 0; i < n; ++i) {
          b.re[i] = k * s[2 * i];
          b.im[i] = k * s[2 * i + 1];
        }
        break;
      }
      case kCu8: {
        const float k = 1.0f / 128.0f;
        for (long i = 0; i < n; ++i) {
          b.re[i] = k * (static_cast<int>(src[2 * i]) - 128);
          b.im[i] = k * (static_cast<int>(src[2 * i + 1]) - 128);
        }
        break;
      }
    }
    b.n = n;
  }

  void run() {
    const size_t bytes = sample_bytes() * static_cast<size_t>(block);
    raw.resize(bytes);
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return stop.load() || !ring[tail].ready; });
      if (stop.load()) return;
      Buffer& b = ring[tail];
      lk.unlock();

      size_t got = fread(raw.data(), 1, bytes, f);
      long n = static_cast<long>(got / sample_bytes());
      convert(raw.data(), n, b);
      total += n;

      lk.lock();
      b.ready = true;
      bool at_eof = (got < bytes);
      tail = (tail + 1) % ring.size();
      if (at_eof) eof.store(true);
      cv_data.notify_one();
      if (at_eof) return;
    }
  }
};

}  // namespace

extern "C" {

void* iql_open(const char* path, int format, long block_samples,
               int n_buffers) {
  if (format < 0 || format > 2 || block_samples <= 0 || n_buffers < 2)
    return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* h = new Loader();
  h->f = f;
  h->format = format;
  h->block = block_samples;
  h->ring.resize(static_cast<size_t>(n_buffers));
  h->reader = std::thread([h] { h->run(); });
  return h;
}

long iql_next(void* vh, float* re, float* im) {
  auto* h = static_cast<Loader*>(vh);
  if (!h) return -1;
  std::unique_lock<std::mutex> lk(h->mu);
  h->cv_data.wait(lk, [&] {
    return h->ring[h->head].ready || h->eof.load();
  });
  Buffer& b = h->ring[h->head];
  if (!b.ready) return 0;  // EOF drained
  long n = b.n;
  lk.unlock();
  if (n > 0) {
    memcpy(re, b.re.data(), sizeof(float) * static_cast<size_t>(n));
    memcpy(im, b.im.data(), sizeof(float) * static_cast<size_t>(n));
  }
  lk.lock();
  b.ready = false;
  h->head = (h->head + 1) % h->ring.size();
  h->cv_space.notify_one();
  return n;
}

long iql_total_read(void* vh) {
  auto* h = static_cast<Loader*>(vh);
  return h ? h->total.load() : -1;
}

void iql_close(void* vh) {
  auto* h = static_cast<Loader*>(vh);
  if (!h) return;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->stop.store(true);
    h->cv_space.notify_all();
  }
  if (h->reader.joinable()) h->reader.join();
  fclose(h->f);
  delete h;
}

}  // extern "C"
