// Native data loader: mmap'd byte-level corpus + deterministic random
// window sampler with a double-buffered prefetch thread.
//
// A copy of the JAX package's loader (the same sampler, so one seed gives
// the same batches in both packages): byte-level corpora (char LM,
// BASELINE config 2) or uint16 BPE streams, an O(1) xorshift draw per row,
// and the next batch materialized on a worker thread while the trainer
// consumes the current one.  Exposed as a plain C API consumed via ctypes
// (fft_tpu_torch/train/native_loader.py).
//
// Built at first use by fft_tpu_torch/train/native_loader.py::build, with
// the host C++ compiler, into fft_tpu_torch/build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
};

struct Loader {
  const uint8_t* data = nullptr;
  size_t size = 0;  // bytes
  bool owns_mmap = false;
  std::vector<uint8_t> owned;  // for in-memory corpora

  int batch = 0;
  int seqlen = 0;  // rows are seqlen+1 (inputs+targets)
  int elem = 1;    // bytes per token: 1 = raw bytes, 2 = uint16 LE (BPE)
  uint64_t seed = 0;
  uint64_t step = 0;

  std::vector<int32_t> buf[2];
  int ready_slot = -1;
  uint64_t ready_step = 0;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  bool want_fill = false;

  void fill(int slot, uint64_t step_idx) {
    const int row = seqlen + 1;
    XorShift rng(seed * 0x2545F4914F6CDD1DULL + step_idx + 1);
    int32_t* out = buf[slot].data();
    const size_t n_tokens = size / static_cast<size_t>(elem);
    const size_t span = n_tokens - static_cast<size_t>(row);
    for (int b = 0; b < batch; ++b) {
      size_t start = static_cast<size_t>(rng.next() % span);
      int32_t* dst = out + static_cast<size_t>(b) * row;
      if (elem == 2) {
        // uint16 little-endian token stream (BPE corpora); memcpy per
        // element keeps it alignment-safe on any mmap offset.
        const uint8_t* src = data + start * 2;
        for (int i = 0; i < row; ++i) {
          uint16_t t;
          std::memcpy(&t, src + 2 * i, 2);
          dst[i] = static_cast<int32_t>(t);
        }
      } else {
        const uint8_t* src = data + start;
        for (int i = 0; i < row; ++i) dst[i] = static_cast<int32_t>(src[i]);
      }
    }
  }

  void loop() {
    int slot = 0;
    uint64_t next_step = step;
    while (true) {
      fill(slot, next_step);
      {
        std::unique_lock<std::mutex> lk(mu);
        ready_slot = slot;
        ready_step = next_step;
        want_fill = false;
        cv.notify_all();
        cv.wait(lk, [&] { return want_fill || stop.load(); });
        if (stop.load()) return;
      }
      slot ^= 1;
      ++next_step;
    }
  }
};

}  // namespace

extern "C" {

void* fft_loader_open2(const char* path, int batch, int seqlen,
                       uint64_t seed, int elem) {
  if (elem != 1 && elem != 2) return nullptr;
  auto* l = new Loader();
  l->elem = elem;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    delete l;
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      st.st_size / elem < seqlen + 2 || st.st_size % elem != 0) {
    ::close(fd);
    delete l;
    return nullptr;
  }
  l->size = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, l->size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) {
    delete l;
    return nullptr;
  }
  l->data = static_cast<const uint8_t*>(m);
  l->owns_mmap = true;
  l->batch = batch;
  l->seqlen = seqlen;
  l->seed = seed;
  size_t n = static_cast<size_t>(batch) * (seqlen + 1);
  l->buf[0].resize(n);
  l->buf[1].resize(n);
  l->worker = std::thread([l] { l->loop(); });
  return l;
}

void* fft_loader_open(const char* path, int batch, int seqlen,
                      uint64_t seed) {
  return fft_loader_open2(path, batch, seqlen, seed, 1);
}

// Blocks until the prefetched batch for the next step is ready, copies it
// into `out` (int32, batch x (seqlen+1)), and kicks off the following fill.
int fft_loader_next(void* handle, int32_t* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv.wait(lk, [&] { return l->ready_slot >= 0; });
  std::memcpy(out, l->buf[l->ready_slot].data(),
              l->buf[l->ready_slot].size() * sizeof(int32_t));
  l->ready_slot = -1;
  l->want_fill = true;
  l->cv.notify_all();
  return 0;
}

void fft_loader_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->stop.store(true);
    l->want_fill = true;
    l->cv.notify_all();
  }
  if (l->worker.joinable()) l->worker.join();
  if (l->owns_mmap && l->data) {
    munmap(const_cast<uint8_t*>(l->data), l->size);
  }
  delete l;
}

}  // extern "C"
