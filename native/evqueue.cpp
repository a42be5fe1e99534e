// evqueue: native event-stream queue + background file streamer.
//
// Runtime counterpart of the reference's event buffer machinery:
// EvTrackManager owns SharedQueue/EventQueue buffers with overlap-aware
// consumption and front re-injection (reference
// include/Event/EventData.h:130-139 EventQueue::consumeBegin;
// src/Event/EvTrackManager.cpp:227-241 fillBuffer, :258 injectEventsBegin),
// and a loader that feeds them from events.txt (src/Event/EventLoader.cpp).
//
// Here the queue is a contiguous float64 row buffer (ts,x,y,p) with an
// amortized-compacting head cursor, guarded by one mutex, plus an optional
// background std::thread that mmap-parses an events file into the queue in
// blocks — so host-side parsing overlaps device compute (the reference runs
// its loader in the caller thread and stalls; we double-buffer). The window
// builder (eorb_slam_tpu/event/builder.py) swaps its numpy buffer for this
// backend when the library is available.
//
// C ABI (all thread-safe on one handle):
//   evq_create() -> handle
//   evq_destroy(h)
//   evq_feed(h, rows, n)          append n rows of 4 doubles
//   evq_size(h) -> rows queued
//   evq_consume(h, n, out) -> m   pop min(n, size) rows into out
//   evq_inject_front(h, rows, n)  push rows back at the FRONT (overlap)
//   evq_pad_rebase(rows, n, cap, t0, out, valid) -> n_dropped
//       keep the most recent `cap` rows, subtract t0 from ts, cast to
//       float32 [t-t0, x, y, p] + validity mask (the precision-critical
//       host step before device upload: float64 ts must be rebased BEFORE
//       the float32 cast)
//   evq_stream_file(h, path, max_rows, block_rows) -> 0 ok (spawns thread;
//       nonzero when the file cannot be opened/stat'd/mmap'd — the caller
//       can distinguish a bad path from an empty stream)
//   evq_stream_active(h) -> 1 while the streamer is parsing
//   evq_stream_join(h)

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <mutex>
#include <thread>
#include <vector>

#include "parse_util.h"

namespace {

constexpr int kCols = 4;

struct EvQueue {
  std::mutex mu;
  std::vector<double> buf;  // rows of 4, valid range [head*4, buf.size())
  size_t head_rows = 0;
  std::thread streamer;
  std::atomic<int> streaming{0};

  size_t size_rows() const { return buf.size() / kCols - head_rows; }

  void compact_locked() {
    // drop the consumed prefix once it dominates the storage
    if (head_rows * 2 * kCols > buf.size() && head_rows > (1u << 16)) {
      buf.erase(buf.begin(), buf.begin() + head_rows * kCols);
      head_rows = 0;
    }
  }
};

void stream_worker(EvQueue* q, const char* base, size_t size, int fd,
                   int64_t max_rows, int64_t block_rows) {
  const char* p = base;
  const char* end = base + size;
  std::vector<double> block;
  block.reserve(block_rows * kCols);
  int64_t rows = 0;
  while (p < end && (max_rows < 0 || rows < max_rows)) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // parse strictly within the line: a short/truncated/malformed row must
    // not consume the next line's leading fields
    const char* c = p;
    while (c < line_end && (*c == ' ' || *c == '\t' || *c == '\r')) ++c;
    if (c < line_end && *c != '#') {
      double vals[kCols];
      int got = 0;
      while (got < kCols && c < line_end) {
        vals[got++] = fastio::parse_double(c, line_end);
        while (c < line_end && (*c == ' ' || *c == '\t' || *c == '\r')) ++c;
      }
      if (got == kCols) {  // short rows are skipped, not zero-filled
        block.insert(block.end(), vals, vals + kCols);
        ++rows;
      }
    }
    p = nl ? nl + 1 : end;
    if (static_cast<int64_t>(block.size()) >= block_rows * kCols) {
      std::lock_guard<std::mutex> lk(q->mu);
      q->buf.insert(q->buf.end(), block.begin(), block.end());
      block.clear();
    }
  }
  if (!block.empty()) {
    std::lock_guard<std::mutex> lk(q->mu);
    q->buf.insert(q->buf.end(), block.begin(), block.end());
  }
  munmap(const_cast<char*>(base), size);
  close(fd);
  q->streaming.store(0);
}

}  // namespace

extern "C" {

void* evq_create() { return new EvQueue(); }

void evq_destroy(void* h) {
  EvQueue* q = static_cast<EvQueue*>(h);
  if (q->streamer.joinable()) q->streamer.join();
  delete q;
}

void evq_feed(void* h, const double* rows, int64_t n) {
  EvQueue* q = static_cast<EvQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->buf.insert(q->buf.end(), rows, rows + n * kCols);
}

int64_t evq_size(void* h) {
  EvQueue* q = static_cast<EvQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int64_t>(q->size_rows());
}

int64_t evq_consume(void* h, int64_t n, double* out) {
  EvQueue* q = static_cast<EvQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  int64_t m = static_cast<int64_t>(q->size_rows());
  if (n < m) m = n;
  if (m > 0) {
    memcpy(out, q->buf.data() + q->head_rows * kCols,
           m * kCols * sizeof(double));
    q->head_rows += m;
    q->compact_locked();
  }
  return m;
}

void evq_inject_front(void* h, const double* rows, int64_t n) {
  EvQueue* q = static_cast<EvQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  size_t need = static_cast<size_t>(n) * kCols;
  if (q->head_rows * kCols >= need) {
    // fits in the consumed headroom — no reallocation, no shift
    q->head_rows -= n;
    memcpy(q->buf.data() + q->head_rows * kCols, rows, need * sizeof(double));
  } else {
    q->buf.insert(q->buf.begin() + q->head_rows * kCols, rows, rows + need);
  }
}

int64_t evq_pad_rebase(const double* rows, int64_t n, int64_t cap, double t0,
                       float* out, uint8_t* valid) {
  int64_t drop = n > cap ? n - cap : 0;
  rows += drop * kCols;
  n -= drop;
  for (int64_t i = 0; i < n; ++i) {
    const double* r = rows + i * kCols;
    float* o = out + i * kCols;
    o[0] = static_cast<float>(r[0] - t0);
    o[1] = static_cast<float>(r[1]);
    o[2] = static_cast<float>(r[2]);
    o[3] = static_cast<float>(r[3]);
    valid[i] = 1;
  }
  memset(out + n * kCols, 0, (cap - n) * kCols * sizeof(float));
  memset(valid + n, 0, cap - n);
  return drop;
}

int evq_stream_file(void* h, const char* path, int64_t max_rows,
                    int64_t block_rows) {
  EvQueue* q = static_cast<EvQueue*>(h);
  int expected = 0;
  if (!q->streaming.compare_exchange_strong(expected, 1)) return -1;
  if (q->streamer.joinable()) q->streamer.join();
  if (block_rows <= 0) block_rows = 1 << 16;
  // open/stat/map in the caller so a bad path is reported synchronously
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    q->streaming.store(0);
    return -2;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    q->streaming.store(0);
    return -3;
  }
  if (st.st_size == 0) {  // empty stream is a successful no-op
    close(fd);
    q->streaming.store(0);
    return 0;
  }
  const char* base = static_cast<const char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (base == MAP_FAILED) {
    close(fd);
    q->streaming.store(0);
    return -4;
  }
  q->streamer = std::thread(stream_worker, q, base,
                            static_cast<size_t>(st.st_size), fd, max_rows,
                            block_rows);
  return 0;
}

int evq_stream_active(void* h) {
  return static_cast<EvQueue*>(h)->streaming.load();
}

void evq_stream_join(void* h) {
  EvQueue* q = static_cast<EvQueue*>(h);
  if (q->streamer.joinable()) q->streamer.join();
}

}  // extern "C"
