// Native (C++) kjj0 token-shard loader with background prefetch: the
// port's own copy of the JAX package's native loader, built with g++ at
// first use by ops/_build.py and bound with ctypes by
// data/native_loader.py.
//
// A small host component that owns file IO and batch assembly, so the
// Python loop spends its time enqueueing work on the card, not gathering
// tokens.
//
// Format (data/bin_format.py):
//   header: 256 little-endian int32 (magic 20240520, version 1, token_count)
//   payload: token_count uint16 tokens
//
// Semantics: the DISTRIBUTED lockstep stream (data/distributed_loader.py):
//   - all ranks walk the same shard list in order;
//   - per batch, rank r takes tokens [pos + r*B*T, pos + (r+1)*B*T + 1)
//     (the +1 is the target shift) and reshapes to [B, T];
//   - every rank advances pos += world*B*T;
//   - shard switch when fewer than world*B*T + 1 tokens remain, so all
//     ranks switch in lockstep. world=1 gives the single-process stream.
//
// Concurrency: one producer thread assembles batches into a bounded ring
// (prefetch_depth deep); the consumer (Python via ctypes) pops fully-built
// int32 inputs/targets buffers. Assembly and page-cache faults overlap with
// the card's work.
//
// C ABI only, consumed through ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int32_t kMagic = 20240520;
constexpr int32_t kVersion = 1;
constexpr int64_t kHeaderBytes = 256 * 4;

struct Shard {
  void* map = nullptr;
  size_t bytes = 0;
  const uint16_t* tokens = nullptr;
  int64_t count = 0;

  void close() {
    if (map != nullptr) {
      munmap(map, bytes);
      map = nullptr;
    }
    tokens = nullptr;
    count = 0;
  }
};

struct Loader {
  std::vector<std::string> paths;
  int64_t batch = 0, seq = 0;
  int rank = 0, world = 1;
  int depth = 2;

  // Sequential state (owned by the producer thread while it runs).
  size_t shard_idx = 0;
  Shard cur;
  int64_t pos = 0;

  // Prefetch ring.
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_can_push, cv_can_pop;
  std::deque<std::vector<int32_t>> ready;  // each: inputs||targets, 2*B*T
  bool exhausted = false;   // producer hit end of data
  bool stopping = false;    // consumer asked the producer to quit
  std::string error;        // sticky; set under mu by the producer

  ~Loader() { stop_worker(); cur.close(); }

  void stop_worker() {
    {
      std::lock_guard<std::mutex> g(mu);
      stopping = true;
    }
    cv_can_push.notify_all();
    cv_can_pop.notify_all();
    if (worker.joinable()) worker.join();
  }
};

bool open_shard(Loader* L, const std::string& path, std::string* err) {
  L->cur.close();
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) {
    *err = path + ": cannot open";
    return false;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < kHeaderBytes) {
    close(fd);
    *err = path + ": truncated header";
    return false;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) {
    *err = path + ": mmap failed";
    return false;
  }
  const int32_t* header = static_cast<const int32_t*>(map);
  int64_t count = header[2];
  if (header[0] != kMagic) {
    *err = path + ": bad magic " + std::to_string(header[0]) +
           ", expected " + std::to_string(kMagic);
    munmap(map, st.st_size);
    return false;
  }
  if (header[1] != kVersion) {
    *err = path + ": unsupported version " + std::to_string(header[1]);
    munmap(map, st.st_size);
    return false;
  }
  if (st.st_size < kHeaderBytes + count * 2) {
    *err = path + ": payload shorter than header token_count";
    munmap(map, st.st_size);
    return false;
  }
  L->cur.map = map;
  L->cur.bytes = st.st_size;
  L->cur.tokens = reinterpret_cast<const uint16_t*>(
      static_cast<const char*>(map) + kHeaderBytes);
  L->cur.count = count;
  return true;
}

// Assemble one batch into out (2*B*T int32: inputs then targets).
// Returns 1 on success, 0 on end-of-data, -1 on error (err set).
int produce(Loader* L, int32_t* out, std::string* err) {
  const int64_t local = L->batch * L->seq;
  const int64_t global = local * L->world;
  while (L->cur.tokens == nullptr || L->pos + global >= L->cur.count) {
    if (L->shard_idx >= L->paths.size()) return 0;
    if (!open_shard(L, L->paths[L->shard_idx++], err)) return -1;
    L->pos = 0;
  }
  const uint16_t* base = L->cur.tokens + L->pos + int64_t(L->rank) * local;
  int32_t* inp = out;
  int32_t* tgt = out + local;
  for (int64_t i = 0; i < local; ++i) {
    inp[i] = base[i];
    tgt[i] = base[i + 1];
  }
  L->pos += global;
  return 1;
}

void producer_main(Loader* L) {
  const int64_t local = L->batch * L->seq;
  for (;;) {
    std::vector<int32_t> buf(2 * local);
    std::string err;
    int rc = produce(L, buf.data(), &err);
    std::unique_lock<std::mutex> lk(L->mu);
    if (rc <= 0) {
      if (rc < 0) L->error = err;
      L->exhausted = true;
      L->cv_can_pop.notify_all();
      return;
    }
    L->cv_can_push.wait(lk, [L] {
      return L->stopping || int(L->ready.size()) < L->depth;
    });
    if (L->stopping) return;
    L->ready.push_back(std::move(buf));
    L->cv_can_pop.notify_one();
  }
}

}  // namespace

extern "C" {

Loader* pdt_loader_create(const char** paths, int n_paths, int64_t batch,
                          int64_t seq, int rank, int world,
                          int prefetch_depth) {
  if (n_paths <= 0 || batch <= 0 || seq <= 0 || world <= 0 || rank < 0 ||
      rank >= world || prefetch_depth <= 0) {
    return nullptr;
  }
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->batch = batch;
  L->seq = seq;
  L->rank = rank;
  L->world = world;
  L->depth = prefetch_depth;
  L->worker = std::thread(producer_main, L);
  return L;
}

// 1 = batch written, 0 = end of data, -1 = error (see pdt_loader_error).
int pdt_loader_next(Loader* L, int32_t* inputs, int32_t* targets) {
  const int64_t local = L->batch * L->seq;
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_can_pop.wait(lk, [L] { return !L->ready.empty() || L->exhausted; });
    if (L->ready.empty()) {
      return L->error.empty() ? 0 : -1;
    }
    buf = std::move(L->ready.front());
    L->ready.pop_front();
  }
  L->cv_can_push.notify_one();
  std::memcpy(inputs, buf.data(), local * sizeof(int32_t));
  std::memcpy(targets, buf.data() + local, local * sizeof(int32_t));
  return 1;
}

// Restart the stream from the first shard (fresh __iter__ semantics).
void pdt_loader_reset(Loader* L) {
  L->stop_worker();
  L->cur.close();
  L->shard_idx = 0;
  L->pos = 0;
  L->ready.clear();
  L->exhausted = false;
  L->stopping = false;
  L->error.clear();
  L->worker = std::thread(producer_main, L);
}

const char* pdt_loader_error(Loader* L) {
  std::lock_guard<std::mutex> g(L->mu);
  return L->error.c_str();
}

void pdt_loader_destroy(Loader* L) { delete L; }

}  // extern "C"
