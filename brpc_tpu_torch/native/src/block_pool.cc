// Size-classed refcounted block pool — the native allocator under TpuBuf
// host blocks and pre-posted transport receive buffers.
//
// Design follows the reference's RDMA registered-memory pool
// (rdma/block_pool.cpp:52,271-340): three size classes (8KB / 64KB / 2MB),
// blocks carved out of large regions, per-class global freelists, and a
// per-thread cache in front so the hot path takes no lock. Regions are
// kept for the process lifetime (in the TPU build a region maps 1:1 onto a
// host-pinned DMA arena that PjRt can transfer from without staging).
//
// Each block has a 64-byte header (class id + atomic refcount) directly
// before the data pointer handed to callers, so unref needs no lookup.

#include <sys/mman.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr int kNumClasses = 3;
constexpr size_t kClassSizes[kNumClasses] = {8 * 1024, 64 * 1024, 2 * 1024 * 1024};
constexpr size_t kHeaderSize = 64;  // keeps data 64B-aligned (cacheline / DMA)
constexpr size_t kRegionBytes = 16 * 1024 * 1024;
constexpr int kTlsCacheCap[kNumClasses] = {64, 16, 2};

// Pinned (mlock'd) arena: the device-backed size class. Regions here are
// locked into physical memory so the device runtime's H2D engine can DMA
// straight out of them — the TPU-build analog of the reference
// registering RDMA memory per region. Pinned memory is precious: small
// regions, a hard cap, and NULL past it (callers fall back to pageable).
constexpr size_t kPinnedRegionBytes = 4 * 1024 * 1024;
constexpr size_t kPinnedCapBytes = 64 * 1024 * 1024;
constexpr uint32_t kPinnedFlag = 0x100;
constexpr uint32_t kClassMask = 0xFF;

struct BlockHeader {
  std::atomic<uint32_t> refcount;
  uint32_t size_class;  // class index, | kPinnedFlag for pinned blocks
  BlockHeader* next_free;  // freelist link (only while free)
  char pad[kHeaderSize - sizeof(std::atomic<uint32_t>) - sizeof(uint32_t) -
           sizeof(BlockHeader*)];
};
static_assert(sizeof(BlockHeader) == kHeaderSize, "header must stay 64B");

struct ClassPool {
  std::mutex mu;
  BlockHeader* free_head = nullptr;
  size_t free_count = 0;
  std::vector<void*> regions;
  std::atomic<uint64_t> total_blocks{0};
  std::atomic<uint64_t> live_blocks{0};
};

ClassPool g_pools[kNumClasses];
ClassPool g_pinned_pools[kNumClasses];
std::atomic<size_t> g_pinned_bytes{0};

struct TlsCache {
  BlockHeader* head[kNumClasses] = {nullptr, nullptr, nullptr};
  int count[kNumClasses] = {0, 0, 0};
  ~TlsCache() {
    // thread exit: hand cached blocks back to the global freelist
    for (int c = 0; c < kNumClasses; ++c) {
      while (head[c]) {
        BlockHeader* h = head[c];
        head[c] = h->next_free;
        std::lock_guard<std::mutex> lk(g_pools[c].mu);
        h->next_free = g_pools[c].free_head;
        g_pools[c].free_head = h;
        ++g_pools[c].free_count;
      }
    }
  }
};

thread_local TlsCache tls_cache;

BlockHeader* header_of(void* data) {
  return reinterpret_cast<BlockHeader*>(static_cast<char*>(data) - kHeaderSize);
}

void* data_of(BlockHeader* h) {
  return reinterpret_cast<char*>(h) + kHeaderSize;
}

// Carve a fresh region into blocks and push them on the class freelist.
// Called with the class mutex held.
bool extend_locked(int cls) {
  ClassPool& pool = g_pools[cls];
  const size_t stride = kHeaderSize + kClassSizes[cls];
  const size_t nblocks = kRegionBytes >= stride ? kRegionBytes / stride : 1;
  void* region = nullptr;
  if (posix_memalign(&region, 64, nblocks * stride) != 0) return false;
  pool.regions.push_back(region);
  for (size_t i = 0; i < nblocks; ++i) {
    BlockHeader* h =
        reinterpret_cast<BlockHeader*>(static_cast<char*>(region) + i * stride);
    new (&h->refcount) std::atomic<uint32_t>(0);
    h->size_class = static_cast<uint32_t>(cls);
    h->next_free = pool.free_head;
    pool.free_head = h;
  }
  pool.free_count += nblocks;
  pool.total_blocks.fetch_add(nblocks, std::memory_order_relaxed);
  return true;
}

// Pinned-region extend: mlock the fresh region before carving it; an
// mlock failure (RLIMIT_MEMLOCK) frees the region and reports OOM so
// callers fall back to pageable blocks instead of pretending. Called
// with the pinned class mutex held.
bool extend_pinned_locked(int cls) {
  ClassPool& pool = g_pinned_pools[cls];
  const size_t stride = kHeaderSize + kClassSizes[cls];
  const size_t nblocks =
      kPinnedRegionBytes >= stride ? kPinnedRegionBytes / stride : 1;
  const size_t bytes = nblocks * stride;
  if (g_pinned_bytes.load(std::memory_order_relaxed) + bytes > kPinnedCapBytes)
    return false;
  void* region = nullptr;
  if (posix_memalign(&region, 64, bytes) != 0) return false;
  if (mlock(region, bytes) != 0) {
    free(region);
    return false;
  }
  g_pinned_bytes.fetch_add(bytes, std::memory_order_relaxed);
  pool.regions.push_back(region);
  for (size_t i = 0; i < nblocks; ++i) {
    BlockHeader* h =
        reinterpret_cast<BlockHeader*>(static_cast<char*>(region) + i * stride);
    new (&h->refcount) std::atomic<uint32_t>(0);
    h->size_class = static_cast<uint32_t>(cls) | kPinnedFlag;
    h->next_free = pool.free_head;
    pool.free_head = h;
  }
  pool.free_count += nblocks;
  pool.total_blocks.fetch_add(nblocks, std::memory_order_relaxed);
  return true;
}

}  // namespace

extern "C" {

int bt_block_class_for(size_t nbytes) {
  for (int c = 0; c < kNumClasses; ++c)
    if (nbytes <= kClassSizes[c]) return c;
  return -1;
}

size_t bt_block_size(int size_class) {
  if (size_class < 0 || size_class >= kNumClasses) return 0;
  return kClassSizes[size_class];
}

// Returns the data pointer (refcount == 1), or NULL on OOM/bad class.
void* bt_block_alloc(int cls) {
  if (cls < 0 || cls >= kNumClasses) return nullptr;
  TlsCache& tc = tls_cache;
  BlockHeader* h = tc.head[cls];
  if (h != nullptr) {
    tc.head[cls] = h->next_free;
    --tc.count[cls];
  } else {
    ClassPool& pool = g_pools[cls];
    std::lock_guard<std::mutex> lk(pool.mu);
    if (pool.free_head == nullptr && !extend_locked(cls)) return nullptr;
    h = pool.free_head;
    pool.free_head = h->next_free;
    --pool.free_count;
  }
  h->refcount.store(1, std::memory_order_relaxed);
  g_pools[cls].live_blocks.fetch_add(1, std::memory_order_relaxed);
  return data_of(h);
}

// Pinned (mlock'd, DMA-capable) variant: NULL on bad class, past the
// pinned cap, or when mlock is refused — callers MUST fall back to the
// pageable pool / plain allocation.
void* bt_block_alloc_pinned(int cls) {
  if (cls < 0 || cls >= kNumClasses) return nullptr;
  ClassPool& pool = g_pinned_pools[cls];
  BlockHeader* h = nullptr;
  {
    std::lock_guard<std::mutex> lk(pool.mu);
    if (pool.free_head == nullptr && !extend_pinned_locked(cls)) return nullptr;
    h = pool.free_head;
    pool.free_head = h->next_free;
    --pool.free_count;
  }
  h->refcount.store(1, std::memory_order_relaxed);
  pool.live_blocks.fetch_add(1, std::memory_order_relaxed);
  return data_of(h);
}

int bt_block_is_pinned(void* data) {
  return (header_of(data)->size_class & kPinnedFlag) ? 1 : 0;
}

void bt_block_ref(void* data) {
  header_of(data)->refcount.fetch_add(1, std::memory_order_relaxed);
}

uint32_t bt_block_refcount(void* data) {
  return header_of(data)->refcount.load(std::memory_order_relaxed);
}

void bt_block_unref(void* data) {
  BlockHeader* h = header_of(data);
  if (h->refcount.fetch_sub(1, std::memory_order_acq_rel) != 1) return;
  const int cls = h->size_class & kClassMask;
  if (h->size_class & kPinnedFlag) {
    // pinned blocks bypass the TLS cache: they return to their own
    // global freelist so the pageable cache never hands one out
    ClassPool& pool = g_pinned_pools[cls];
    pool.live_blocks.fetch_sub(1, std::memory_order_relaxed);
    std::lock_guard<std::mutex> lk(pool.mu);
    h->next_free = pool.free_head;
    pool.free_head = h;
    ++pool.free_count;
    return;
  }
  g_pools[cls].live_blocks.fetch_sub(1, std::memory_order_relaxed);
  TlsCache& tc = tls_cache;
  if (tc.count[cls] < kTlsCacheCap[cls]) {
    h->next_free = tc.head[cls];
    tc.head[cls] = h;
    ++tc.count[cls];
    return;
  }
  ClassPool& pool = g_pools[cls];
  std::lock_guard<std::mutex> lk(pool.mu);
  h->next_free = pool.free_head;
  pool.free_head = h;
  ++pool.free_count;
}

// what: 0 = total blocks ever carved, 1 = live (ref'd) blocks,
//       2 = global freelist length (excludes TLS caches);
//       3/4/5 = the same trio for the PINNED arena,
//       6 = pinned bytes currently mlock'd (cls ignored)
uint64_t bt_block_pool_stats(int cls, int what) {
  if (what == 6) return g_pinned_bytes.load(std::memory_order_relaxed);
  if (cls < 0 || cls >= kNumClasses) return 0;
  ClassPool& pool = (what >= 3) ? g_pinned_pools[cls] : g_pools[cls];
  switch (what) {
    case 0:
    case 3: return pool.total_blocks.load(std::memory_order_relaxed);
    case 1:
    case 4: return pool.live_blocks.load(std::memory_order_relaxed);
    case 2:
    case 5: {
      std::lock_guard<std::mutex> lk(pool.mu);
      return pool.free_count;
    }
    default: return 0;
  }
}

}  // extern "C"
