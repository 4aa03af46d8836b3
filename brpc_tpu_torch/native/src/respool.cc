// Versioned resource pool: dense 64-bit ids ↔ slots, the native form of
// the reference's butil/resource_pool.h + the versioned-ref trick Socket
// uses against address/SetFailed races (brpc/socket.cpp:776-800) and
// bthread_id uses for correlation ids (bthread/id.h:46-120).
//
// Id layout: high 32 bits = version (odd = live), low 32 bits = slot.
// Acquire bumps the slot's version to odd and returns the id; release
// bumps it to even, instantly invalidating every outstanding copy of the
// id. A stale id can never address a recycled slot.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

struct Slot {
  std::atomic<uint32_t> version{0};  // even = free, odd = live
  std::atomic<uint64_t> value{0};    // user payload (pointer / handle)
};

struct bt_respool {
  std::vector<Slot> slots;
  std::mutex mu;
  std::vector<uint32_t> free_slots;
  std::atomic<uint64_t> live{0};
};

namespace {
inline uint32_t slot_of(uint64_t id) { return static_cast<uint32_t>(id); }
inline uint32_t version_of(uint64_t id) { return static_cast<uint32_t>(id >> 32); }
inline uint64_t make_id(uint32_t version, uint32_t slot) {
  return (static_cast<uint64_t>(version) << 32) | slot;
}
}  // namespace

extern "C" {

bt_respool* bt_respool_create(size_t max_items) {
  bt_respool* p = new bt_respool();
  p->slots = std::vector<Slot>(max_items);
  p->free_slots.reserve(max_items);
  for (size_t i = max_items; i > 0; --i)
    p->free_slots.push_back(static_cast<uint32_t>(i - 1));
  return p;
}

void bt_respool_destroy(bt_respool* p) { delete p; }

// Returns a live versioned id, or 0 when exhausted. (Slot 0 version 1 is
// valid and nonzero: id 0 can only mean "no slot" because version starts
// at 0 and acquire always produces odd ≥ 1.)
uint64_t bt_respool_acquire(bt_respool* p, uint64_t value) {
  uint32_t slot;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    if (p->free_slots.empty()) return 0;
    slot = p->free_slots.back();
    p->free_slots.pop_back();
  }
  Slot& s = p->slots[slot];
  uint32_t v = s.version.load(std::memory_order_relaxed) + 1;  // even→odd
  s.value.store(value, std::memory_order_relaxed);
  s.version.store(v, std::memory_order_release);
  p->live.fetch_add(1, std::memory_order_relaxed);
  return make_id(v, slot);
}

// Address: fills *value and returns true iff the id is still live.
bool bt_respool_get(bt_respool* p, uint64_t id, uint64_t* value) {
  uint32_t slot = slot_of(id);
  if (slot >= p->slots.size()) return false;
  Slot& s = p->slots[slot];
  uint32_t v = s.version.load(std::memory_order_acquire);
  if (v != version_of(id) || (v & 1) == 0) return false;
  *value = s.value.load(std::memory_order_relaxed);
  // confirm the slot didn't get released+reacquired mid-read
  return s.version.load(std::memory_order_acquire) == v;
}

// Release: invalidates the id (version odd→even). Returns false when the
// id was already stale (double-release is a no-op).
bool bt_respool_release(bt_respool* p, uint64_t id) {
  uint32_t slot = slot_of(id);
  if (slot >= p->slots.size()) return false;
  Slot& s = p->slots[slot];
  uint32_t expect = version_of(id);
  if ((expect & 1) == 0) return false;
  if (!s.version.compare_exchange_strong(expect, expect + 1,
                                         std::memory_order_acq_rel))
    return false;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->free_slots.push_back(slot);
  }
  p->live.fetch_sub(1, std::memory_order_relaxed);
  return true;
}

uint64_t bt_respool_live(bt_respool* p) {
  return p->live.load(std::memory_order_relaxed);
}

}  // extern "C"
