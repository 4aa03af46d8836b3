// Native scheduler/transport queues:
//
// bt_wsq  — Chase-Lev work-stealing deque, the native form of the
//           reference's bthread/work_stealing_queue.h:30 (owner pushes/
//           pops the bottom, thieves steal the top). Items are opaque
//           u64s (fiber ids / task handles).
// bt_mpsc — wait-free multi-producer single-consumer queue with the
//           Socket write-path contract (socket.cpp StartWrite:1924):
//           producers exchange the head; the producer that finds the
//           queue empty becomes the writer; the single consumer drains
//           in FIFO order.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdlib>

// ---------------------------------------------------------------- wsq --

struct bt_wsq {
  std::atomic<int64_t> top{0};
  std::atomic<int64_t> bottom{0};
  uint64_t* buf;
  int64_t mask;
};

extern "C" {

bt_wsq* bt_wsq_create(size_t capacity) {
  // round up to power of two
  size_t cap = 1;
  while (cap < capacity) cap <<= 1;
  bt_wsq* q = new bt_wsq();
  q->buf = static_cast<uint64_t*>(malloc(cap * sizeof(uint64_t)));
  q->mask = static_cast<int64_t>(cap) - 1;
  return q;
}

void bt_wsq_destroy(bt_wsq* q) {
  if (q == nullptr) return;
  free(q->buf);
  delete q;
}

size_t bt_wsq_size(bt_wsq* q) {
  int64_t b = q->bottom.load(std::memory_order_relaxed);
  int64_t t = q->top.load(std::memory_order_relaxed);
  return b > t ? static_cast<size_t>(b - t) : 0;
}

// Owner-only push at the bottom. Returns false when full.
bool bt_wsq_push(bt_wsq* q, uint64_t v) {
  int64_t b = q->bottom.load(std::memory_order_relaxed);
  int64_t t = q->top.load(std::memory_order_acquire);
  if (b - t > q->mask) return false;  // full
  q->buf[b & q->mask] = v;
  q->bottom.store(b + 1, std::memory_order_release);
  return true;
}

// Owner-only pop from the bottom (LIFO for locality).
bool bt_wsq_pop(bt_wsq* q, uint64_t* out) {
  int64_t b = q->bottom.load(std::memory_order_relaxed) - 1;
  q->bottom.store(b, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  int64_t t = q->top.load(std::memory_order_relaxed);
  if (t > b) {  // empty
    q->bottom.store(b + 1, std::memory_order_relaxed);
    return false;
  }
  uint64_t v = q->buf[b & q->mask];
  if (t == b) {
    // last element: race against thieves for it
    if (!q->top.compare_exchange_strong(t, t + 1, std::memory_order_seq_cst,
                                        std::memory_order_relaxed)) {
      q->bottom.store(b + 1, std::memory_order_relaxed);
      return false;
    }
    q->bottom.store(b + 1, std::memory_order_relaxed);
  }
  *out = v;
  return true;
}

// Thief steal from the top (FIFO side).
bool bt_wsq_steal(bt_wsq* q, uint64_t* out) {
  int64_t t = q->top.load(std::memory_order_acquire);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  int64_t b = q->bottom.load(std::memory_order_acquire);
  if (t >= b) return false;
  uint64_t v = q->buf[t & q->mask];
  if (!q->top.compare_exchange_strong(t, t + 1, std::memory_order_seq_cst,
                                      std::memory_order_relaxed))
    return false;  // lost the race
  *out = v;
  return true;
}

}  // extern "C"

// --------------------------------------------------------------- mpsc --

namespace {

struct MpscNode {
  uint64_t value;
  std::atomic<MpscNode*> next;
};

// Sentinel marking "producer exchanged the head but hasn't linked next
// yet" — the reference's WriteRequest::UNCONNECTED trick
// (socket.cpp IsWriteComplete): the consumer spins the handful of cycles
// until the producer stores the real link, instead of the producer
// publishing an unlinked node (which would let a concurrent drain orphan
// the rest of the queue and free the node under the producer).
MpscNode* const kUnlinked = reinterpret_cast<MpscNode*>(1);

// "A writer is active" head sentinel for the _w retire protocol below —
// declared here so destroy/drain treat it as an end-of-chain marker.
MpscNode* const kWriting = reinterpret_cast<MpscNode*>(2);

MpscNode* resolve_next(MpscNode* n) {
  MpscNode* nx = n->next.load(std::memory_order_acquire);
  while (nx == kUnlinked) {
    // producer is between exchange and link: momentary by construction
    nx = n->next.load(std::memory_order_acquire);
  }
  return nx;
}

}  // namespace

struct bt_mpsc {
  std::atomic<MpscNode*> head{nullptr};  // producers exchange here
  MpscNode* pending = nullptr;           // consumer-side FIFO leftovers
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> drained{0};
};

extern "C" {

bt_mpsc* bt_mpsc_create() { return new bt_mpsc(); }

void bt_mpsc_destroy(bt_mpsc* q) {
  if (q == nullptr) return;
  MpscNode* n = q->head.exchange(nullptr, std::memory_order_acquire);
  while (n != nullptr && n != kWriting) {
    MpscNode* nx = resolve_next(n);
    delete n;
    n = nx;
  }
  n = q->pending;
  while (n) {
    MpscNode* nx = n->next.load(std::memory_order_relaxed);
    delete n;
    n = nx;
  }
  delete q;
}

// Wait-free enqueue. Returns true when the queue was empty — the calling
// producer becomes the writer (starts the KeepWrite fiber), everyone else
// just leaves their node and returns (socket.cpp:1924-2005 contract).
bool bt_mpsc_push(bt_mpsc* q, uint64_t v) {
  MpscNode* n = new MpscNode{v, {kUnlinked}};
  MpscNode* prev = q->head.exchange(n, std::memory_order_acq_rel);
  n->next.store(prev, std::memory_order_release);
  q->pushed.fetch_add(1, std::memory_order_relaxed);
  return prev == nullptr;
}

// Single-consumer drain in FIFO order. Returns items written to out.
size_t bt_mpsc_drain(bt_mpsc* q, uint64_t* out, size_t max) {
  size_t n = 0;
  while (n < max) {
    if (q->pending == nullptr) {
      MpscNode* grabbed = q->head.exchange(nullptr, std::memory_order_acq_rel);
      if (grabbed == nullptr) break;
      // reverse newest→oldest into FIFO, resolving in-flight links
      MpscNode* rev = nullptr;
      while (grabbed) {
        MpscNode* nx = resolve_next(grabbed);
        grabbed->next.store(rev, std::memory_order_relaxed);
        rev = grabbed;
        grabbed = nx;
      }
      q->pending = rev;
    }
    MpscNode* node = q->pending;
    q->pending = node->next.load(std::memory_order_relaxed);
    out[n++] = node->value;
    delete node;
  }
  q->drained.fetch_add(n, std::memory_order_relaxed);
  return n;
}

uint64_t bt_mpsc_pushed(bt_mpsc* q) {
  return q->pushed.load(std::memory_order_relaxed);
}

uint64_t bt_mpsc_drained(bt_mpsc* q) {
  return q->drained.load(std::memory_order_relaxed);
}

}  // extern "C"

// ---- writer-retire protocol (socket.cpp IsWriteComplete) -------------
//
// The plain drain above retires implicitly by exchanging the head to
// nullptr, which lets a producer claim writership while the old writer
// still holds FIFO leftovers in `pending` — fine for queues with an
// external writer lock, wrong as THE arbitration. The _w family keeps a
// kWriting sentinel in the head while a writer is active: producers who
// exchange against it do NOT claim; the writer retires only by CASing
// kWriting back to nullptr once both its FIFO and the head are empty —
// exactly the reference's CAS-on-_write_head retire.

extern "C" {

// Drain up to max items while KEEPING writership (head left at kWriting
// when emptied). Single consumer (the current writer) only.
size_t bt_mpsc_drain_w(bt_mpsc* q, uint64_t* out, size_t max) {
  size_t n = 0;
  while (n < max) {
    if (q->pending == nullptr) {
      MpscNode* grabbed = q->head.exchange(kWriting, std::memory_order_acq_rel);
      if (grabbed == nullptr || grabbed == kWriting) break;
      MpscNode* rev = nullptr;
      while (grabbed != nullptr && grabbed != kWriting) {
        MpscNode* nx = resolve_next(grabbed);
        grabbed->next.store(rev, std::memory_order_relaxed);
        rev = grabbed;
        grabbed = nx;
      }
      q->pending = rev;
      if (q->pending == nullptr) break;
    }
    MpscNode* node = q->pending;
    q->pending = node->next.load(std::memory_order_relaxed);
    out[n++] = node->value;
    delete node;
  }
  q->drained.fetch_add(n, std::memory_order_relaxed);
  return n;
}

// Attempt to release writership. True = retired (queue confirmed empty);
// false = new items arrived, caller must keep draining.
bool bt_mpsc_try_retire(bt_mpsc* q) {
  if (q->pending != nullptr) return false;
  MpscNode* expect = kWriting;
  if (q->head.compare_exchange_strong(expect, nullptr,
                                      std::memory_order_acq_rel))
    return true;
  // expect now holds the observed head: real nodes mean new work; a
  // nullptr means we were never the writer (idempotent retire)
  return expect == nullptr;
}

}  // extern "C"
