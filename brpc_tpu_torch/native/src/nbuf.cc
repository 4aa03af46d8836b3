// nbuf: the native chained zero-copy buffer under IOBuf's host path.
//
// Re-implements the reference's IOBuf core contract (butil/iobuf.h:64,
// BlockRef iobuf.h:77) natively: a buffer is a list of (block, offset,
// length) refs onto pooled refcounted blocks (block_pool.cc); append
// copies into the writable tail block, while cut / append_nbuf / slice
// move refs only — never payload bytes. Exposed to Python as
// butil.iobuf.NativeIOBuf via ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>

extern "C" {
void* bt_block_alloc(int cls);
void bt_block_ref(void* data);
void bt_block_unref(void* data);
size_t bt_block_size(int cls);
}

namespace {

struct Ref {
  char* block;  // block data pointer (refcounted)
  uint32_t offset;
  uint32_t length;
};

constexpr int kBlockClass = 0;  // 8KB payload blocks, reference default

}  // namespace

struct bt_nbuf {
  std::deque<Ref> refs;
  size_t size = 0;
  // tail write cursor: bytes used in the last block (only valid when the
  // last ref's block is exclusively writable by this nbuf)
  size_t tail_used = 0;
  bool tail_writable = false;
};

extern "C" {

bt_nbuf* bt_nbuf_create() { return new bt_nbuf(); }

void bt_nbuf_clear(bt_nbuf* b) {
  for (auto& r : b->refs) bt_block_unref(r.block);
  b->refs.clear();
  b->size = 0;
  b->tail_writable = false;
  b->tail_used = 0;
}

void bt_nbuf_destroy(bt_nbuf* b) {
  if (b == nullptr) return;
  bt_nbuf_clear(b);
  delete b;
}

size_t bt_nbuf_size(const bt_nbuf* b) { return b->size; }

size_t bt_nbuf_block_count(const bt_nbuf* b) { return b->refs.size(); }

// Copy `len` bytes in — fills the writable tail block, then chains fresh
// pooled blocks. Returns bytes appended (== len unless OOM).
size_t bt_nbuf_append(bt_nbuf* b, const uint8_t* data, size_t len) {
  size_t appended = 0;
  const size_t blk_cap = bt_block_size(kBlockClass);
  while (appended < len) {
    if (b->tail_writable && b->tail_used < blk_cap) {
      Ref& tail = b->refs.back();
      size_t room = blk_cap - b->tail_used;
      size_t n = len - appended < room ? len - appended : room;
      std::memcpy(tail.block + b->tail_used, data + appended, n);
      tail.length += n;
      b->tail_used += n;
      b->size += n;
      appended += n;
      continue;
    }
    void* blk = bt_block_alloc(kBlockClass);
    if (blk == nullptr) break;
    b->refs.push_back(Ref{static_cast<char*>(blk), 0, 0});
    b->tail_used = 0;
    b->tail_writable = true;
  }
  return appended;
}

// Steal all refs from src onto the tail of dst (zero-copy; src empties).
void bt_nbuf_append_nbuf(bt_nbuf* dst, bt_nbuf* src) {
  for (auto& r : src->refs) dst->refs.push_back(r);
  dst->size += src->size;
  dst->tail_writable = src->tail_writable;
  dst->tail_used = src->tail_used;
  src->refs.clear();
  src->size = 0;
  src->tail_writable = false;
  src->tail_used = 0;
}

// Front-cut `n` bytes into a fresh nbuf. Ref moves + at most one ref
// split; payload bytes never move (iobuf cutn semantics).
bt_nbuf* bt_nbuf_cut(bt_nbuf* b, size_t n) {
  bt_nbuf* out = new bt_nbuf();
  if (n > b->size) n = b->size;
  while (n > 0 && !b->refs.empty()) {
    Ref& front = b->refs.front();
    if (front.length <= n) {
      out->refs.push_back(front);
      out->size += front.length;
      n -= front.length;
      b->size -= front.length;
      b->refs.pop_front();
      if (b->refs.empty()) {
        b->tail_writable = false;
        b->tail_used = 0;
      }
    } else {
      // split: both sides hold a ref on the block
      bt_block_ref(front.block);
      out->refs.push_back(Ref{front.block, front.offset, static_cast<uint32_t>(n)});
      out->size += n;
      front.offset += n;
      front.length -= n;
      b->size -= n;
      n = 0;
    }
  }
  return out;
}

// Drop `n` bytes from the front without materializing them (pop_front).
size_t bt_nbuf_pop_front(bt_nbuf* b, size_t n) {
  bt_nbuf* cut = bt_nbuf_cut(b, n);
  size_t dropped = cut->size;
  bt_nbuf_destroy(cut);
  return dropped;
}

// Copy out up to `n` bytes starting at byte `offset` (peek; no mutation).
size_t bt_nbuf_copy_to(const bt_nbuf* b, uint8_t* out, size_t n, size_t offset) {
  size_t written = 0;
  for (const auto& r : b->refs) {
    if (written >= n) break;
    if (offset >= r.length) {
      offset -= r.length;
      continue;
    }
    size_t avail = r.length - offset;
    size_t take = n - written < avail ? n - written : avail;
    std::memcpy(out + written, r.block + r.offset + offset, take);
    written += take;
    offset = 0;
  }
  return written;
}

// Expose ref i for scatter-gather IO (writev / PjRt transfer descriptors).
int bt_nbuf_ref_at(const bt_nbuf* b, size_t i, const uint8_t** data,
                   size_t* len) {
  if (i >= b->refs.size()) return -1;
  const Ref& r = b->refs[i];
  *data = reinterpret_cast<const uint8_t*>(r.block + r.offset);
  *len = r.length;
  return 0;
}

}  // extern "C"
