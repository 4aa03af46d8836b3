// tpu_std frame scanner: the native hot path under InputMessenger's parse
// loop (brpc/input_messenger.cpp ProcessNewMessage:219 — where the
// reference cuts complete messages out of the socket byte stream).
//
// Wire layout (brpc_tpu_torch/protocol/tpu_std.py):
//   "TRPC" | body_size:u32be | meta_size:u32be | body(body_size bytes)
//
// bt_trpc_scan walks a contiguous window and emits (offset, frame_len)
// pairs for every complete frame, so a pipelined burst costs one native
// call instead of one Python parse iteration per message.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {
constexpr size_t kHeaderSize = 12;
constexpr uint32_t kMagic = 0x54525043;  // "TRPC" big-endian

inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
}  // namespace

extern "C" {

// Scans data[0..len). Writes up to max_frames (offset,total_len) pairs
// into out (2 u64s per frame). Returns the number of complete frames
// found, or -1 if the bytes at a frame boundary are not a TRPC header
// (caller should hand the stream to other protocols / fail the socket).
// *consumed = bytes covered by the returned complete frames;
// *need = total bytes required to finish the next partial frame (0 when
// the window ends exactly on a frame boundary).
long bt_trpc_scan(const uint8_t* data, size_t len, uint64_t* out,
                  size_t max_frames, size_t* consumed, size_t* need) {
  size_t off = 0;
  long nframes = 0;
  *consumed = 0;
  *need = 0;
  while (static_cast<size_t>(nframes) < max_frames) {
    if (len - off < kHeaderSize) {
      if (len - off > 0) *need = kHeaderSize;
      break;
    }
    if (load_be32(data + off) != kMagic) return -1;
    uint32_t body_size = load_be32(data + off + 4);
    uint32_t meta_size = load_be32(data + off + 8);
    if (meta_size > body_size) return -1;  // corrupt header
    size_t total = kHeaderSize + body_size;
    if (len - off < total) {
      *need = total;
      break;
    }
    out[2 * nframes] = off;
    out[2 * nframes + 1] = total;
    ++nframes;
    off += total;
    *consumed = off;
  }
  return nframes;
}

// Single-header probe: returns 0 and fills sizes when data holds a valid
// header, 1 when more bytes are needed, -1 when not a TRPC frame.
int bt_trpc_probe(const uint8_t* data, size_t len, uint32_t* body_size,
                  uint32_t* meta_size) {
  if (len < kHeaderSize) return 1;
  if (load_be32(data) != kMagic) return -1;
  *body_size = load_be32(data + 4);
  *meta_size = load_be32(data + 8);
  if (*meta_size > *body_size) return -1;
  return 0;
}

}  // extern "C"
