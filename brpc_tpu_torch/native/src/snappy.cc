// Snappy block-format codec — the reference vendors google/snappy
// (butil/third_party/snappy) and registers it as a wire compressor
// (policy/snappy_compress.cpp). This is a fresh implementation from the
// public format description, the exact C++ twin of the pure-Python
// fallback in butil/snappy_codec.py: same greedy hash matcher, same
// emission rules, bit-identical compressed output (tests pin this).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kHashBits = 14;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr size_t kMinMatch = 4;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (matches the Python twin)
}

inline uint8_t* emit_varint(uint8_t* dst, uint64_t n) {
  while (n >= 0x80) {
    *dst++ = static_cast<uint8_t>(n & 0x7F) | 0x80;
    n >>= 7;
  }
  *dst++ = static_cast<uint8_t>(n);
  return dst;
}

inline uint8_t* emit_literal(uint8_t* dst, const uint8_t* src, size_t start,
                             size_t end) {
  if (end <= start) return dst;
  size_t n = end - start;
  size_t rem = n - 1;
  if (rem < 60) {
    *dst++ = static_cast<uint8_t>(rem << 2);
  } else if (rem < (1u << 8)) {
    *dst++ = 60 << 2;
    *dst++ = static_cast<uint8_t>(rem);
  } else if (rem < (1u << 16)) {
    *dst++ = 61 << 2;
    *dst++ = static_cast<uint8_t>(rem);
    *dst++ = static_cast<uint8_t>(rem >> 8);
  } else if (rem < (1u << 24)) {
    *dst++ = 62 << 2;
    *dst++ = static_cast<uint8_t>(rem);
    *dst++ = static_cast<uint8_t>(rem >> 8);
    *dst++ = static_cast<uint8_t>(rem >> 16);
  } else {
    *dst++ = 63 << 2;
    *dst++ = static_cast<uint8_t>(rem);
    *dst++ = static_cast<uint8_t>(rem >> 8);
    *dst++ = static_cast<uint8_t>(rem >> 16);
    *dst++ = static_cast<uint8_t>(rem >> 24);
  }
  std::memcpy(dst, src + start, n);
  return dst + n;
}

inline uint8_t* emit_copy_chunk(uint8_t* dst, size_t offset, size_t length) {
  if (length >= 4 && length <= 11 && offset < 2048) {
    *dst++ = static_cast<uint8_t>(0x01 | ((length - 4) << 2) |
                                  ((offset >> 8) << 5));
    *dst++ = static_cast<uint8_t>(offset & 0xFF);
  } else if (offset < (1u << 16)) {
    *dst++ = static_cast<uint8_t>(0x02 | ((length - 1) << 2));
    *dst++ = static_cast<uint8_t>(offset);
    *dst++ = static_cast<uint8_t>(offset >> 8);
  } else {
    *dst++ = static_cast<uint8_t>(0x03 | ((length - 1) << 2));
    *dst++ = static_cast<uint8_t>(offset);
    *dst++ = static_cast<uint8_t>(offset >> 8);
    *dst++ = static_cast<uint8_t>(offset >> 16);
    *dst++ = static_cast<uint8_t>(offset >> 24);
  }
  return dst;
}

inline uint8_t* emit_copy(uint8_t* dst, size_t offset, size_t length) {
  while (length >= 68) {
    dst = emit_copy_chunk(dst, offset, 64);
    length -= 64;
  }
  if (length > 64) {  // 65..67: leave a >=5 tail
    dst = emit_copy_chunk(dst, offset, 60);
    length -= 60;
  }
  return emit_copy_chunk(dst, offset, length);
}

}  // namespace

extern "C" {

// worst-case output bound, mirrors snappy_codec.max_compressed_length
size_t bt_snappy_max_compressed(size_t n) { return 32 + n + n / 6; }

// returns compressed size, or 0 if dst_cap is too small.
// Input is compressed in independent 64KB fragments (matches never
// cross a fragment), like real snappy: offsets stay < 65536, copy4 is
// never emitted, and that is what PROVES the max_compressed bound —
// long-range length-4 matches would otherwise emit 5-byte copy4
// elements and overflow a bound-sized destination.
size_t bt_snappy_compress(const uint8_t* src, size_t n, uint8_t* dst,
                            size_t dst_cap) {
  constexpr size_t kFragment = 1u << 16;
  if (dst_cap < bt_snappy_max_compressed(n)) return 0;
  uint8_t* d = emit_varint(dst, n);
  if (n == 0) return static_cast<size_t>(d - dst);
  if (n < kMinMatch + 1) {
    d = emit_literal(d, src, 0, n);
    return static_cast<size_t>(d - dst);
  }
  // position+1; 0 = empty. Static would break concurrent callers, so a
  // per-call table on the heap; 16K entries x4B = 64KB.
  uint32_t* table = new uint32_t[1u << kHashBits];
  const int shift = 32 - kHashBits;
  size_t base = 0;
  while (base < n) {
    const size_t frag_end = base + kFragment < n ? base + kFragment : n;
    std::memset(table, 0, sizeof(uint32_t) << kHashBits);
    size_t lit_start = base;
    size_t pos = base;
    if (frag_end >= base + kMinMatch) {
      const size_t limit = frag_end - kMinMatch;
      while (pos <= limit) {
        const uint32_t cur = load32(src + pos);
        const uint32_t h = (cur * kHashMul) >> shift;
        // FRAGMENT-RELATIVE position+1 in the table: always <= 65536,
        // so it can never truncate in uint32 — storing absolute
        // positions would wrap past 4GiB inputs and fabricate
        // out-of-fragment candidates, re-opening the copy4/bound hole
        // the fragmenting exists to close
        const uint32_t stored = table[h];
        table[h] = static_cast<uint32_t>(pos - base + 1);
        if (stored != 0) {
          const size_t cand = base + stored - 1;
          if (load32(src + cand) == cur) {
            size_t m = pos + 4;
            size_t c = cand + 4;
            while (m < frag_end && src[m] == src[c]) {
              ++m;
              ++c;
            }
            d = emit_literal(d, src, lit_start, pos);
            d = emit_copy(d, pos - cand, m - pos);
            pos = m;
            lit_start = m;
            continue;
          }
        }
        ++pos;
      }
    }
    d = emit_literal(d, src, lit_start, frag_end);
    base = frag_end;
  }
  delete[] table;
  return static_cast<size_t>(d - dst);
}

// returns decompressed size, or -1 on corrupt input / undersized dst.
// Call with dst == nullptr to query the preamble length only.
int64_t bt_snappy_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t dst_cap) {
  size_t i = 0;
  uint64_t out_len = 0;
  int shift = 0;
  while (true) {
    if (i >= n) return -1;
    const uint8_t b = src[i++];
    out_len |= static_cast<uint64_t>(b & 0x7F) << shift;
    shift += 7;
    if (!(b & 0x80)) break;
    if (shift > 32) return -1;
  }
  if (dst == nullptr) return static_cast<int64_t>(out_len);
  if (dst_cap < out_len) return -1;
  size_t w = 0;  // bytes written
  while (i < n) {
    const uint8_t tag = src[i++];
    const unsigned kind = tag & 3;
    size_t length, offset;
    if (kind == 0) {  // literal
      size_t rem = tag >> 2;
      if (rem >= 60) {
        const size_t extra = rem - 59;
        if (i + extra > n) return -1;
        rem = 0;
        for (size_t k = 0; k < extra; ++k)
          rem |= static_cast<size_t>(src[i + k]) << (8 * k);
        i += extra;
      }
      length = rem + 1;
      if (i + length > n || w + length > out_len) return -1;
      std::memcpy(dst + w, src + i, length);
      i += length;
      w += length;
      continue;
    }
    if (kind == 1) {
      length = 4 + ((tag >> 2) & 0x7);
      if (i >= n) return -1;
      offset = (static_cast<size_t>(tag >> 5) << 8) | src[i];
      i += 1;
    } else if (kind == 2) {
      length = static_cast<size_t>(tag >> 2) + 1;
      if (i + 2 > n) return -1;
      offset = static_cast<size_t>(src[i]) |
               (static_cast<size_t>(src[i + 1]) << 8);
      i += 2;
    } else {
      length = static_cast<size_t>(tag >> 2) + 1;
      if (i + 4 > n) return -1;
      offset = static_cast<size_t>(src[i]) |
               (static_cast<size_t>(src[i + 1]) << 8) |
               (static_cast<size_t>(src[i + 2]) << 16) |
               (static_cast<size_t>(src[i + 3]) << 24);
      i += 4;
    }
    if (offset == 0 || offset > w || w + length > out_len) return -1;
    if (offset >= length) {
      std::memcpy(dst + w, dst + (w - offset), length);
    } else {
      // overlapping: byte-at-a-time repeats the trailing pattern
      const size_t start = w - offset;
      for (size_t k = 0; k < length; ++k) dst[w + k] = dst[start + k];
    }
    w += length;
  }
  if (w != out_len) return -1;
  return static_cast<int64_t>(w);
}

}  // extern "C"
