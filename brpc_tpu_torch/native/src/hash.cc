// Native hash routines for the hot paths: crc32c (payload checksums, the
// reference's butil/crc32c.cc) and MurmurHash3 x64_128 (consistent-hash
// load balancing, the reference's butil/third_party/murmurhash3).
// Fresh implementations from the public algorithm specs — not copies.
//
// crc32c: Castagnoli polynomial 0x1EDC6F41 (reflected 0x82F63B78),
// slice-by-8 table driver with an SSE4.2 hardware fast path when the CPU
// has it.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPolyReflected = 0x82F63B78u;

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (c >> 1) ^ kPolyReflected : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kTables;

uint32_t crc32c_sw(const uint8_t* p, size_t len, uint32_t crc) {
  // slice-by-8: consume 8 bytes per iteration through 8 parallel tables
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    word ^= crc;
    crc = kTables.t[7][word & 0xFF] ^ kTables.t[6][(word >> 8) & 0xFF] ^
          kTables.t[5][(word >> 16) & 0xFF] ^ kTables.t[4][(word >> 24) & 0xFF] ^
          kTables.t[3][(word >> 32) & 0xFF] ^ kTables.t[2][(word >> 40) & 0xFF] ^
          kTables.t[1][(word >> 48) & 0xFF] ^ kTables.t[0][(word >> 56) & 0xFF];
    p += 8;
    len -= 8;
  }
  while (len--) crc = kTables.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* p, size_t len, uint32_t crc) {
  uint64_t c = crc;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    c = __builtin_ia32_crc32di(c, word);
    p += 8;
    len -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (len--) c32 = __builtin_ia32_crc32qi(c32, *p++);
  return c32;
}

bool have_sse42() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#endif

inline uint64_t rotl64(uint64_t x, int8_t r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDULL;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ULL;
  k ^= k >> 33;
  return k;
}

}  // namespace

extern "C" {

uint32_t bt_crc32c(const uint8_t* data, size_t len, uint32_t init) {
  uint32_t crc = init ^ 0xFFFFFFFFu;
#if defined(__x86_64__)
  if (have_sse42())
    crc = crc32c_hw(data, len, crc);
  else
#endif
    crc = crc32c_sw(data, len, crc);
  return crc ^ 0xFFFFFFFFu;
}

// Raw (un-finalized xor) variant for incremental use: feed the previous
// return value back in as `state`; start with state=0xFFFFFFFF and xor
// the final result with 0xFFFFFFFF yourself.
uint32_t bt_crc32c_raw(const uint8_t* data, size_t len, uint32_t state) {
#if defined(__x86_64__)
  if (have_sse42()) return crc32c_hw(data, len, state);
#endif
  return crc32c_sw(data, len, state);
}

void bt_murmur3_x64_128(const void* key, size_t len, uint32_t seed,
                        uint64_t out[2]) {
  const uint8_t* data = static_cast<const uint8_t*>(key);
  const size_t nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87C37B91114253D5ULL;
  const uint64_t c2 = 0x4CF5AD432745937FULL;

  for (size_t i = 0; i < nblocks; ++i) {
    uint64_t k1, k2;
    std::memcpy(&k1, data + i * 16, 8);
    std::memcpy(&k2, data + i * 16 + 8, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52DCE729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495AB5;
  }

  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= uint64_t(tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= uint64_t(tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= uint64_t(tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= uint64_t(tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= uint64_t(tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= uint64_t(tail[9]) << 8; [[fallthrough]];
    case 9:  k2 ^= uint64_t(tail[8]);
             k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2; [[fallthrough]];
    case 8:  k1 ^= uint64_t(tail[7]) << 56; [[fallthrough]];
    case 7:  k1 ^= uint64_t(tail[6]) << 48; [[fallthrough]];
    case 6:  k1 ^= uint64_t(tail[5]) << 40; [[fallthrough]];
    case 5:  k1 ^= uint64_t(tail[4]) << 32; [[fallthrough]];
    case 4:  k1 ^= uint64_t(tail[3]) << 24; [[fallthrough]];
    case 3:  k1 ^= uint64_t(tail[2]) << 16; [[fallthrough]];
    case 2:  k1 ^= uint64_t(tail[1]) << 8; [[fallthrough]];
    case 1:  k1 ^= uint64_t(tail[0]);
             k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= len; h2 ^= len;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2; h2 += h1;
  out[0] = h1;
  out[1] = h2;
}

}  // extern "C"
