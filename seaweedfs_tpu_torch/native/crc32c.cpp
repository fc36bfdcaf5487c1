// CRC32-Castagnoli, the needle checksum (reference
// weed/storage/needle/crc.go). Hardware SSE4.2 crc32 instructions when the
// build enables them, slice-by-8 tables otherwise.
//
// Build (native/crc.py does this at first use):
//   g++ -O3 -shared -fPIC [-msse4.2] -o libcrc32c.so crc32c.cpp

#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

struct Crc32cTables {
  uint32_t tab[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      tab[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        tab[s][i] = (tab[s - 1][i] >> 8) ^ tab[0][tab[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrcC;

}  // namespace

extern "C" uint32_t crc32c(uint32_t crc, const uint8_t* buf, long long n) {
  crc = ~crc;
  long long i = 0;
#if defined(__SSE4_2__)
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    std::memcpy(&v, buf + i, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
  }
  for (; i < n; i++) crc = _mm_crc32_u8(crc, buf[i]);
#else
  for (; i + 8 <= n; i += 8) {
    crc ^= static_cast<uint32_t>(buf[i]) | (static_cast<uint32_t>(buf[i + 1]) << 8) |
           (static_cast<uint32_t>(buf[i + 2]) << 16) |
           (static_cast<uint32_t>(buf[i + 3]) << 24);
    crc = kCrcC.tab[7][crc & 0xFF] ^ kCrcC.tab[6][(crc >> 8) & 0xFF] ^
          kCrcC.tab[5][(crc >> 16) & 0xFF] ^ kCrcC.tab[4][crc >> 24] ^
          kCrcC.tab[3][buf[i + 4]] ^ kCrcC.tab[2][buf[i + 5]] ^
          kCrcC.tab[1][buf[i + 6]] ^ kCrcC.tab[0][buf[i + 7]];
  }
  for (; i < n; i++) crc = kCrcC.tab[0][(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
#endif
  return ~crc;
}
