/* CRC-32C (Castagnoli) of many byte ranges of one buffer.
 *
 * The benchmark's own checksum, for the needles it writes: upstream's
 * needle checksum is the CRC-32C of the data (weed/storage/needle/crc.go).
 * With SSE4.2 the crc32 instruction does 8 bytes a step; without it a
 * byte table of the reflected polynomial 0x82F63B78 does the same.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#ifdef __SSE4_2__
#include <nmmintrin.h>
#endif

static uint32_t table[256];
static int table_ready = 0;

static void make_table(void) {
    for (uint32_t b = 0; b < 256; b++) {
        uint32_t c = b;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        table[b] = c;
    }
    table_ready = 1;
}

static uint32_t crc32c(const uint8_t *p, int64_t n) {
    uint32_t c = 0xFFFFFFFFu;
#ifdef __SSE4_2__
    uint64_t c64 = c;
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        c64 = _mm_crc32_u64(c64, w);
        p += 8;
        n -= 8;
    }
    c = (uint32_t)c64;
    while (n-- > 0)
        c = _mm_crc32_u8(c, *p++);
#else
    while (n-- > 0)
        c = table[(c ^ *p++) & 0xFF] ^ (c >> 8);
#endif
    return c ^ 0xFFFFFFFFu;
}

void crc32c_many(const uint8_t *buf, const int64_t *offsets,
                 const int64_t *lengths, int64_t count, uint32_t *out) {
    if (!table_ready)
        make_table();
    for (int64_t i = 0; i < count; i++)
        out[i] = crc32c(buf + offsets[i], lengths[i]);
}
