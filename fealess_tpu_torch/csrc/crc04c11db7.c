/* The CRC-32 of polynomial 0x04C11DB7, most significant bit first, with
 * no final XOR (FFmpeg's ff_crc04C11DB7_update): Ogg's page CRC and NUT's
 * checksums from 0, MPEG-TS section CRCs from 0xFFFFFFFF.  Host C for
 * io/crc.py: built with the host compiler at first use
 * (ops/_build.build_host) and called through ctypes. */
#include <stdint.h>

static uint32_t table[256];
static int ready;

static void init_table(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i << 24;
    for (int k = 0; k < 8; k++)
      c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
    table[i] = c;
  }
  ready = 1;
}

uint32_t fl_crc04c11db7(uint32_t crc, const uint8_t *data, long n) {
  if (!ready) init_table();
  for (long i = 0; i < n; i++)
    crc = (crc << 8) ^ table[(crc >> 24) ^ data[i]];
  return crc;
}
