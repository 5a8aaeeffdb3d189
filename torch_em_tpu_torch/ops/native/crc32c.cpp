// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum of TFRecord framing that
// TensorBoard's event files use (utils/tensorboard.py). Slicing-by-8: eight 256-entry tables,
// eight input bytes per step.
//
// Built with g++ into a shared library at first use (ops/native/crc32c.py) and called through
// ctypes, which releases the GIL for the call.

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k) crc = (crc >> 1) ^ (0x82F63B78u & (0u - (crc & 1u)));
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

}  // namespace

extern "C" {

// The CRC-32C of data[0, n), continuing from a previous result crc (0 to start).
uint32_t tem_crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  const auto& t = kTables.t;
  crc = ~crc;
  while (n > 0 && (reinterpret_cast<uintptr_t>(data) & 7) != 0) {
    crc = (crc >> 8) ^ t[0][(crc ^ *data++) & 0xFF];
    --n;
  }
  for (; n >= 8; n -= 8, data += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;  // little-endian: the first byte is the low byte
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  while (n-- > 0) crc = (crc >> 8) ^ t[0][(crc ^ *data++) & 0xFF];
  return ~crc;
}

}  // extern "C"
