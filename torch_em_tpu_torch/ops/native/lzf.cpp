// LZF compression (the stream format of liblzf, as HDF5's LZF filter 32000 stores it):
// a control byte below 32 starts a run of ctrl + 1 literal bytes; any other control byte
// is a back reference of length (ctrl >> 5) + 2 (a length field of 7 takes one more byte),
// at distance (((ctrl & 0x1f) << 8) | next byte) + 1 behind the output position.
//
// Built with g++ into a shared library at first use (ops/native/lzf.py) and called through
// ctypes, which releases the GIL for the call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMaxLiteral = 32;     // literals one control byte can announce
constexpr int64_t kMaxOffset = 1 << 13; // reach of a back reference
constexpr int64_t kMaxMatch = 264;      // 7 + 255 + 2
constexpr int kHashLog = 16;

inline uint32_t hash3(const uint8_t* p) {
  uint32_t v = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | uint32_t(p[2]);
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// Compress in[0, in_len) into out[0, out_len). Returns the compressed length, or 0 when the
// stream does not fit into out_len bytes (HDF5's LZF filter then stores the chunk as it is).
int64_t tem_lzf_compress(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  if (in_len <= 0 || out_len <= 1) return 0;
  std::vector<int64_t> table(size_t(1) << kHashLog, -1);
  int64_t ip = 0, op = 1, lit = 0;  // out[op - lit - 1] is the pending literal run's control byte
  while (ip < in_len) {
    int64_t length = 0, ref = -1;
    if (ip + 2 < in_len) {
      uint32_t h = hash3(in + ip);
      ref = table[h];
      table[h] = ip;
      if (ref >= 0 && ip - ref <= kMaxOffset && in[ref] == in[ip] && in[ref + 1] == in[ip + 1] &&
          in[ref + 2] == in[ip + 2]) {
        int64_t limit = in_len - ip < kMaxMatch ? in_len - ip : kMaxMatch;
        length = 3;
        while (length < limit && in[ref + length] == in[ip + length]) ++length;
      }
    }
    if (length >= 3) {
      if (op + 3 + 1 > out_len) return 0;
      if (lit) {
        out[op - lit - 1] = uint8_t(lit - 1);
      } else {
        --op;  // the reserved control byte of an empty literal run goes
      }
      int64_t code = length - 2, offset = ip - ref - 1;
      if (code < 7) {
        out[op++] = uint8_t((offset >> 8) + (code << 5));
      } else {
        out[op++] = uint8_t((offset >> 8) + (7 << 5));
        out[op++] = uint8_t(code - 7);
      }
      out[op++] = uint8_t(offset & 0xff);
      ++op;  // reserve the next literal run's control byte
      lit = 0;
      for (int64_t k = ip + 1; k < ip + length && k + 2 < in_len; ++k) table[hash3(in + k)] = k;
      ip += length;
    } else {
      if (op + 1 > out_len) return 0;
      out[op++] = in[ip++];
      if (++lit == kMaxLiteral) {
        if (op + 1 > out_len) return 0;
        out[op - lit - 1] = uint8_t(lit - 1);
        lit = 0;
        ++op;
      }
    }
  }
  if (lit) {
    out[op - lit - 1] = uint8_t(lit - 1);
  } else {
    --op;
  }
  return op;
}

// Decompress in[0, in_len) into out[0, out_len). Returns the decompressed length, -1 for a
// corrupt stream and -2 when out_len is too small.
int64_t tem_lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  int64_t ip = 0, op = 0;
  while (ip < in_len) {
    int64_t ctrl = in[ip++];
    if (ctrl < 32) {
      int64_t n = ctrl + 1;
      if (op + n > out_len) return -2;
      if (ip + n > in_len) return -1;
      std::memcpy(out + op, in + ip, size_t(n));
      op += n;
      ip += n;
    } else {
      int64_t length = ctrl >> 5;
      if (ip >= in_len) return -1;
      if (length == 7) {
        length += in[ip++];
        if (ip >= in_len) return -1;
      }
      int64_t ref = op - ((ctrl & 0x1f) << 8) - 1 - in[ip++];
      length += 2;
      if (op + length > out_len) return -2;
      if (ref < 0) return -1;
      for (int64_t k = 0; k < length; ++k) out[op + k] = out[ref + k];
      op += length;
    }
  }
  return op;
}

}  // extern "C"
