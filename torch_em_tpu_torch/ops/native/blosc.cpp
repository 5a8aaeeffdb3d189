// Blosc 1.x frames, the chunk codec that zarr v2 and N5 write by default (c-blosc's format 2).
//
// A frame is a 16-byte header (version, codec version, flags, typesize, then little-endian
// uint32 nbytes, blocksize and ctbytes), then either the nbytes as they are (flag 0x02,
// "memcpyed") or a table of one uint32 start offset per block followed by the blocks. A block
// holds typesize streams (one per byte of the element, after the byte shuffle) unless flag 0x10
// ("don't split") is set or it is the last, shorter block; each stream is a uint32 length and
// that many bytes, stored as they are when the length equals the stream's size. Flags 0x01 and
// 0x04 mark byte and bit shuffle; bits 5-7 name the codec: 0 blosclz, 1 LZ4 (lz4 and lz4hc),
// 2 snappy, 3 zlib, 4 zstd.
//
// This file decodes the memcpyed, blosclz and LZ4 frames, walks zlib frames for the caller
// (which inflates each stream, tem_blosc_streams / tem_blosc_unshuffle), and encodes LZ4 frames
// with byte or bit shuffle as c-blosc does by default. It links only libc and libstdc++. Built
// with g++ into a shared library at first use (ops/native/blosc.py) and called through ctypes,
// which releases the GIL for the call; every buffer is the caller's or a local vector, so calls
// run at once from several threads.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int64_t kHeader = 16;
constexpr uint8_t kByteShuffle = 0x01, kMemcpyed = 0x02, kBitShuffle = 0x04, kDontSplit = 0x10;
constexpr int kBloscLZ = 0, kLZ4 = 1, kSnappy = 2, kZlib = 3, kZstd = 4;
constexpr int64_t kMaxSplits = 16, kMinBuffer = 128;
// error codes (the Python side names them)
constexpr int64_t kCorrupt = -1, kTooLarge = -2, kCodecSnappy = -3, kCodecZstd = -4, kCodecZlib = -5,
                  kCodecUnknown = -6, kVersion = -7, kNoMemory = -8;

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

inline void store_le32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16);
  p[3] = uint8_t(v >> 24);
}

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

struct Header {
  int version, flags, typesize, format;
  int64_t nbytes, blocksize, ctbytes;
};

int64_t parse_header(const uint8_t* src, int64_t len, Header* h) {
  if (len < kHeader) return kCorrupt;
  h->version = src[0];
  h->flags = src[2];
  h->typesize = src[3];
  h->nbytes = load_le32(src + 4);
  h->blocksize = load_le32(src + 8);
  h->ctbytes = load_le32(src + 12);
  h->format = (h->flags >> 5) & 7;
  // format 2 is c-blosc 1.x's; blosc2's extended header (flags 0x01 and 0x04 together) is another layout
  if (h->version < 1 || h->version > 4 || (h->version > 2 && (h->flags & 0x05) == 0x05)) return kVersion;
  if (h->ctbytes < kHeader || h->ctbytes > len || h->typesize < 1) return kCorrupt;
  // c-blosc's blocks are never larger than the buffer
  if (!(h->flags & kMemcpyed) && h->nbytes > 0 && (h->blocksize < 1 || h->blocksize > h->nbytes)) return kCorrupt;
  return 0;
}

// LZ4 block format: a token (literal length << 4 | match length - 4, 15 meaning more bytes of
// 255 follow), the literals, a little-endian 16-bit offset and the match; the last sequence
// holds literals only.
int64_t lz4_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  while (true) {
    if (ip >= iend) return kCorrupt;
    const unsigned token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) return kCorrupt;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > size_t(iend - ip) || lit > size_t(oend - op)) return kCorrupt;
    std::memcpy(op, ip, lit);
    op += lit;
    ip += lit;
    if (ip == iend) break;
    if (iend - ip < 2) return kCorrupt;
    const size_t offset = size_t(ip[0]) | (size_t(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || offset > size_t(op - dst)) return kCorrupt;
    size_t match = token & 15;
    if (match == 15) {
      unsigned b;
      do {
        if (ip >= iend) return kCorrupt;
        b = *ip++;
        match += b;
      } while (b == 255);
    }
    match += 4;
    if (match > size_t(oend - op)) return kCorrupt;
    const uint8_t* ref = op - offset;
    if (offset >= match) {
      std::memcpy(op, ref, match);
      op += match;
    } else if (offset >= 8) {
      // each 8-byte step reads bytes at least 8 behind where it writes
      size_t i = 0;
      for (; i + 8 <= match; i += 8) std::memcpy(op + i, ref + i, 8);
      for (; i < match; ++i) op[i] = ref[i];
      op += match;
    } else if (offset == 1) {
      std::memset(op, *ref, match);
      op += match;
    } else {
      // a short period: lay down its first 8 bytes one by one, then copy from a whole number of
      // periods back (at least 8), 8 bytes at a time
      const size_t head = match < 8 ? match : 8;
      for (size_t i = 0; i < head; ++i) op[i] = ref[i];
      const size_t back = offset * ((8 + offset - 1) / offset);
      size_t i = head;
      for (; i + 8 <= match; i += 8) std::memcpy(op + i, op + i - back, 8);
      for (; i < match; ++i) op[i] = op[i - back];
      op += match;
    }
  }
  return op - dst;
}

// LZ4 block compressor: greedy, one hash table of 4-byte sequences, skipping faster through
// data that does not match (as the reference compressor does). The last 5 bytes are literals
// and no match starts within the last 12, so any LZ4 decoder takes the block. Returns the
// compressed length, or 0 when it does not fit into cap bytes.
constexpr int kHashLog = 12;
constexpr int64_t kMinMatch = 4, kLastLiterals = 5, kMatchFind = 12, kMaxOffset = 65535;

inline uint32_t lz4_hash(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

inline uint8_t* put_length(uint8_t* op, int64_t len) {
  for (; len >= 255; len -= 255) *op++ = 255;
  *op++ = uint8_t(len);
  return op;
}

int64_t lz4_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  int64_t anchor = 0;
  if (n >= kMatchFind + 1) {
    int32_t table[1 << kHashLog];
    for (auto& t : table) t = -1;
    const int64_t last_start = n - kMatchFind;  // the last position a match may start at
    const int64_t match_end = n - kLastLiterals;
    int64_t ip = 0;
    while (true) {
      int64_t ref = -1;
      unsigned attempts = 1u << 6;
      while (true) {
        if (ip > last_start) goto last_literals;
        const uint32_t seq = load32(src + ip);
        const uint32_t h = lz4_hash(seq);
        ref = table[h];
        table[h] = int32_t(ip);
        if (ref >= 0 && ip - ref <= kMaxOffset && load32(src + ref) == seq) break;
        ip += attempts++ >> 6;
      }
      while (ip > anchor && ref > 0 && src[ip - 1] == src[ref - 1]) {
        --ip;
        --ref;
      }
      int64_t len = kMinMatch;
      while (ip + len < match_end && src[ref + len] == src[ip + len]) ++len;
      const int64_t lit = ip - anchor;
      if (op + 1 + lit / 255 + 1 + lit + 2 + (len - kMinMatch) / 255 + 1 > oend) return 0;
      uint8_t* token = op++;
      const int64_t lit_code = lit < 15 ? lit : 15, match_code = len - kMinMatch < 15 ? len - kMinMatch : 15;
      *token = uint8_t((lit_code << 4) | match_code);
      if (lit >= 15) op = put_length(op, lit - 15);
      std::memcpy(op, src + anchor, lit);
      op += lit;
      const int64_t offset = ip - ref;
      *op++ = uint8_t(offset);
      *op++ = uint8_t(offset >> 8);
      if (len - kMinMatch >= 15) op = put_length(op, len - kMinMatch - 15);
      ip += len;
      anchor = ip;
      if (ip > last_start) break;
      table[lz4_hash(load32(src + ip - 2))] = int32_t(ip - 2);
    }
  }
last_literals:
  const int64_t lit = n - anchor;
  if (op + 1 + lit / 255 + 1 + lit > oend) return 0;
  *op++ = uint8_t((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) op = put_length(op, lit - 15);
  std::memcpy(op, src + anchor, lit);
  op += lit;
  return op - dst;
}

// blosclz (FastLZ level 2): a control byte below 32 starts a run of ctrl + 1 literals; any other
// is a match of (ctrl >> 5) + 2 bytes (7 meaning more length bytes of 255 follow) at distance
// ((ctrl & 31) << 8) + next byte + 1, or, where those two give 31 << 8 and 255, at 8192 plus a
// big-endian 16-bit distance.
int64_t blosclz_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (n == 0) return 0;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  uint32_t ctrl = *ip++ & 31u;
  bool more = true;
  while (more) {
    if (ctrl >= 32) {
      int64_t len = int64_t(ctrl >> 5) - 1;
      int64_t distance = int64_t(ctrl & 31u) << 8;
      if (len == 6) {
        uint8_t code;
        do {
          if (ip >= iend) return kCorrupt;
          code = *ip++;
          len += code;
        } while (code == 255);
      }
      if (ip >= iend) return kCorrupt;
      const uint8_t code = *ip++;
      len += 3;
      if (code == 255 && distance == (31 << 8)) {
        if (iend - ip < 2) return kCorrupt;
        distance = (int64_t(ip[0]) << 8) + ip[1] + 8191;
        ip += 2;
      } else {
        distance += code;
      }
      distance += 1;
      if (len > oend - op || distance > op - dst) return kCorrupt;
      more = ip < iend;
      if (more) ctrl = *ip++;
      const uint8_t* ref = op - distance;
      for (int64_t i = 0; i < len; ++i) op[i] = ref[i];
      op += len;
    } else {
      const int64_t run = int64_t(ctrl) + 1;
      if (run > oend - op || run > iend - ip) return kCorrupt;
      std::memcpy(op, ip, run);
      op += run;
      ip += run;
      more = ip < iend;
      if (more) ctrl = *ip++;
    }
  }
  return op - dst;
}

// Byte shuffle: byte j of element i goes to j * count + i; the bytes past the last whole element
// stay where they are.
void byte_shuffle(const uint8_t* src, uint8_t* dst, int64_t size, int64_t typesize) {
  const int64_t count = size / typesize;
  for (int64_t j = 0; j < typesize; ++j) {
    uint8_t* out = dst + j * count;
    const uint8_t* in = src + j;
    for (int64_t i = 0; i < count; ++i) out[i] = in[i * typesize];
  }
  std::memcpy(dst + count * typesize, src + count * typesize, size - count * typesize);
}

void byte_unshuffle(const uint8_t* src, uint8_t* dst, int64_t size, int64_t typesize) {
  const int64_t count = size / typesize;
  if (typesize == 4) {
    const uint8_t *s0 = src, *s1 = src + count, *s2 = src + 2 * count, *s3 = src + 3 * count;
    for (int64_t i = 0; i < count; ++i) {
      dst[4 * i] = s0[i];
      dst[4 * i + 1] = s1[i];
      dst[4 * i + 2] = s2[i];
      dst[4 * i + 3] = s3[i];
    }
  } else {
    for (int64_t j = 0; j < typesize; ++j) {
      const uint8_t* in = src + j * count;
      uint8_t* out = dst + j;
      for (int64_t i = 0; i < count; ++i) out[i * typesize] = in[i];
    }
  }
  std::memcpy(dst + count * typesize, src + count * typesize, size - count * typesize);
}

// Transpose of the 8x8 bit matrix whose row r is byte r of x (its own inverse).
inline uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// Bit shuffle (bitshuffle's layout, as c-blosc 1.x applies it): bit k of byte j of element e goes
// to bit e % 8 of byte (j * 8 + k) * (count / 8) + e / 8. A block whose element count is not a
// multiple of 8 stays as it is; the bytes past the last whole element too.
void bit_shuffle(const uint8_t* src, uint8_t* dst, int64_t size, int64_t typesize) {
  const int64_t count = size / typesize;
  if (count % 8) {
    std::memcpy(dst, src, size);
    return;
  }
  const int64_t rows = count / 8;
  for (int64_t g = 0; g < rows; ++g) {
    for (int64_t j = 0; j < typesize; ++j) {
      uint64_t x = 0;
      for (int b = 0; b < 8; ++b) x |= uint64_t(src[(8 * g + b) * typesize + j]) << (8 * b);
      x = transpose8(x);
      for (int k = 0; k < 8; ++k) dst[(j * 8 + k) * rows + g] = uint8_t(x >> (8 * k));
    }
  }
  std::memcpy(dst + count * typesize, src + count * typesize, size - count * typesize);
}

void bit_unshuffle(const uint8_t* src, uint8_t* dst, int64_t size, int64_t typesize) {
  const int64_t count = size / typesize;
  if (count % 8) {
    std::memcpy(dst, src, size);
    return;
  }
  const int64_t rows = count / 8;
  for (int64_t j = 0; j < typesize; ++j) {
    const uint8_t* in = src + j * 8 * rows;
    for (int64_t g = 0; g < rows; ++g) {
      uint64_t x = 0;
      for (int k = 0; k < 8; ++k) x |= uint64_t(in[k * rows + g]) << (8 * k);
      x = transpose8(x);
      for (int b = 0; b < 8; ++b) dst[(8 * g + b) * typesize + j] = uint8_t(x >> (8 * b));
    }
  }
  std::memcpy(dst + count * typesize, src + count * typesize, size - count * typesize);
}

inline bool shuffled(const Header& h) {
  return ((h.flags & kByteShuffle) && h.typesize > 1) || (h.flags & kBitShuffle);
}

void unshuffle_block(const Header& h, const uint8_t* src, uint8_t* dst, int64_t size) {
  if ((h.flags & kByteShuffle) && h.typesize > 1) {
    byte_unshuffle(src, dst, size, h.typesize);
  } else if (h.flags & kBitShuffle) {
    bit_unshuffle(src, dst, size, h.typesize);
  } else {
    std::memcpy(dst, src, size);
  }
}

// Visit every stream of every block: fn(block, block_start, block_size, stream_src, cbytes,
// stream_dst_offset, stream_size) returns 0 or an error code.
template <typename Fn>
int64_t walk_streams(const uint8_t* src, const Header& h, Fn fn) {
  const int64_t nblocks = h.nbytes / h.blocksize + (h.nbytes % h.blocksize ? 1 : 0);
  if (kHeader + 4 * nblocks > h.ctbytes) return kCorrupt;
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t start = b * h.blocksize;
    const int64_t bsize = start + h.blocksize <= h.nbytes ? h.blocksize : h.nbytes - start;
    const bool leftover = bsize != h.blocksize;
    const int64_t nsplits = (!(h.flags & kDontSplit) && !leftover) ? h.typesize : 1;
    const int64_t neblock = bsize / nsplits;
    int64_t pos = load_le32(src + kHeader + 4 * b);
    for (int64_t s = 0; s < nsplits; ++s) {
      if (pos < kHeader || pos + 4 > h.ctbytes) return kCorrupt;
      const int64_t cbytes = load_le32(src + pos);
      pos += 4;
      if (cbytes > h.ctbytes - pos) return kCorrupt;
      const int64_t err = fn(b, start, bsize, src + pos, cbytes, start + s * neblock, neblock);
      if (err) return err;
      pos += cbytes;
    }
  }
  return 0;
}

int64_t codec_error(int format) {
  switch (format) {
    case kSnappy: return kCodecSnappy;
    case kZstd: return kCodecZstd;
    case kZlib: return kCodecZlib;
    default: return kCodecUnknown;
  }
}

// c-blosc 1.x's block size for clevel 5 and a fast codec: 128 KiB, times the typesize where the
// block is split into streams (at least 64 KiB, at most 1 MiB), never more than the buffer.
int64_t block_size(int64_t nbytes, int64_t typesize, int clevel, bool* split) {
  int64_t bs = nbytes;
  if (nbytes >= 32 * 1024) {
    bs = 32 * 1024;
    if (clevel <= 0) bs /= 4;
    else if (clevel == 1) bs /= 2;
    else if (clevel == 3) bs *= 2;
    else if (clevel == 4 || clevel == 5) bs *= 4;
    else if (clevel >= 6) bs *= 8;
  }
  *split = typesize <= kMaxSplits && bs / typesize >= kMinBuffer;
  if (clevel > 0 && *split) {
    if (bs > (1 << 18)) bs = 1 << 18;
    bs *= typesize;
    if (bs < (1 << 16)) bs = 1 << 16;
    if (bs > (1 << 20)) bs = 1 << 20;
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

}  // namespace

extern "C" {

// Decode the frame src[0, len) into dst[0, cap). Returns nbytes, or a negative error code:
// -1 corrupt, -2 more than cap bytes, -3 snappy, -4 zstd, -5 zlib (inflated by the caller through
// tem_blosc_streams and tem_blosc_unshuffle), -6 an unknown codec, -7 another format version, -8 out of
// memory.
int64_t tem_blosc_decompress(const uint8_t* src, int64_t len, uint8_t* dst, int64_t cap) try {
  Header h;
  int64_t err = parse_header(src, len, &h);
  if (err) return err;
  if (h.nbytes > cap) return kTooLarge;
  if (h.flags & kMemcpyed) {
    if (kHeader + h.nbytes > h.ctbytes) return kCorrupt;
    std::memcpy(dst, src + kHeader, h.nbytes);
    return h.nbytes;
  }
  if (h.nbytes == 0) return 0;
  if (h.format != kLZ4 && h.format != kBloscLZ) return codec_error(h.format);
  const bool shuffle = shuffled(h);
  std::vector<uint8_t> tmp(shuffle ? h.blocksize : 0);
  int64_t current = -1;
  err = walk_streams(src, h, [&](int64_t b, int64_t start, int64_t, const uint8_t* s, int64_t cbytes,
                                 int64_t offset, int64_t size) -> int64_t {
    if (shuffle && current != b) {
      if (current >= 0) {
        const int64_t prev = current * h.blocksize;
        unshuffle_block(h, tmp.data(), dst + prev, std::min(h.blocksize, h.nbytes - prev));
      }
      current = b;
    }
    uint8_t* out = shuffle ? tmp.data() + (offset - start) : dst + offset;
    if (cbytes == size) {
      std::memcpy(out, s, size);
      return 0;
    }
    const int64_t got = h.format == kLZ4 ? lz4_decode(s, cbytes, out, size) : blosclz_decode(s, cbytes, out, size);
    return got == size ? 0 : kCorrupt;
  });
  if (err) return err;
  if (shuffle && current >= 0) {
    const int64_t prev = current * h.blocksize;
    unshuffle_block(h, tmp.data(), dst + prev, std::min(h.blocksize, h.nbytes - prev));
  }
  return h.nbytes;
} catch (const std::bad_alloc&) {
  return kNoMemory;
}

// The streams of a frame that is not memcpyed, for a caller that decodes them itself: row i of
// table holds the stream's offset in src, its stored length, its offset in the unshuffled-to-be
// buffer and its size. Returns the number of rows (at most max_rows), or an error code.
int64_t tem_blosc_streams(const uint8_t* src, int64_t len, int64_t* table, int64_t max_rows) {
  Header h;
  int64_t err = parse_header(src, len, &h);
  if (err) return err;
  if ((h.flags & kMemcpyed) || h.nbytes == 0) return 0;
  int64_t rows = 0;
  err = walk_streams(src, h, [&](int64_t, int64_t, int64_t, const uint8_t* s, int64_t cbytes, int64_t offset,
                                 int64_t size) -> int64_t {
    if (rows >= max_rows) return kCorrupt;
    int64_t* row = table + 4 * rows++;
    row[0] = s - src;
    row[1] = cbytes;
    row[2] = offset;
    row[3] = size;
    return 0;
  });
  return err ? err : rows;
}

// Undo the frame's shuffle, block by block, from staged (the streams decoded in place) to dst.
int64_t tem_blosc_unshuffle(const uint8_t* src, int64_t len, const uint8_t* staged, uint8_t* dst) {
  Header h;
  int64_t err = parse_header(src, len, &h);
  if (err) return err;
  for (int64_t start = 0; start < h.nbytes; start += h.blocksize) {
    const int64_t size = std::min(h.blocksize, h.nbytes - start);
    unshuffle_block(h, staged + start, dst + start, size);
  }
  return h.nbytes;
}

// Encode src[0, nbytes) as a blosc LZ4 frame into dst[0, cap), cap >= nbytes + 16: shuffle 0
// none, 1 byte, 2 bit. A buffer below 128 bytes, clevel 0, or data that would not shrink is
// stored memcpyed, as c-blosc does. Returns the frame's length, or a negative error code.
int64_t tem_blosc_compress(const uint8_t* src, int64_t nbytes, int64_t typesize, int shuffle, int clevel, uint8_t* dst,
                           int64_t cap) try {
  if (nbytes > 0x7fffffffll - kHeader || cap < nbytes + kHeader) return kTooLarge;
  if (typesize < 1 || typesize > 255) typesize = 1;
  bool split = false;
  const int64_t blocksize = nbytes > 0 ? block_size(nbytes, typesize, clevel, &split) : 0;
  uint8_t flags = uint8_t(kLZ4 << 5);
  if (shuffle == 1) flags |= kByteShuffle;
  if (shuffle == 2) flags |= kBitShuffle;
  if (!split) flags |= kDontSplit;
  dst[0] = 2;
  dst[1] = 1;
  dst[3] = uint8_t(typesize);
  store_le32(dst + 4, uint32_t(nbytes));
  store_le32(dst + 8, uint32_t(blocksize));
  const int64_t limit = nbytes + kHeader;
  int64_t op = -1;
  if (clevel > 0 && nbytes >= kMinBuffer) {
    const int64_t nblocks = nbytes / blocksize + (nbytes % blocksize ? 1 : 0);
    op = kHeader + 4 * nblocks;
    std::vector<uint8_t> tmp(blocksize);
    const bool shuffled_input = (shuffle == 1 && typesize > 1) || shuffle == 2;
    for (int64_t b = 0; b < nblocks && op >= 0; ++b) {
      const int64_t start = b * blocksize;
      const int64_t bsize = std::min(blocksize, nbytes - start);
      const uint8_t* block = src + start;
      if (shuffled_input) {
        if (shuffle == 1) byte_shuffle(block, tmp.data(), bsize, typesize);
        else bit_shuffle(block, tmp.data(), bsize, typesize);
        block = tmp.data();
      }
      store_le32(dst + kHeader + 4 * b, uint32_t(op));
      const int64_t nsplits = (split && bsize == blocksize) ? typesize : 1;
      const int64_t neblock = bsize / nsplits;
      for (int64_t s = 0; s < nsplits; ++s) {
        if (op + 4 + neblock > limit) {
          op = -1;
          break;
        }
        int64_t cbytes = lz4_encode(block + s * neblock, neblock, dst + op + 4, neblock);
        if (cbytes == 0 || cbytes >= neblock) {
          std::memcpy(dst + op + 4, block + s * neblock, neblock);
          cbytes = neblock;
        }
        store_le32(dst + op, uint32_t(cbytes));
        op += 4 + cbytes;
      }
    }
  }
  if (op < 0) {
    flags |= kMemcpyed;
    std::memcpy(dst + kHeader, src, nbytes);
    op = limit;
  }
  dst[2] = flags;
  store_le32(dst + 12, uint32_t(op));
  return op;
} catch (const std::bad_alloc&) {
  return kNoMemory;
}

}  // extern "C"
