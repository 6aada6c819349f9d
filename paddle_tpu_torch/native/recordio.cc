// Native recordio codec: chunk encode/decode with zlib + CRC32.
//
// The port's copy of paddle_tpu/native/recordio.cc, the analog of the
// reference's C++ recordio core
// (reference: paddle/fluid/recordio/chunk.cc — Chunk::Write/Parse with
// compression + CRC over the payload; header.cc).  The Python
// Writer/Scanner (paddle_tpu_torch/data/recordio.py) call this through ctypes
// when the shared library is present, keeping record framing and
// integrity checking off the interpreter's hot path; the wire format is
// byte-identical to the pure-python fallback.
//
// Build: paddle_tpu_torch/native/__init__.py builds it at first use into
// paddle_tpu_torch/_build/ (g++ -O2 -shared -fPIC ... -lz), keyed by a
// hash of this source.
//
// C ABI (ctypes-friendly; all lengths in bytes):
//   rio_encode_chunk(records, lens, n, compress, out, out_cap) -> written
//       records: concatenated record bytes; lens[n]: per-record lengths.
//       Emits header|payload exactly as recordio.py's _HEADER layout:
//       magic:u32 | compressor:u8 | num:u32 | payload_len:u32 | crc:u32.
//       Returns bytes written, or -1 (capacity) / -2 (zlib error).
//   rio_decode_chunk(chunk, len, out, out_cap, lens_out, lens_cap,
//                    n_out) -> 0 ok; negative error codes:
//       -1 short/bad header, -2 bad magic, -3 CRC mismatch,
//       -4 zlib error, -5 capacity, -6 truncated records.
//   rio_encode_bound(total_record_bytes, n) -> worst-case output size.

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x0166CE11;
constexpr uint8_t kCompressNone = 0;
constexpr uint8_t kCompressZlib = 1;
// header: magic u32 | compressor u8 | num u32 | payload_len u32 | crc u32
constexpr size_t kHeaderSize = 4 + 1 + 4 + 4 + 4;

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

uint32_t get_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" {

long long rio_encode_bound(long long total_record_bytes, int n) {
  // payload = records + 4 bytes length prefix each; zlib worst case
  // ~ payload + payload/1000 + 64; plus header.
  long long payload = total_record_bytes + 4LL * n;
  return kHeaderSize + payload + payload / 1000 + 64;
}

long long rio_encode_chunk(const uint8_t* records, const uint32_t* lens,
                           int n, int compress, uint8_t* out,
                           long long out_cap) {
  // assemble payload: [len u32 | bytes] per record
  size_t total = 0;
  for (int i = 0; i < n; ++i) total += 4 + lens[i];
  std::vector<uint8_t> payload(total);
  size_t off = 0;
  const uint8_t* src = records;
  for (int i = 0; i < n; ++i) {
    put_u32(payload.data() + off, lens[i]);
    off += 4;
    std::memcpy(payload.data() + off, src, lens[i]);
    off += lens[i];
    src += lens[i];
  }

  const uint8_t* body = payload.data();
  uLongf body_len = payload.size();
  std::vector<uint8_t> compressed;
  if (compress == kCompressZlib) {
    compressed.resize(compressBound(payload.size()));
    uLongf clen = compressed.size();
    if (compress2(compressed.data(), &clen, payload.data(), payload.size(),
                  Z_DEFAULT_COMPRESSION) != Z_OK) {
      return -2;
    }
    compressed.resize(clen);
    body = compressed.data();
    body_len = clen;
  }

  long long need = static_cast<long long>(kHeaderSize) + body_len;
  if (need > out_cap) return -1;
  uint32_t crc = crc32(0L, body, body_len);
  put_u32(out, kMagic);
  out[4] = static_cast<uint8_t>(compress);
  put_u32(out + 5, static_cast<uint32_t>(n));
  put_u32(out + 9, static_cast<uint32_t>(body_len));
  put_u32(out + 13, crc);
  std::memcpy(out + kHeaderSize, body, body_len);
  return need;
}

int rio_decode_chunk(const uint8_t* chunk, long long len, uint8_t* out,
                     long long out_cap, uint32_t* lens_out,
                     long long lens_cap, int* n_out) {
  if (len < static_cast<long long>(kHeaderSize)) return -1;
  if (get_u32(chunk) != kMagic) return -2;
  uint8_t comp = chunk[4];
  uint32_t n = get_u32(chunk + 5);
  uint32_t plen = get_u32(chunk + 9);
  uint32_t crc = get_u32(chunk + 13);
  if (len < static_cast<long long>(kHeaderSize) + plen) return -1;
  const uint8_t* body = chunk + kHeaderSize;
  if (crc32(0L, body, plen) != crc) return -3;

  std::vector<uint8_t> inflated;
  const uint8_t* payload = body;
  size_t payload_len = plen;
  if (comp == kCompressZlib) {
    // grow-and-retry inflate (decompressed size is not stored)
    uLongf cap = plen * 4 + 1024;
    for (int attempt = 0; attempt < 8; ++attempt) {
      inflated.resize(cap);
      uLongf dlen = cap;
      int rc = uncompress(inflated.data(), &dlen, body, plen);
      if (rc == Z_OK) {
        payload = inflated.data();
        payload_len = dlen;
        break;
      }
      if (rc != Z_BUF_ERROR) return -4;
      cap *= 4;
      if (attempt == 7) return -4;
    }
  } else if (comp != kCompressNone) {
    return -4;
  }

  if (static_cast<long long>(n) > lens_cap) return -5;
  size_t off = 0;
  size_t out_off = 0;
  for (uint32_t i = 0; i < n; ++i) {
    if (off + 4 > payload_len) return -6;
    uint32_t rlen = get_u32(payload + off);
    off += 4;
    if (off + rlen > payload_len) return -6;
    if (static_cast<long long>(out_off + rlen) > out_cap) return -5;
    std::memcpy(out + out_off, payload + off, rlen);
    lens_out[i] = rlen;
    out_off += rlen;
    off += rlen;
  }
  *n_out = static_cast<int>(n);
  return 0;
}

}  // extern "C"
