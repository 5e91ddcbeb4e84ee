// RecordIO native kernels: crc32 + record-frame splitting.
//
// Capability parity with the reference's C++ recordio library (reference:
// paddle/fluid/recordio/{header,chunk,scanner,writer}.* — kMagicNumber
// header.h:23, chunk framing chunk.cc). The chunk header/IO orchestration
// lives in python (__init__.py); this file carries the byte-crunching hot
// path (checksum over chunk payloads, splitting a chunk payload into
// length-prefixed records) so scanning large files does not loop in
// python. Built lazily with g++ -O2 -shared; __init__.py falls back to
// pure python (zlib.crc32 + struct) when no compiler is available.
//
// Build: g++ -O2 -fPIC -shared -o librecordio.so native.cc

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// CRC-32 (IEEE 802.3, same polynomial as zlib.crc32) with a lazily built
// table — keeps the .so dependency-free.
static uint32_t g_table[256];
static bool g_table_ready = false;

static void build_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    }
    g_table[i] = c;
  }
  g_table_ready = true;
}

uint32_t rio_crc32(const uint8_t* data, size_t n) {
  if (!g_table_ready) build_table();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) {
    c = g_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

// CRC-32C (Castagnoli) — the checksum the snappy framing format mandates.
static uint32_t g_ctable[256];
static bool g_ctable_ready = false;

static void build_ctable() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
    }
    g_ctable[i] = c;
  }
  g_ctable_ready = true;
}

uint32_t rio_crc32c(const uint8_t* data, size_t n) {
  if (!g_ctable_ready) build_ctable();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) {
    c = g_ctable[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Raw snappy codec — the per-byte hot path of the pure-python codec in
// snappy_codec.py, same greedy hash-table scheme as C snappy. The python
// layer keeps the framing/orchestration and falls back to its own
// implementation when this library is unavailable.
// ---------------------------------------------------------------------------

static size_t emit_varint(uint8_t* out, uint64_t v) {
  size_t i = 0;
  while (v >= 0x80) {
    out[i++] = static_cast<uint8_t>((v & 0x7F) | 0x80);
    v >>= 7;
  }
  out[i++] = static_cast<uint8_t>(v);
  return i;
}

static size_t emit_literal(uint8_t* out, const uint8_t* src, size_t len) {
  size_t o = 0;
  while (len) {
    size_t ln = len > 65536 ? 65536 : len;
    if (ln <= 60) {
      out[o++] = static_cast<uint8_t>((ln - 1) << 2);
    } else if (ln <= 256) {
      out[o++] = 60 << 2;
      out[o++] = static_cast<uint8_t>(ln - 1);
    } else {
      out[o++] = 61 << 2;
      out[o++] = static_cast<uint8_t>((ln - 1) & 0xFF);
      out[o++] = static_cast<uint8_t>(((ln - 1) >> 8) & 0xFF);
    }
    std::memcpy(out + o, src, ln);
    o += ln;
    src += ln;
    len -= ln;
  }
  return o;
}

static size_t emit_copy(uint8_t* out, size_t off, size_t len) {
  size_t o = 0;
  while (len >= 68) {  // long matches split into <=64-byte copies
    out[o++] = (59 << 2) | 2;
    out[o++] = static_cast<uint8_t>(off & 0xFF);
    out[o++] = static_cast<uint8_t>((off >> 8) & 0xFF);
    len -= 60;
  }
  if (len > 64) {
    out[o++] = (59 << 2) | 2;
    out[o++] = static_cast<uint8_t>(off & 0xFF);
    out[o++] = static_cast<uint8_t>((off >> 8) & 0xFF);
    len -= 60;
  }
  if (len >= 4 && len <= 11 && off < 2048) {
    out[o++] = static_cast<uint8_t>(((len - 4) << 2) | ((off >> 8) << 5) | 1);
    out[o++] = static_cast<uint8_t>(off & 0xFF);
  } else {
    out[o++] = static_cast<uint8_t>(((len - 1) << 2) | 2);
    out[o++] = static_cast<uint8_t>(off & 0xFF);
    out[o++] = static_cast<uint8_t>((off >> 8) & 0xFF);
  }
  return o;
}

// Greedy compress. `cap` must be >= 8 + n + 3*(n/65536 + 1) (literal-only
// worst case; copies never cost more than the literal bytes they replace).
// Returns the compressed length, or -1 if cap is insufficient.
long rio_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                         size_t cap) {
  if (cap < 8 + n + 3 * (n / 65536 + 1)) return -1;
  size_t o = emit_varint(out, n);
  if (n < 4) {
    if (n) o += emit_literal(out + o, in, n);
    return static_cast<long>(o);
  }
  const int kShift = 32 - 14;  // 16384-entry table
  static thread_local int64_t table[1 << 14];
  for (size_t i = 0; i < (1u << 14); ++i) table[i] = -1;
  size_t pos = 0, lit = 0;
  const size_t limit = n - 3;
  while (pos < limit) {
    uint32_t cur;
    std::memcpy(&cur, in + pos, 4);
    uint32_t h = (cur * 0x1E35A7BDu) >> kShift;
    int64_t cand = table[h];
    table[h] = static_cast<int64_t>(pos);
    if (cand >= 0 && pos - static_cast<size_t>(cand) <= 0xFFFF) {
      uint32_t cv;
      std::memcpy(&cv, in + cand, 4);
      if (cv == cur) {
        size_t m = 4;  // overlap-extending match is legal in snappy
        while (pos + m < n && in[cand + m] == in[pos + m]) ++m;
        o += emit_literal(out + o, in + lit, pos - lit);
        o += emit_copy(out + o, pos - static_cast<size_t>(cand), m);
        pos += m;
        lit = pos;
        continue;
      }
    }
    ++pos;
  }
  o += emit_literal(out + o, in + lit, n - lit);
  return static_cast<long>(o);
}

// Full raw-snappy decoder. Returns the decompressed length, -1 on a
// malformed stream, or -2 if `cap` is smaller than the declared length.
long rio_snappy_decompress(const uint8_t* in, size_t n, uint8_t* out,
                           size_t cap) {
  uint64_t expected = 0;
  int shift = 0;
  size_t pos = 0;
  while (true) {
    if (pos >= n) return -1;
    uint8_t b = in[pos++];
    expected |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 32) return -1;
  }
  if (expected > cap) return -2;
  size_t o = 0;
  while (pos < n) {
    uint8_t tag = in[pos++];
    uint32_t kind = tag & 3;
    if (kind == 0) {  // literal
      size_t ln = tag >> 2;
      if (ln >= 60) {
        size_t nb = ln - 59;
        if (pos + nb > n) return -1;
        ln = 0;
        for (size_t i = 0; i < nb; ++i) ln |= static_cast<size_t>(in[pos + i]) << (8 * i);
        pos += nb;
      }
      ++ln;
      if (pos + ln > n || o + ln > cap) return -1;
      std::memcpy(out + o, in + pos, ln);
      o += ln;
      pos += ln;
      continue;
    }
    size_t ln, off;
    if (kind == 1) {
      ln = ((tag >> 2) & 7) + 4;
      if (pos >= n) return -1;
      off = (static_cast<size_t>(tag >> 5) << 8) | in[pos];
      pos += 1;
    } else if (kind == 2) {
      ln = (tag >> 2) + 1;
      if (pos + 2 > n) return -1;
      off = in[pos] | (static_cast<size_t>(in[pos + 1]) << 8);
      pos += 2;
    } else {
      ln = (tag >> 2) + 1;
      if (pos + 4 > n) return -1;
      off = 0;
      for (int i = 0; i < 4; ++i) off |= static_cast<size_t>(in[pos + i]) << (8 * i);
      pos += 4;
    }
    if (off == 0 || off > o || o + ln > cap) return -1;
    size_t start = o - off;
    for (size_t i = 0; i < ln; ++i) out[o + i] = out[start + i];  // overlap-safe
    o += ln;
  }
  if (o != expected) return -1;
  return static_cast<long>(o);
}

// Split a chunk payload (concatenated [u32-le length | bytes] frames) into
// (offset, length) pairs. Returns the record count, or -1 on a malformed
// payload (truncated frame / overflow), or -2 if there are more records
// than max_records.
long rio_split_records(const uint8_t* payload, size_t n, uint32_t* offsets,
                       uint32_t* lengths, size_t max_records) {
  size_t pos = 0;
  size_t count = 0;
  while (pos < n) {
    if (pos + 4 > n) return -1;
    uint32_t len;
    std::memcpy(&len, payload + pos, 4);  // little-endian hosts only (x86/ARM)
    pos += 4;
    if (pos + len > n) return -1;
    if (count >= max_records) return -2;
    offsets[count] = static_cast<uint32_t>(pos);
    lengths[count] = len;
    pos += len;
    ++count;
  }
  return static_cast<long>(count);
}

}  // extern "C"
