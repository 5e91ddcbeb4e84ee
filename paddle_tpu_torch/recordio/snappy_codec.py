"""Pure-Python snappy codec for RecordIO chunk payloads.

The reference writes RecordIO snappy chunks through the snappystream
library — the snappy FRAMED stream format ('sNaPpY' stream identifier,
per-frame masked CRC32C) wrapping raw-snappy frame bodies — and its
chunk header CRC covers the COMPRESSED payload (reference:
paddle/fluid/recordio/chunk.cc Chunk::Write `snappy::oSnappyStream` +
`Crc32Stream(sout)` after compression; header.h:25 kSnappy). This build
has no snappy wheel and zero egress, so both layers are implemented
directly from the public format specs:

- ``decompress`` is a COMPLETE raw-snappy decoder (literals + all three
  copy-element forms, including overlapping copies).
- ``compress`` is a real encoder: greedy hash-table matching over a 64 KB
  window emitting copy elements, the same scheme as C snappy — not the
  round-4 literal-only stub.
- ``compress_framed`` / ``decompress_framed`` / ``is_framed`` implement
  the framing format the reference actually writes (stream identifier,
  compressed/uncompressed frames, masked CRC32C per frame), so
  reference-written chunk payloads round-trip into this reader and
  vice versa.
"""

from __future__ import annotations

import ctypes
import struct


class SnappyError(IOError):
    pass


def _native():
    """The librecordio.so hot path (native.cc), if buildable: the greedy
    matcher and copy-replay are per-byte loops that belong in C++ — the
    pure-python paths below stay as the no-toolchain fallback and as the
    executable spec the tests cross-check against."""
    from . import _load_native

    return _load_native() or None


def _read_varint32(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise SnappyError("snappy: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & 0xFFFFFFFF, pos
        shift += 7
        if shift > 32:
            raise SnappyError("snappy: varint too long")


def _write_varint32(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(buf: bytes) -> bytes:
    """Full snappy raw-format decoder (native hot path when available)."""
    lib = _native()
    if lib is not None:
        expected, _ = _read_varint32(buf, 0)
        out = ctypes.create_string_buffer(max(expected, 1))
        m = lib.rio_snappy_decompress(bytes(buf), len(buf), out, expected)
        if m >= 0:
            return out.raw[:m]
        raise SnappyError("snappy: malformed stream"
                          if m == -1 else "snappy: length mismatch")
    return _decompress_py(buf)


def _decompress_py(buf: bytes) -> bytes:
    """Pure-python decoder — the executable spec and no-g++ fallback."""
    expected, pos = _read_varint32(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:                       # literal
            ln = tag >> 2
            if ln >= 60:                    # 60..63: length in next 1..4 bytes
                nbytes = ln - 59
                if pos + nbytes > n:
                    raise SnappyError("snappy: truncated literal length")
                ln = int.from_bytes(buf[pos:pos + nbytes], "little")
                pos += nbytes
            ln += 1
            if pos + ln > n:
                raise SnappyError("snappy: truncated literal")
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                       # copy, 1-byte offset
            ln = ((tag >> 2) & 0x07) + 4
            if pos >= n:
                raise SnappyError("snappy: truncated copy-1")
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            ln = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("snappy: truncated copy-2")
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            ln = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("snappy: truncated copy-4")
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise SnappyError("snappy: invalid copy offset")
        # overlapping copies are byte-at-a-time by spec
        start = len(out) - off
        if off >= ln:
            out += out[start:start + ln]
        else:
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != expected:
        raise SnappyError(
            f"snappy: length mismatch (got {len(out)}, expected {expected})")
    return bytes(out)


def _emit_literal(out: bytearray, buf: bytes, start: int, end: int):
    while start < end:
        ln = min(1 << 16, end - start)
        if ln <= 60:
            out.append((ln - 1) << 2)
        elif ln <= 0x100:
            out.append(60 << 2)
            out += (ln - 1).to_bytes(1, "little")
        else:
            out.append(61 << 2)
            out += (ln - 1).to_bytes(2, "little")
        out += buf[start:start + ln]
        start += ln


def _emit_copy(out: bytearray, off: int, ln: int):
    # long matches split into <=64-byte copies (C snappy does the same)
    while ln >= 68:
        out.append((59 << 2) | 2)                      # copy-2, len 60
        out += off.to_bytes(2, "little")
        ln -= 60
    if ln > 64:
        out.append((59 << 2) | 2)
        out += off.to_bytes(2, "little")
        ln -= 60
    if 4 <= ln <= 11 and off < 2048:
        out.append(((ln - 4) << 2) | ((off >> 8) << 5) | 1)
        out.append(off & 0xFF)
    else:
        out.append(((ln - 1) << 2) | 2)
        out += off.to_bytes(2, "little")


_HASH_MUL = 0x1E35A7BD                                 # C snappy's multiplier


def compress(buf: bytes) -> bytes:
    """Raw-snappy encoder with greedy hash-table matching (native hot
    path when available): 4-byte prefixes hash into a table of recent
    positions; a >=4-byte match within the 64 KB offset window becomes a
    copy element, everything between matches a literal."""
    lib = _native()
    if lib is not None:
        n = len(buf)
        cap = 16 + n + 3 * (n // 65536 + 1)
        out = ctypes.create_string_buffer(cap)
        m = lib.rio_snappy_compress(bytes(buf), n, out, cap)
        if m > 0:
            return out.raw[:m]
    return _compress_py(buf)


def _compress_py(buf: bytes) -> bytes:
    """Pure-python encoder — the executable spec and no-g++ fallback."""
    n = len(buf)
    out = bytearray(_write_varint32(n))
    if n < 4:
        if n:
            _emit_literal(out, buf, 0, n)
        return bytes(out)
    shift = 32 - 14                                    # 16384-entry table
    table = {}
    pos, lit_start = 0, 0
    limit = n - 3                                      # last 4-byte prefix
    u32 = struct.Struct("<I").unpack_from
    while pos < limit:
        h = ((u32(buf, pos)[0] * _HASH_MUL) & 0xFFFFFFFF) >> shift
        cand = table.get(h)
        table[h] = pos
        if (cand is not None and pos - cand <= 0xFFFF
                and buf[cand:cand + 4] == buf[pos:pos + 4]):
            # extend the match (cand+m can run past pos: overlapping
            # copies are legal and the decoder replays them byte-wise)
            m = 4
            while pos + m < n and buf[cand + m] == buf[pos + m]:
                m += 1
            _emit_literal(out, buf, lit_start, pos)
            _emit_copy(out, pos - cand, m)
            pos += m
            lit_start = pos
        else:
            pos += 1
    _emit_literal(out, buf, lit_start, n)
    return bytes(out)


# -- framing format (what the reference's snappystream writes) --------------

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_MAX_FRAME = 65536                                     # uncompressed bytes


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum the framing format mandates."""
    lib = _native()
    if lib is not None:
        return lib.rio_crc32c(bytes(data), len(data))
    return _crc32c_py(data)


def _crc32c_py(data: bytes) -> int:
    tab = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC32C_TABLE = None


def _crc32c_table():
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tab = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            tab.append(crc)
        _CRC32C_TABLE = tab
    return _CRC32C_TABLE


def _mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def is_framed(buf: bytes) -> bool:
    return buf[:len(_STREAM_ID)] == _STREAM_ID


def compress_framed(buf: bytes) -> bytes:
    """Snappy framing-format stream: identifier + per-frame masked CRC32C
    + raw-snappy frame bodies — byte-compatible with what the reference's
    snappystream emits/consumes."""
    out = bytearray(_STREAM_ID)
    for start in range(0, len(buf), _MAX_FRAME) or [0]:
        frame = buf[start:start + _MAX_FRAME]
        crc = _mask_crc(_crc32c(frame))
        body = compress(frame)
        if len(body) < len(frame):
            typ = 0x00                                 # compressed frame
        else:
            typ, body = 0x01, frame                    # incompressible
        out.append(typ)
        out += (len(body) + 4).to_bytes(3, "little")
        out += crc.to_bytes(4, "little")
        out += body
    return bytes(out)


def decompress_framed(buf: bytes) -> bytes:
    """Decode a framing-format stream, verifying each frame's CRC32C."""
    if not is_framed(buf):
        raise SnappyError("snappy: missing stream identifier")
    pos = len(_STREAM_ID)
    out = bytearray()
    n = len(buf)
    while pos < n:
        if pos + 4 > n:
            raise SnappyError("snappy: truncated frame header")
        typ = buf[pos]
        ln = int.from_bytes(buf[pos + 1:pos + 4], "little")
        pos += 4
        if pos + ln > n:
            raise SnappyError("snappy: truncated frame")
        body = buf[pos:pos + ln]
        pos += ln
        if typ in (0x00, 0x01):                        # (un)compressed data
            if ln < 4:
                raise SnappyError("snappy: frame too short for checksum")
            want = int.from_bytes(body[:4], "little")
            data = decompress(body[4:]) if typ == 0x00 else bytes(body[4:])
            if _mask_crc(_crc32c(data)) != want:
                raise SnappyError("snappy: frame CRC32C mismatch")
            out += data
        elif typ == 0xFF:                              # repeated stream id
            if body != _STREAM_ID[4:]:
                raise SnappyError("snappy: bad stream identifier frame")
        elif 0x80 <= typ <= 0xFD or typ == 0xFE:       # skippable / padding
            continue
        else:                                          # 0x02..0x7F reserved
            raise SnappyError(f"snappy: unknown frame type {typ:#x}")
    return bytes(out)
