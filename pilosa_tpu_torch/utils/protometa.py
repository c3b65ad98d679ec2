"""Minimal protobuf reader/writer for the reference's .meta files.

The reference persists per-index/field metadata as protobuf messages
(reference internal/private.proto: IndexMeta{Keys=3},
FieldOptions{CacheType=3, CacheSize=4, TimeQuantum=5, Type=8, Min=9,
Max=10, Keys=11}). Our native format is JSON; this module lets a
reference-generated data directory open in place — fragments already
parse via the roaring format reader.

Hand-rolled varint codec: the messages are two flat structs, a protobuf
dependency isn't warranted.
"""

from __future__ import annotations



def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        out |= (b & 0x7F) << shift
        i += 1
        if not (b & 0x80):
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _decode_fields(data: bytes) -> dict[int, object]:
    """Wire-level decode: field number -> last value (varint or bytes)."""
    out: dict[int, object] = {}
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field_no = key >> 3
        wire = key & 7
        if wire == 0:  # varint
            v, i = _read_varint(data, i)
            out[field_no] = v
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            if i + ln > len(data):
                # a partially-written .meta must fail loudly, not decode
                # to silently-truncated bytes / default field options
                raise ValueError("length-delimited field overruns buffer")
            out[field_no] = data[i : i + ln]
            i += ln
        elif wire == 1:  # 64-bit
            if i + 8 > len(data):
                raise ValueError("fixed64 field overruns buffer")
            out[field_no] = int.from_bytes(data[i : i + 8], "little")
            i += 8
        elif wire == 5:  # 32-bit
            if i + 4 > len(data):
                raise ValueError("fixed32 field overruns buffer")
            out[field_no] = int.from_bytes(data[i : i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return out


def _signed64(v: int) -> int:
    """proto int64 is a plain varint in two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def decode_index_meta(data: bytes) -> dict:
    f = _decode_fields(data)
    return {"keys": bool(f.get(3, 0))}


def decode_field_options(data: bytes) -> dict:
    f = _decode_fields(data)

    def s(n):
        v = f.get(n)
        return v.decode() if isinstance(v, bytes) else ""

    return {
        "type": s(8) or "set",
        "cacheType": s(3) or "ranked",
        "cacheSize": int(f.get(4, 0)) or 50000,
        "timeQuantum": s(5),
        "min": _signed64(int(f.get(9, 0))),
        "max": _signed64(int(f.get(10, 0))),
        "keys": bool(f.get(11, 0)),
    }


def _write_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_tag(out: bytearray, field_no: int, wire: int) -> None:
    _write_varint(out, (field_no << 3) | wire)


def encode_field_options(opts: dict) -> bytes:
    """Reference-compatible FieldOptions bytes (for export tooling)."""
    out = bytearray()
    if opts.get("cacheType"):
        _write_tag(out, 3, 2)
        b = opts["cacheType"].encode()
        _write_varint(out, len(b))
        out += b
    if opts.get("cacheSize"):
        _write_tag(out, 4, 0)
        _write_varint(out, opts["cacheSize"])
    if opts.get("timeQuantum"):
        _write_tag(out, 5, 2)
        b = opts["timeQuantum"].encode()
        _write_varint(out, len(b))
        out += b
    if opts.get("type"):
        _write_tag(out, 8, 2)
        b = opts["type"].encode()
        _write_varint(out, len(b))
        out += b
    if opts.get("min"):
        _write_tag(out, 9, 0)
        _write_varint(out, opts["min"])
    if opts.get("max"):
        _write_tag(out, 10, 0)
        _write_varint(out, opts["max"])
    if opts.get("keys"):
        _write_tag(out, 11, 0)
        _write_varint(out, 1)
    return bytes(out)


def encode_index_meta(keys: bool) -> bytes:
    out = bytearray()
    if keys:
        _write_tag(out, 3, 0)
        _write_varint(out, 1)
    return bytes(out)
