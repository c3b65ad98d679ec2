"""Wire codec for the reference's public protobuf messages.

Reference clients (the Go CLI importer, the official client libraries)
speak protobuf to ``/index/{i}/query`` and ``/index/{i}/field/{f}/import``
via content negotiation (reference internal/public.proto:5-82,
http/handler.go:406-470,879-930). This module implements those message
shapes — QueryRequest/QueryResponse/QueryResult, Row, Pair, ValCount,
Attr, ColumnAttrSet, ImportRequest, ImportValueRequest — over the same
hand-rolled varint codec protometa.py uses for .meta files, so a
reference client can point at this server unchanged.

Field numbers and enums follow the reference wire format:
  QueryResult.Type: 0=nil 1=row 2=pairs 3=valcount 4=uint64 5=bool
    (http/handler.go:1100-1105)
  Attr.Type: 1=string 2=int 3=bool 4=float (attr.go:25-31)
Repeated scalars decode in both packed and unpacked form; encoding
packs, matching proto3 / gogo-gofast output.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

from pilosa_tpu_torch.utils.protometa import (
    _read_varint,
    _signed64,
    _write_tag,
    _write_varint,
)

CONTENT_TYPE = "application/x-protobuf"

RESULT_NIL = 0
RESULT_ROW = 1
RESULT_PAIRS = 2
RESULT_VALCOUNT = 3
RESULT_UINT64 = 4
RESULT_BOOL = 5

ATTR_STRING = 1
ATTR_INT = 2
ATTR_BOOL = 3
ATTR_FLOAT = 4


# -- wire-level helpers ------------------------------------------------------


def _decode_multi(data: bytes) -> dict[int, list]:
    """field number -> list of raw values (varint ints or bytes)."""
    out: dict[int, list] = {}
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field_no, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 2:
            ln, i = _read_varint(data, i)
            if i + ln > len(data):
                # a clipped length-delimited field must fail loudly, not
                # silently execute a truncated request (the handler maps
                # this to a 400)
                raise ValueError(
                    f"length-delimited field overruns buffer: "
                    f"need {ln} bytes at {i}, have {len(data) - i}"
                )
            v = data[i : i + ln]
            i += ln
        elif wire == 1:
            if i + 8 > len(data):
                raise ValueError("fixed64 field overruns buffer")
            v = int.from_bytes(data[i : i + 8], "little")
            i += 8
        elif wire == 5:
            if i + 4 > len(data):
                raise ValueError("fixed32 field overruns buffer")
            v = int.from_bytes(data[i : i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field_no, []).append(v)
    return out


def _uints(fields: dict, n: int) -> list[int]:
    """Repeated uint64/int64: accept packed (bytes) and unpacked."""
    out: list[int] = []
    for v in fields.get(n, []):
        if isinstance(v, bytes):
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(x)
        else:
            out.append(v)
    return out


def _strings(fields: dict, n: int) -> list[str]:
    return [v.decode() for v in fields.get(n, []) if isinstance(v, bytes)]


def _first(fields: dict, n: int, default=None):
    vs = fields.get(n)
    return vs[0] if vs else default


def _write_bytes(out: bytearray, field_no: int, b: bytes) -> None:
    _write_tag(out, field_no, 2)
    _write_varint(out, len(b))
    out += b


def _write_str(out: bytearray, field_no: int, s: str) -> None:
    _write_bytes(out, field_no, s.encode())


def _write_packed_uints(out: bytearray, field_no: int, vals) -> None:
    if not vals:
        return
    buf = bytearray()
    for v in vals:
        _write_varint(buf, int(v))
    _write_bytes(out, field_no, bytes(buf))


def _write_uint(out: bytearray, field_no: int, v: int) -> None:
    _write_tag(out, field_no, 0)
    _write_varint(out, v)


# -- Attr / attrs maps -------------------------------------------------------


def encode_attr(key: str, value: Any) -> bytes:
    out = bytearray()
    _write_str(out, 1, key)
    if isinstance(value, bool):
        _write_uint(out, 2, ATTR_BOOL)
        if value:
            _write_uint(out, 5, 1)
    elif isinstance(value, int):
        _write_uint(out, 2, ATTR_INT)
        if value:
            _write_uint(out, 4, value)
    elif isinstance(value, float):
        _write_uint(out, 2, ATTR_FLOAT)
        if value:
            _write_tag(out, 6, 1)
            out += struct.pack("<d", value)
    else:
        _write_uint(out, 2, ATTR_STRING)
        if value:
            _write_str(out, 3, str(value))
    return bytes(out)


def decode_attr(data: bytes) -> tuple[str, Any]:
    f = _decode_multi(data)
    key = (_first(f, 1, b"") or b"").decode()
    typ = _first(f, 2, ATTR_STRING)
    if typ == ATTR_BOOL:
        return key, bool(_first(f, 5, 0))
    if typ == ATTR_INT:
        return key, _signed64(int(_first(f, 4, 0)))
    if typ == ATTR_FLOAT:
        raw = _first(f, 6, 0)
        return key, struct.unpack("<d", int(raw).to_bytes(8, "little"))[0]
    return key, (_first(f, 3, b"") or b"").decode()


def _write_attrs(out: bytearray, field_no: int, attrs: dict) -> None:
    for k in sorted(attrs):
        _write_bytes(out, field_no, encode_attr(k, attrs[k]))


def _read_attrs(fields: dict, n: int) -> dict:
    return dict(decode_attr(b) for b in fields.get(n, []))


# -- Row / Pair / ValCount ---------------------------------------------------


def encode_row(columns, attrs: dict, keys=None) -> bytes:
    out = bytearray()
    _write_packed_uints(out, 1, columns or [])
    _write_attrs(out, 2, attrs or {})
    for k in keys or []:
        _write_str(out, 3, k)
    return bytes(out)


def decode_row(data: bytes) -> dict:
    f = _decode_multi(data)
    out = {"columns": _uints(f, 1), "attrs": _read_attrs(f, 2)}
    keys = _strings(f, 3)
    if keys:
        out["keys"] = keys
    return out


def encode_pair(p: dict) -> bytes:
    out = bytearray()
    if p.get("id"):
        _write_uint(out, 1, int(p["id"]))
    if p.get("count"):
        _write_uint(out, 2, int(p["count"]))
    if p.get("key"):
        _write_str(out, 3, p["key"])
    return bytes(out)


def decode_pair(data: bytes) -> dict:
    f = _decode_multi(data)
    key = _first(f, 3)
    if isinstance(key, bytes):  # translated pair: key replaces id
        return {"key": key.decode(), "count": int(_first(f, 2, 0))}
    return {"id": int(_first(f, 1, 0)), "count": int(_first(f, 2, 0))}


def encode_val_count(val: int, count: int) -> bytes:
    out = bytearray()
    if val:
        _write_uint(out, 1, val)
    if count:
        _write_uint(out, 2, count)
    return bytes(out)


def decode_val_count(data: bytes) -> dict:
    f = _decode_multi(data)
    return {
        "value": _signed64(int(_first(f, 1, 0))),
        "count": _signed64(int(_first(f, 2, 0))),
    }


# -- QueryRequest / QueryResponse -------------------------------------------


def encode_query_request(
    query: str,
    shards=None,
    column_attrs: bool = False,
    remote: bool = False,
    exclude_row_attrs: bool = False,
    exclude_columns: bool = False,
) -> bytes:
    out = bytearray()
    _write_str(out, 1, query)
    _write_packed_uints(out, 2, shards or [])
    if column_attrs:
        _write_uint(out, 3, 1)
    if remote:
        _write_uint(out, 5, 1)
    if exclude_row_attrs:
        _write_uint(out, 6, 1)
    if exclude_columns:
        _write_uint(out, 7, 1)
    return bytes(out)


def decode_query_request(data: bytes) -> dict:
    f = _decode_multi(data)
    return {
        "query": (_first(f, 1, b"") or b"").decode(),
        "shards": _uints(f, 2) or None,
        "columnAttrs": bool(_first(f, 3, 0)),
        "remote": bool(_first(f, 5, 0)),
        "excludeRowAttrs": bool(_first(f, 6, 0)),
        "excludeColumns": bool(_first(f, 7, 0)),
    }


def _encode_query_result(r: Any) -> bytes:
    """One executor result → QueryResult bytes (typed like
    http/handler.go:1125-1148)."""
    out = bytearray()
    if r is None:
        _write_uint(out, 6, RESULT_NIL)
    elif isinstance(r, bool):
        _write_uint(out, 6, RESULT_BOOL)
        if r:
            _write_uint(out, 4, 1)
    elif isinstance(r, int):
        _write_uint(out, 6, RESULT_UINT64)
        if r:
            _write_uint(out, 2, r)
    elif isinstance(r, dict) and ("value" in r or "count" in r) and "id" not in r:
        _write_uint(out, 6, RESULT_VALCOUNT)
        _write_bytes(
            out, 5, encode_val_count(int(r.get("value", 0)), int(r.get("count", 0)))
        )
    elif isinstance(r, dict):  # row shape from encode_result
        _write_uint(out, 6, RESULT_ROW)
        _write_bytes(
            out,
            1,
            encode_row(r.get("columns"), r.get("attrs", {}), r.get("keys")),
        )
    elif isinstance(r, list):  # pairs
        _write_uint(out, 6, RESULT_PAIRS)
        for p in r:
            _write_bytes(out, 3, encode_pair(p))
    else:
        raise ValueError(f"cannot encode query result: {type(r)}")
    return bytes(out)


def _decode_query_result(data: bytes) -> Any:
    f = _decode_multi(data)
    typ = _first(f, 6, RESULT_NIL)
    if typ == RESULT_ROW:
        return decode_row(_first(f, 1, b""))
    if typ == RESULT_PAIRS:
        return [decode_pair(b) for b in f.get(3, [])]
    if typ == RESULT_VALCOUNT:
        return decode_val_count(_first(f, 5, b""))
    if typ == RESULT_UINT64:
        return int(_first(f, 2, 0))
    if typ == RESULT_BOOL:
        return bool(_first(f, 4, 0))
    return None


def encode_query_response(
    results: list, column_attr_sets: Optional[list] = None, err: str = ""
) -> bytes:
    out = bytearray()
    if err:
        _write_str(out, 1, err)
    for r in results:
        _write_bytes(out, 2, _encode_query_result(r))
    for cas in column_attr_sets or []:
        buf = bytearray()
        if cas.get("id"):
            _write_uint(buf, 1, int(cas["id"]))
        _write_attrs(buf, 2, cas.get("attrs", {}))
        if cas.get("key"):
            _write_str(buf, 3, cas["key"])
        _write_bytes(out, 3, bytes(buf))
    return bytes(out)


def decode_query_response(data: bytes) -> dict:
    f = _decode_multi(data)
    out: dict = {"results": [_decode_query_result(b) for b in f.get(2, [])]}
    err = _first(f, 1)
    if isinstance(err, bytes) and err:
        out["error"] = err.decode()
    cols = []
    for b in f.get(3, []):
        cf = _decode_multi(b)
        entry = {"id": int(_first(cf, 1, 0)), "attrs": _read_attrs(cf, 2)}
        key = _first(cf, 3)
        if isinstance(key, bytes):
            entry["key"] = key.decode()
        cols.append(entry)
    if cols:
        out["columnAttrs"] = cols
    return out


# -- ImportRequest / ImportValueRequest -------------------------------------


def encode_import_request(
    index: str,
    field: str,
    shard: int,
    row_ids,
    column_ids,
    timestamps=None,
    row_keys=None,
    column_keys=None,
) -> bytes:
    out = bytearray()
    _write_str(out, 1, index)
    _write_str(out, 2, field)
    if shard:
        _write_uint(out, 3, shard)
    _write_packed_uints(out, 4, row_ids or [])
    _write_packed_uints(out, 5, column_ids or [])
    _write_packed_uints(out, 6, timestamps or [])
    for k in row_keys or []:
        _write_str(out, 7, k)
    for k in column_keys or []:
        _write_str(out, 8, k)
    return bytes(out)


def decode_import_request(data: bytes) -> dict:
    f = _decode_multi(data)
    return {
        "index": (_first(f, 1, b"") or b"").decode(),
        "field": (_first(f, 2, b"") or b"").decode(),
        "shard": int(_first(f, 3, 0)),
        "rowIDs": _uints(f, 4),
        "columnIDs": _uints(f, 5),
        "timestamps": [_signed64(t) for t in _uints(f, 6)],
        "rowKeys": _strings(f, 7),
        "columnKeys": _strings(f, 8),
    }


def encode_import_value_request(
    index: str, field: str, shard: int, column_ids, values, column_keys=None
) -> bytes:
    out = bytearray()
    _write_str(out, 1, index)
    _write_str(out, 2, field)
    if shard:
        _write_uint(out, 3, shard)
    _write_packed_uints(out, 5, column_ids or [])
    _write_packed_uints(out, 6, values or [])
    for k in column_keys or []:
        _write_str(out, 7, k)
    return bytes(out)


def decode_import_value_request(data: bytes) -> dict:
    f = _decode_multi(data)
    return {
        "index": (_first(f, 1, b"") or b"").decode(),
        "field": (_first(f, 2, b"") or b"").decode(),
        "shard": int(_first(f, 3, 0)),
        "columnIDs": _uints(f, 5),
        "values": [_signed64(v) for v in _uints(f, 6)],
        "columnKeys": _strings(f, 7),
    }
