"""Wire codec for the reference's private (control-plane) protobuf messages.

The reference broadcasts cluster messages as a 1-byte type envelope over
a protobuf body (reference broadcast.go:52-158, internal/private.proto).
This module maps the rebuild's internal message dicts onto that format
so the control plane travels as protobuf, not JSON: the envelope type
numbering (0-14) and every field number follow the reference.

Two conscious extensions, both invisible to a reference decoder
(proto3 skips unknown fields):

* ``ClusterStatus`` piggybacks the holder schema (field 15) and
  per-index max shards (field 16) — the reference carries those in the
  separate gossip push/pull ``NodeStatus`` payload; the rebuild's
  status broadcast merges them so a single message heals drift.
* ``Node`` carries the node state string in field 4 and
  ``internal.Index`` the index keys flag in field 5, which the
  reference tracks out-of-band.

Rebuild-specific messages with no reference envelope number use the
high type bytes 128+ (``node-status``, ``holder-clean``, ``schema``).

Everything rides the same hand-rolled varint codec as protometa /
publicproto — two dozen flat structs don't warrant a protobuf runtime.
"""

from __future__ import annotations

from typing import Callable

from pilosa_tpu_torch.utils.protometa import _signed64, _write_tag, _write_varint
from pilosa_tpu_torch.utils.publicproto import (
    _decode_multi,
    _first,
    _write_bytes,
    _write_str,
)

CONTENT_TYPE = "application/x-protobuf"

# Envelope type bytes (reference broadcast.go:52-68).
MSG_CREATE_SHARD = 0
MSG_CREATE_INDEX = 1
MSG_DELETE_INDEX = 2
MSG_CREATE_FIELD = 3
MSG_DELETE_FIELD = 4
MSG_CREATE_VIEW = 5
MSG_DELETE_VIEW = 6
MSG_CLUSTER_STATUS = 7
MSG_RESIZE_INSTRUCTION = 8
MSG_RESIZE_COMPLETE = 9
MSG_SET_COORDINATOR = 10
MSG_UPDATE_COORDINATOR = 11
MSG_NODE_STATE = 12
MSG_RECALCULATE_CACHES = 13
MSG_NODE_EVENT = 14
# Rebuild-only envelope numbers (no reference equivalent).
MSG_NODE_STATUS = 128
MSG_HOLDER_CLEAN = 129
MSG_SCHEMA = 130

# reference memberlist event kinds (gossip/gossip.go NodeEventMessage)
NODE_EVENT_JOIN = 0
NODE_EVENT_LEAVE = 1


def _write_uint(out: bytearray, field_no: int, v: int) -> None:
    if v:
        _write_tag(out, field_no, 0)
        _write_varint(out, v)


def _write_bool(out: bytearray, field_no: int, v: bool) -> None:
    if v:
        _write_tag(out, field_no, 0)
        _write_varint(out, 1)


def _str(fields: dict, n: int, default: str = "") -> str:
    v = _first(fields, n)
    return v.decode() if isinstance(v, (bytes, bytearray)) else default


def _submsgs(fields: dict, n: int) -> list[dict]:
    return [_decode_multi(v) for v in fields.get(n, []) if isinstance(v, (bytes, bytearray))]


# -- FieldOptions / IndexMeta (private.proto:5-17) ---------------------------


def _enc_field_options(opts: dict) -> bytes:
    out = bytearray()
    if opts.get("cacheType"):
        _write_str(out, 3, opts["cacheType"])
    _write_uint(out, 4, int(opts.get("cacheSize", 0)))
    if opts.get("timeQuantum"):
        _write_str(out, 5, opts["timeQuantum"])
    if opts.get("type"):
        _write_str(out, 8, opts["type"])
    _write_uint(out, 9, int(opts.get("min", 0)))
    _write_uint(out, 10, int(opts.get("max", 0)))
    _write_bool(out, 11, bool(opts.get("keys")))
    return bytes(out)


def _dec_field_options(data: bytes) -> dict:
    f = _decode_multi(data)
    return {
        "type": _str(f, 8) or "set",
        "cacheType": _str(f, 3) or "ranked",
        "cacheSize": int(_first(f, 4, 0)) or 50000,
        "timeQuantum": _str(f, 5),
        "min": _signed64(int(_first(f, 9, 0))),
        "max": _signed64(int(_first(f, 10, 0))),
        "keys": bool(_first(f, 11, 0)),
    }


# -- Schema / Index / Field (private.proto:68-80) ----------------------------


def _enc_schema(schema: list[dict]) -> bytes:
    out = bytearray()
    for idx in schema or []:
        ib = bytearray()
        _write_str(ib, 1, idx["name"])
        for fld in idx.get("fields", []):
            fb = bytearray()
            _write_str(fb, 1, fld["name"])
            _write_bytes(fb, 2, _enc_field_options(fld.get("options", {})))
            for v in fld.get("views", []):
                _write_str(fb, 3, v)
            _write_bytes(ib, 4, bytes(fb))
        _write_bool(ib, 5, bool(idx.get("keys")))  # extension field
        _write_bytes(out, 1, bytes(ib))
    return bytes(out)


def _dec_schema(data: bytes) -> list[dict]:
    out = []
    for ib in _submsgs(_decode_multi(data), 1):
        fields = []
        for fb in ib.get(4, []):
            f = _decode_multi(fb)
            meta = _first(f, 2)
            fields.append(
                {
                    "name": _str(f, 1),
                    "options": _dec_field_options(meta) if meta else {},
                    "views": [v.decode() for v in f.get(3, [])],
                }
            )
        out.append(
            {
                "name": _str(ib, 1),
                "keys": bool(_first(ib, 5, 0)),
                "fields": fields,
            }
        )
    return out


# -- URI / Node (private.proto:82-93) ----------------------------------------


def _enc_uri_str(addr: str) -> bytes:
    """``http://host:port`` string → internal.URI bytes.

    Lenient by design: node addresses already in the topology must
    encode even when they wouldn't pass URI.from_address validation
    (e.g. docker-compose hosts with underscores) — a broadcast must
    never crash on an address the cluster is already using."""
    scheme, host, port = "http", "localhost", 10101
    rest = addr or ""
    if "://" in rest:
        scheme, rest = rest.split("://", 1)
    if rest.startswith("["):  # bracketed IPv6, optional :port
        body, _, p = rest.partition("]")
        if p.startswith(":") and p[1:].isdigit():
            port = int(p[1:])
        rest = body + "]"
    elif rest.count(":") == 1:  # host:port
        h, _, p = rest.partition(":")
        if p.isdigit():
            port = int(p)
            rest = h
    # else: zero colons (plain host) or 2+ colons (bare IPv6 literal,
    # digits-only final group included — never split a port off it)
    if rest:
        host = rest
    out = bytearray()
    _write_str(out, 1, scheme)
    _write_str(out, 2, host)
    _write_uint(out, 3, port)
    return bytes(out)


def _dec_uri_str(data: bytes) -> str:
    f = _decode_multi(data)
    scheme = _str(f, 1) or "http"
    host = _str(f, 2) or "localhost"
    port = int(_first(f, 3, 0)) or 10101
    if ":" in host and not host.startswith("["):
        # bracket bare IPv6 hosts so the rendered address re-encodes to
        # the same (host, port) on every relay hop — an unbracketed
        # 'scheme://::1:10101' would re-parse as a 3-colon host
        host = f"[{host}]"
    return f"{scheme}://{host}:{port}"


def _enc_node(node: dict) -> bytes:
    out = bytearray()
    if node.get("id"):
        _write_str(out, 1, node["id"])
    if node.get("uri"):
        _write_bytes(out, 2, _enc_uri_str(node["uri"]))
    _write_bool(out, 3, bool(node.get("isCoordinator")))
    if node.get("state"):
        _write_str(out, 4, node["state"])  # extension field
    return bytes(out)


def _dec_node(data: bytes) -> dict:
    f = _decode_multi(data)
    uri = _first(f, 2)
    return {
        "id": _str(f, 1),
        "uri": _dec_uri_str(uri) if uri else "",
        "isCoordinator": bool(_first(f, 3, 0)),
        "state": _str(f, 4) or "READY",
    }


# -- MaxShards map (private.proto:40-42) -------------------------------------


def _enc_max_shards(m: dict) -> bytes:
    """map<string,uint64> Standard = 1 — proto maps are repeated
    (key=1, value=2) submessages."""
    out = bytearray()
    for k in sorted(m or {}):
        kb = bytearray()
        _write_str(kb, 1, k)
        _write_uint(kb, 2, int(m[k]))
        _write_bytes(out, 1, bytes(kb))
    return bytes(out)


def _dec_max_shards(data: bytes) -> dict:
    out = {}
    for e in _submsgs(_decode_multi(data), 1):
        out[_str(e, 1)] = int(_first(e, 2, 0))
    return out


# -- per-message bodies ------------------------------------------------------


def _enc_create_shard(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg["index"])
    _write_uint(out, 2, int(msg["shard"]))
    return bytes(out)


def _dec_create_shard(data: bytes) -> dict:
    f = _decode_multi(data)
    return {"type": "create-shard", "index": _str(f, 1), "shard": int(_first(f, 2, 0))}


def _enc_create_index(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg["index"])
    meta = bytearray()
    _write_bool(meta, 3, bool(msg.get("keys")))
    _write_bytes(out, 2, bytes(meta))
    return bytes(out)


def _dec_create_index(data: bytes) -> dict:
    f = _decode_multi(data)
    meta = _first(f, 2) or b""
    return {
        "type": "create-index",
        "index": _str(f, 1),
        "keys": bool(_first(_decode_multi(meta), 3, 0)),
    }


def _enc_index_only(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg["index"])
    return bytes(out)


def _dec_delete_index(data: bytes) -> dict:
    return {"type": "delete-index", "index": _str(_decode_multi(data), 1)}


def _enc_create_field(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg["index"])
    _write_str(out, 2, msg["field"])
    _write_bytes(out, 3, _enc_field_options(msg.get("options", {})))
    return bytes(out)


def _dec_create_field(data: bytes) -> dict:
    f = _decode_multi(data)
    meta = _first(f, 3)
    return {
        "type": "create-field",
        "index": _str(f, 1),
        "field": _str(f, 2),
        "options": _dec_field_options(meta) if meta else {},
    }


def _enc_index_field(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg["index"])
    _write_str(out, 2, msg["field"])
    return bytes(out)


def _dec_delete_field(data: bytes) -> dict:
    f = _decode_multi(data)
    return {"type": "delete-field", "index": _str(f, 1), "field": _str(f, 2)}


def _enc_view_msg(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg["index"])
    _write_str(out, 2, msg["field"])
    _write_str(out, 3, msg["view"])
    return bytes(out)


def _dec_view_msg(typ: str) -> Callable[[bytes], dict]:
    def dec(data: bytes) -> dict:
        f = _decode_multi(data)
        return {
            "type": typ,
            "index": _str(f, 1),
            "field": _str(f, 2),
            "view": _str(f, 3),
        }

    return dec


def _enc_cluster_status(msg: dict) -> bytes:
    out = bytearray()
    if msg.get("clusterID"):
        _write_str(out, 1, msg["clusterID"])
    _write_str(out, 2, msg.get("state", ""))
    for n in msg.get("nodes", []):
        _write_bytes(out, 3, _enc_node(n))
    # extension fields: schema + maxShards piggyback (see module doc)
    if msg.get("schema"):
        _write_bytes(out, 15, _enc_schema(msg["schema"]))
    if msg.get("maxShards"):
        _write_bytes(out, 16, _enc_max_shards(msg["maxShards"]))
    # cluster-wide placement parameters (extension; peers adopt them
    # only when the broadcast came from the coordinator)
    _write_uint(out, 17, int(msg.get("replicaN", 0)))
    _write_uint(out, 18, int(msg.get("partitionN", 0)))
    _write_bool(out, 19, bool(msg.get("fromCoordinator")))
    return bytes(out)


def _dec_cluster_status(data: bytes) -> dict:
    f = _decode_multi(data)
    schema = _first(f, 15)
    max_shards = _first(f, 16)
    out = {
        "type": "cluster-status",
        "state": _str(f, 2),
        "nodes": [_dec_node(b) for b in f.get(3, [])],
        "schema": _dec_schema(schema) if schema else [],
        "maxShards": _dec_max_shards(max_shards) if max_shards else {},
    }
    cid = _str(f, 1)
    if cid:
        out["clusterID"] = cid
    rep = int(_first(f, 17, 0))
    if rep:
        out["replicaN"] = rep
    part = int(_first(f, 18, 0))
    if part:
        out["partitionN"] = part
    if _first(f, 19, 0):
        out["fromCoordinator"] = True
    return out


def _enc_resize_instruction(msg: dict) -> bytes:
    out = bytearray()
    _write_uint(out, 1, int(msg.get("job", 0)))
    _write_bytes(out, 2, _enc_node(msg.get("node", {})))
    # rebuild addresses the coordinator by URI alone
    _write_bytes(out, 3, _enc_node({"uri": msg.get("coordinator", "")}))
    for src in msg.get("sources", []):
        sb = bytearray()
        uris = src.get("from_uris") or (
            [src["from_uri"]] if src.get("from_uri") else []
        )
        # reference slot carries the first candidate; the full fallback
        # list rides extension field 6 (repeated URI — unknown to a
        # reference decoder, which uses the single Node)
        _write_bytes(sb, 1, _enc_node({"uri": uris[0] if uris else ""}))
        _write_str(sb, 2, src["index"])
        _write_str(sb, 3, src["field"])
        _write_str(sb, 4, src["view"])
        _write_uint(sb, 5, int(src["shard"]))
        for u in uris:
            _write_bytes(sb, 6, _enc_uri_str(u))
        _write_bytes(out, 4, bytes(sb))
    _write_bytes(out, 5, _enc_schema(msg.get("schema", [])))
    # reference field 6 is a full ClusterStatus; the rebuild's
    # instruction carries the new node list, so encode it as one
    status = bytearray()
    for n in msg.get("new_nodes", []):
        _write_bytes(status, 3, _enc_node(n))
    _write_bytes(out, 6, bytes(status))
    return bytes(out)


def _dec_resize_instruction(data: bytes) -> dict:
    f = _decode_multi(data)
    sources = []
    for sb in f.get(4, []):
        s = _decode_multi(sb)
        node = _first(s, 1)
        uris = [_dec_uri_str(b) for b in s.get(6, [])]
        src = {
            "index": _str(s, 2),
            "field": _str(s, 3),
            "view": _str(s, 4),
            "shard": int(_first(s, 5, 0)),
            "from_uri": _dec_node(node)["uri"] if node else "",
        }
        if uris:
            src["from_uris"] = uris
        sources.append(src)
    node = _first(f, 2)
    coord = _first(f, 3)
    schema = _first(f, 5)
    status = _first(f, 6)
    new_nodes = (
        [_dec_node(b) for b in _decode_multi(status).get(3, [])] if status else []
    )
    return {
        "type": "resize-instruction",
        "job": int(_first(f, 1, 0)),
        "node": _dec_node(node) if node else {},
        "coordinator": _dec_node(coord)["uri"] if coord else "",
        "schema": _dec_schema(schema) if schema else [],
        "sources": sources,
        "new_nodes": new_nodes,
    }


def _enc_resize_complete(msg: dict) -> bytes:
    out = bytearray()
    _write_uint(out, 1, int(msg.get("job", 0)))
    _write_bytes(out, 2, _enc_node({"id": msg.get("node_id", "")}))
    if not msg.get("ok", True):
        _write_str(out, 3, msg.get("error") or "resize failed")
    return bytes(out)


def _dec_resize_complete(data: bytes) -> dict:
    f = _decode_multi(data)
    node = _first(f, 2)
    err = _str(f, 3)
    out = {
        "type": "resize-complete",
        "job": int(_first(f, 1, 0)),
        "node_id": _dec_node(node)["id"] if node else "",
        "ok": not err,
    }
    if err:
        out["error"] = err
    return out


def _enc_coordinator_msg(msg: dict) -> bytes:
    out = bytearray()
    _write_bytes(out, 1, _enc_node(msg.get("node", {})))
    return bytes(out)


def _dec_coordinator_msg(typ: str) -> Callable[[bytes], dict]:
    def dec(data: bytes) -> dict:
        node = _first(_decode_multi(data), 1)
        return {"type": typ, "node": _dec_node(node) if node else {}}

    return dec


def _enc_node_state(msg: dict) -> bytes:
    out = bytearray()
    _write_str(out, 1, msg.get("node_id", ""))
    _write_str(out, 2, msg.get("state", ""))
    return bytes(out)


def _dec_node_state(data: bytes) -> dict:
    f = _decode_multi(data)
    return {"type": "node-state", "node_id": _str(f, 1), "state": _str(f, 2)}


def _enc_empty(msg: dict) -> bytes:
    return b""


def _enc_node_event(msg: dict) -> bytes:
    out = bytearray()
    _write_uint(out, 1, int(msg.get("event", NODE_EVENT_JOIN)))
    _write_bytes(out, 2, _enc_node(msg.get("node", {})))
    return bytes(out)


def _dec_node_join(data: bytes) -> dict:
    f = _decode_multi(data)
    node = _first(f, 2)
    event = int(_first(f, 1, 0))
    return {
        "type": "node-join" if event == NODE_EVENT_JOIN else "node-leave",
        "node": _dec_node(node) if node else {},
    }


def _enc_node_status(msg: dict) -> bytes:
    out = bytearray()
    _write_bytes(out, 1, _enc_node({"id": msg.get("node_id", "")}))
    _write_bytes(out, 2, _enc_max_shards(msg.get("maxShards", {})))
    _write_bytes(out, 3, _enc_schema(msg.get("schema", [])))
    return bytes(out)


def _dec_node_status(data: bytes) -> dict:
    f = _decode_multi(data)
    node = _first(f, 1)
    max_shards = _first(f, 2)
    schema = _first(f, 3)
    return {
        "type": "node-status",
        "node_id": _dec_node(node)["id"] if node else "",
        "maxShards": _dec_max_shards(max_shards) if max_shards else {},
        "schema": _dec_schema(schema) if schema else [],
    }


def _enc_schema_msg(msg: dict) -> bytes:
    return _enc_schema(msg.get("schema", []))


def _dec_schema_msg(data: bytes) -> dict:
    return {"type": "schema", "schema": _dec_schema(data)}


def _dec_holder_clean(data: bytes) -> dict:
    return {"type": "holder-clean"}


def _dec_recalculate(data: bytes) -> dict:
    return {"type": "recalculate-caches"}


# internal message type string → (envelope byte, encoder)
_ENCODERS: dict[str, tuple[int, Callable[[dict], bytes]]] = {
    "create-shard": (MSG_CREATE_SHARD, _enc_create_shard),
    "create-index": (MSG_CREATE_INDEX, _enc_create_index),
    "delete-index": (MSG_DELETE_INDEX, _enc_index_only),
    "create-field": (MSG_CREATE_FIELD, _enc_create_field),
    "delete-field": (MSG_DELETE_FIELD, _enc_index_field),
    "create-view": (MSG_CREATE_VIEW, _enc_view_msg),
    "delete-view": (MSG_DELETE_VIEW, _enc_view_msg),
    "cluster-status": (MSG_CLUSTER_STATUS, _enc_cluster_status),
    "resize-instruction": (MSG_RESIZE_INSTRUCTION, _enc_resize_instruction),
    "resize-complete": (MSG_RESIZE_COMPLETE, _enc_resize_complete),
    "set-coordinator": (MSG_SET_COORDINATOR, _enc_coordinator_msg),
    "update-coordinator": (MSG_UPDATE_COORDINATOR, _enc_coordinator_msg),
    "node-state": (MSG_NODE_STATE, _enc_node_state),
    "recalculate-caches": (MSG_RECALCULATE_CACHES, _enc_empty),
    "node-join": (MSG_NODE_EVENT, _enc_node_event),
    "node-status": (MSG_NODE_STATUS, _enc_node_status),
    "holder-clean": (MSG_HOLDER_CLEAN, _enc_empty),
    "schema": (MSG_SCHEMA, _enc_schema_msg),
}

_DECODERS: dict[int, Callable[[bytes], dict]] = {
    MSG_CREATE_SHARD: _dec_create_shard,
    MSG_CREATE_INDEX: _dec_create_index,
    MSG_DELETE_INDEX: _dec_delete_index,
    MSG_CREATE_FIELD: _dec_create_field,
    MSG_DELETE_FIELD: _dec_delete_field,
    MSG_CREATE_VIEW: _dec_view_msg("create-view"),
    MSG_DELETE_VIEW: _dec_view_msg("delete-view"),
    MSG_CLUSTER_STATUS: _dec_cluster_status,
    MSG_RESIZE_INSTRUCTION: _dec_resize_instruction,
    MSG_RESIZE_COMPLETE: _dec_resize_complete,
    MSG_SET_COORDINATOR: _dec_coordinator_msg("set-coordinator"),
    MSG_UPDATE_COORDINATOR: _dec_coordinator_msg("update-coordinator"),
    MSG_NODE_STATE: _dec_node_state,
    MSG_RECALCULATE_CACHES: _dec_recalculate,
    MSG_NODE_EVENT: _dec_node_join,
    MSG_NODE_STATUS: _dec_node_status,
    MSG_HOLDER_CLEAN: _dec_holder_clean,
    MSG_SCHEMA: _dec_schema_msg,
}


def encodable(msg: dict) -> bool:
    return msg.get("type") in _ENCODERS


def marshal_message(msg: dict) -> bytes:
    """Internal message dict → 1-byte envelope + protobuf body
    (reference MarshalMessage, broadcast.go:71-113)."""
    typ = msg.get("type")
    enc = _ENCODERS.get(typ)
    if enc is None:
        raise KeyError(f"message type not implemented for marshalling: {typ!r}")
    n, fn = enc
    return bytes([n]) + fn(msg)


def unmarshal_message(buf: bytes) -> dict:
    """1-byte envelope + protobuf body → internal message dict
    (reference UnmarshalMessage, broadcast.go:116-158)."""
    if not buf:
        raise ValueError("empty cluster message")
    dec = _DECODERS.get(buf[0])
    if dec is None:
        raise ValueError(f"invalid message type: {buf[0]}")
    return dec(bytes(buf[1:]))
