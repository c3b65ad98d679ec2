"""Keyed query surface: keys→ids resolution over parsed PQL calls and
ids→keys translation of results (reference translateCall /
translateResult, executor.go:1595-1696).

``resolve_call`` runs BEFORE canonicalization (plan/planner.py calls it
ahead of the CSE rewrite), so plan-cache keys, CSE hashes, and gang
dispatch signatures see resolved integer ids only — two spellings of
the same keyed subtree share one cache entry, and a key renamed to a
different id can never serve a stale cached row.

Covered call shapes: ``Set``/``Clear``/``Row`` column + row args,
``Rows(field, ids=[...])`` dimension lists (GroupBy dims), the generic
``col``/``row`` args of the remaining calls, and every nested child
(TopN filters, GroupBy filter subtrees, analytics children) via
recursion. Writes mint ids; reads look up only — an unknown read key
resolves to id 0, which is never minted (ids start at 1) and so
matches nothing.

``translate_result`` covers bitmap ``Row`` results (``keys``),
TopN-style ``{"id", "count"}`` pair lists (→ ``{"key", "count"}``) and
GroupBy group dimensions (``rowKey`` beside ``rowID`` for keyed dim
fields).
"""

from __future__ import annotations

from pilosa_tpu_torch.pql.ast import Call, WRITE_CALLS
from pilosa_tpu_torch.utils.errors import NotFoundError


def _field_or_raise(idx, field_name: str):
    fld = idx.field(field_name)
    if fld is None:
        raise NotFoundError(f"field not found: {field_name}")
    return fld


def resolve_call(ts, index: str, idx, c: Call) -> None:
    """Resolve string keys to ids in-place across one call tree."""
    if c.name in ("Set", "Clear", "Row"):
        col_key = "_col"
        try:
            field_name = c.field_arg()
        except ValueError:
            field_name = ""
        row_key = field_name
    else:
        col_key = "col"
        field_name = c.args.get("field") or c.args.get("_field") or ""
        row_key = "row"
    # Writes mint ids; reads look up only (create=False) — minting on
    # reads would durably pollute the cluster's translate logs with
    # typo'd keys and make read availability depend on the key's owner
    # being up. An unknown key on a read resolves to id 0, which is
    # never minted (ids start at 1) and so matches nothing.
    create = c.name in WRITE_CALLS
    if idx.keys:
        v = c.args.get(col_key)
        if v is not None and not isinstance(v, str):
            raise ValueError(
                "column value must be a string when index 'keys' option enabled"
            )
        if isinstance(v, str) and v:
            tid = ts.translate_columns_to_ids(index, [v], create=create)[0]
            c.args[col_key] = tid if tid is not None else 0
    else:
        if isinstance(c.args.get(col_key), str):
            raise ValueError(
                "string 'col' value not allowed unless index 'keys' option enabled"
            )
    if field_name:
        fld = _field_or_raise(idx, field_name)
        if fld.options.keys:
            v = c.args.get(row_key)
            if v is not None and not isinstance(v, str):
                raise ValueError(
                    "row value must be a string when field 'keys' option enabled"
                )
            if isinstance(v, str) and v:
                tid = ts.translate_rows_to_ids(
                    index, field_name, [v], create=create
                )[0]
                c.args[row_key] = tid if tid is not None else 0
            if c.name in ("Rows", "TopN"):
                ids = c.args.get("ids")
                if isinstance(ids, list) and any(
                    isinstance(r, str) for r in ids
                ):
                    # keyed row lists (GroupBy dims, TopN exact-count
                    # rows): resolve each key; unknown keys → 0 (an
                    # empty row)
                    resolved = ts.translate_rows_to_ids(
                        index,
                        field_name,
                        [str(r) for r in ids],
                        create=False,
                    )
                    c.args["ids"] = [
                        int(t) if t is not None else 0 for t in resolved
                    ]
        else:
            if isinstance(c.args.get(row_key), str):
                raise ValueError(
                    "string 'row' value not allowed unless field 'keys' "
                    "option enabled"
                )
            if c.name in ("Rows", "TopN"):
                ids = c.args.get("ids")
                if isinstance(ids, list) and any(
                    isinstance(r, str) for r in ids
                ):
                    raise ValueError(
                        "string 'ids' values not allowed unless field 'keys' "
                        "option enabled"
                    )
    for child in c.children:
        resolve_call(ts, index, idx, child)


def _keyed_field(idx, name: str) -> bool:
    if not name:
        return False
    fld = idx.field(name)
    return fld is not None and fld.options.keys


def translate_result(ts, index: str, idx, call: Call, result):
    """Translate ids back to keys on one result, returning the
    (possibly new) result object."""
    from pilosa_tpu_torch.core.row import Row

    if isinstance(result, Row):
        if idx.keys:
            result.keys = [
                ts.translate_column_to_string(index, int(col))
                for col in result.columns()
            ]
        return result
    if (
        isinstance(result, list)
        and result
        and isinstance(result[0], dict)
        and "id" in result[0]
    ):
        field_name = call.args.get("_field") or ""
        if _keyed_field(idx, field_name):
            return [
                {
                    "key": ts.translate_row_to_string(index, field_name, p["id"]),
                    "count": p["count"],
                }
                for p in result
            ]
        return result
    if (
        call.name == "GroupBy"
        and isinstance(result, list)
        and result
        and isinstance(result[0], dict)
        and "group" in result[0]
    ):
        keyed = {
            g["field"]
            for entry in result
            for g in entry.get("group", [])
            if _keyed_field(idx, g.get("field"))
        }
        if not keyed:
            return result
        out = []
        for entry in result:
            e = dict(entry)
            e["group"] = [
                (
                    {
                        **g,
                        "rowKey": ts.translate_row_to_string(
                            index, g["field"], g["rowID"]
                        ),
                    }
                    if g.get("field") in keyed
                    else g
                )
                for g in entry.get("group", [])
            ]
            out.append(e)
        return out
    return result
