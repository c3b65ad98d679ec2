"""Device-resident analytics: GroupBy / Distinct / Percentile plans.

A copy of ``pilosa_tpu/executor/analytics.py`` with the port's own
imports. This module owns everything the three analytic calls share
between the executor's shard-batched device paths and the CPU-oracle
per-shard legs: plan parsing/validation, dimension row-id resolution
under the ``analytics-max-groups`` bound, the wire result shape, and the
cross-shard merge functions. Keeping the host-side assembly here — used
verbatim by the batched and classic paths — is the bit-identity
argument.

Wire shape (what remote legs serialize and the HTTP layer returns):

  GroupBy    -> [{"group": [{"field": f, "rowID": r}, ...],
                  "count": n[, "sum": s]}, ...]
  Distinct   -> sorted list of field values (ints)
  Percentile -> ValCount (value = nearest-rank percentile, count = the
                number of non-null values the rank walked over)

GroupBy ordering: groups emit in cross-product order of the dimensions
(first ``Rows()`` slowest), explicit ``ids=[...]`` in the given order,
discovered row ids ascending — identical whether the counts came from
one fused K-vector or a per-shard merge, because the final ordering is
ranked from the PLAN (explicit lists) plus numeric row id, never from
per-leg arrival order. Zero-count groups are excluded; ``limit`` is
applied only at the coordinator (never on remote legs).
"""

from __future__ import annotations

import itertools
from typing import Optional

from pilosa_tpu_torch.core import Row, VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD
from pilosa_tpu_torch.utils.errors import NotFoundError

# call names the analytic paths own: the executor's dispatch and the
# fusion eligibility gate read them
ANALYTIC_CALLS = ("GroupBy", "Distinct", "Percentile")

# Distinct's on-device id extraction scatters into a 2^depth presence
# bitmap; beyond this depth the domain no longer pays for itself in HBM
# and the per-shard CPU walk wins
DISTINCT_DEVICE_MAX_DEPTH = 24

DEFAULT_MAX_GROUPS = 10000


class GroupByPlan:
    """Parsed GroupBy: dimension specs, optional filter subtree,
    optional Sum aggregate field, optional limit."""

    __slots__ = ("dims", "filter", "agg_field", "limit")

    def __init__(self, dims, filter, agg_field, limit) -> None:
        self.dims = dims  # [(field, explicit_ids_or_None), ...]
        self.filter = filter  # bitmap Call or None
        self.agg_field = agg_field  # Sum aggregate field or None
        self.limit = limit


def parse_groupby(c) -> GroupByPlan:
    """Children: ``Rows(field[, ids=[...]])`` per dimension, at most one
    bare ``Sum(field=x)`` aggregate, at most one other bitmap filter."""
    dims = []
    filt = None
    agg_field = None
    for child in c.children:
        if child.name == "Rows":
            field, ok = child.string_arg("_field")
            if not ok or not field:
                raise ValueError("GroupBy(): Rows() requires a field")
            ids, has_ids = child.uint_slice_arg("ids")
            dims.append((field, list(ids) if has_ids else None))
        elif child.name == "Sum" and not child.children:
            if agg_field is not None:
                raise ValueError("GroupBy(): only one aggregate is supported")
            af, ok = child.string_arg("field")
            if not ok or not af:
                raise ValueError("GroupBy(): Sum aggregate requires field=")
            agg_field = af
        else:
            if filt is not None:
                raise ValueError("GroupBy(): only one filter input is supported")
            filt = child
    if not dims:
        raise ValueError("GroupBy() requires at least one Rows() dimension")
    limit, has_limit = c.uint_arg("limit")
    return GroupByPlan(dims, filt, agg_field, limit if has_limit else None)


def parse_percentile(c) -> tuple[str, int]:
    """(field, nth in basis points). ``nth`` accepts ints or floats with
    at most two decimal places in [0, 100] — the device kernel walks the
    rank in exact basis-point integer arithmetic, so the grammar refuses
    anything the i32 math cannot represent losslessly."""
    field, ok = c.string_arg("field")
    if not ok or not field:
        raise ValueError("Percentile(): field required")
    if "nth" not in c.args:
        raise ValueError("Percentile(): nth required")
    nth = c.args["nth"]
    if isinstance(nth, bool) or not isinstance(nth, (int, float)):
        raise ValueError(f"Percentile(): nth must be a number, got {nth!r}")
    nth_bp = int(round(float(nth) * 100))
    if abs(float(nth) * 100 - nth_bp) > 1e-9:
        raise ValueError("Percentile(): nth supports at most 2 decimal places")
    if not 0 <= nth_bp <= 10000:
        raise ValueError("Percentile(): nth must be in [0, 100]")
    if len(c.children) > 1:
        raise ValueError("Percentile() only accepts a single bitmap input")
    return field, nth_bp


def nearest_rank(nth_bp: int, count: int) -> int:
    """k = ceil(nth_bp * count / 10000) clamped to [1, max(count, 1)] —
    the same overflow-free split the device kernel computes in i32."""
    q, r = divmod(count, 10000)
    k = nth_bp * q + (nth_bp * r + 9999) // 10000
    return min(max(k, 1), max(count, 1))


def resolve_dims(holder, index: str, plan: GroupByPlan, shards, max_groups: int):
    """Materialize each dimension's row-id list: explicit ``ids`` as
    given with repeats dropped (the first occurrence keeps its rank),
    otherwise the ascending union of row ids present in the queried
    shards' fragments. Raises when the cross-product of distinct groups
    exceeds ``max_groups`` — an unbounded panel must fail loudly before
    staging K row stacks into HBM."""
    resolved = []
    k = 1
    for field, ids in plan.dims:
        if holder.field(index, field) is None:
            raise NotFoundError(f"field not found: {field}")
        if ids is None:
            seen: set[int] = set()
            for s in shards:
                frag = holder.fragment(index, field, VIEW_STANDARD, s)
                if frag is not None:
                    seen.update(frag.row_ids())
            ids = sorted(seen)
        ids = list(dict.fromkeys(ids))
        resolved.append((field, ids))
        k *= len(ids)
    if k > max_groups:
        raise ValueError(
            f"GroupBy(): {k} groups exceeds analytics-max-groups={max_groups}"
        )
    return resolved


def group_key(entry: dict) -> tuple:
    return tuple(int(g["rowID"]) for g in entry["group"])


def merge_group_lists(a: list, b: list) -> list:
    """Cross-shard / cross-node reduce: merge two wire lists by group
    key, summing counts (and sums). Entries are copied — mapped values
    can be cached remote decodes that must never be mutated."""
    merged: dict[tuple, dict] = {}
    for src in (a, b):
        for e in src:
            key = group_key(e)
            cur = merged.get(key)
            if cur is None:
                merged[key] = dict(e)
            else:
                cur["count"] = int(cur["count"]) + int(e["count"])
                if "sum" in e:
                    cur["sum"] = int(cur.get("sum", 0)) + int(e["sum"])
    return [merged[key] for key in sorted(merged)]


def finalize_groups(plan: GroupByPlan, merged: list) -> list:
    """Coordinator-side ordering + limit. Ranks come from the PLAN:
    explicit ids rank by their first position in the given list, discovered
    dimensions rank by row id — so the order is identical whether the
    counts arrived as one device K-vector or a per-shard merge."""
    ranks = []
    for _, ids in plan.dims:
        if ids is not None:
            pos = {rid: i for i, rid in enumerate(dict.fromkeys(ids))}
            ranks.append(lambda r, pos=pos: pos.get(r, len(pos)))
        else:
            ranks.append(lambda r: r)
    entries = [e for e in merged if int(e["count"]) > 0]
    entries.sort(
        key=lambda e: tuple(rk(r) for rk, r in zip(ranks, group_key(e)))
    )
    if plan.limit is not None and plan.limit > 0:
        entries = entries[: plan.limit]
    return entries


def emit_device_groups(dims, counts, sums=None) -> list:
    """K-vector → wire list: ``counts`` is i32[K] in cross-product order
    (first dimension slowest), ``sums`` the matching per-group totals
    when a Sum aggregate ran. Zero-count groups are dropped here so the
    device path emits exactly what the per-shard merge would."""
    fields = [f for f, _ in dims]
    out = []
    for idx, key in enumerate(itertools.product(*[ids for _, ids in dims])):
        cnt = int(counts[idx])
        if cnt == 0:
            continue
        entry = {
            "group": [
                {"field": f, "rowID": int(r)} for f, r in zip(fields, key)
            ],
            "count": cnt,
        }
        if sums is not None:
            entry["sum"] = int(sums[idx])
        out.append(entry)
    return out


def assemble_sums(plane_counts, depth: int, bsig_min: int) -> list:
    """Per-group BSI totals from intersection plane counts i32[K, depth+1]
    (plane ``depth`` is the not-null count): host bigint assembly, the
    same ``Σ counts[i] << i  +  n·min`` the per-call Sum path computes."""
    out = []
    for k in range(plane_counts.shape[0]):
        s = sum(int(plane_counts[k, i]) << i for i in range(depth))
        n = int(plane_counts[k, depth])
        out.append(s + n * bsig_min)
    return out


# -- CPU-oracle per-shard legs ------------------------------------------------


def groupby_shard(ex, index: str, plan: GroupByPlan, dims, shard: int) -> list:
    """One shard's groups as a wire list — the classic leg and the
    property-test oracle. Pure roaring walk: per-dimension rows are
    materialized once, the cross-product prunes on empty intersections
    (a dashboard panel's combination matrix is mostly empty)."""
    filt_row: Optional[Row] = None
    if plan.filter is not None:
        filt_row = ex._bitmap_call_shard(index, plan.filter, shard)
        if filt_row.count() == 0:
            return []
    dim_rows = []
    for field, ids in dims:
        frag = ex.holder.fragment(index, field, VIEW_STANDARD, shard)
        rows = []
        for rid in ids:
            rows.append((rid, frag.row(rid) if frag is not None else Row()))
        dim_rows.append(rows)
    agg = None
    if plan.agg_field is not None:
        f = ex.holder.field(index, plan.agg_field)
        bsig = f.bsi_group(plan.agg_field) if f is not None else None
        afrag = ex.holder.fragment(
            index, plan.agg_field, VIEW_BSI_GROUP_PREFIX + plan.agg_field, shard
        )
        agg = (afrag, bsig)
    fields = [f for f, _ in dims]
    out: list[dict] = []

    def descend(d: int, key: tuple, acc: Optional[Row]) -> None:
        if d == len(dim_rows):
            count = acc.count() if acc is not None else 0
            if count == 0:
                return
            entry = {
                "group": [
                    {"field": f, "rowID": int(r)} for f, r in zip(fields, key)
                ],
                "count": count,
            }
            if agg is not None:
                afrag, bsig = agg
                if afrag is None or bsig is None:
                    entry["sum"] = 0
                else:
                    s, n = afrag.sum(acc, bsig.bit_depth())
                    entry["sum"] = s + n * bsig.min
            out.append(entry)
            return
        for rid, row in dim_rows[d]:
            nxt = row if acc is None else acc.intersect(row)
            if nxt.count() == 0 and d + 1 < len(dim_rows):
                continue  # empty stays empty through further ANDs
            descend(d + 1, key + (rid,), nxt)

    descend(0, (), filt_row)
    return out


def distinct_shard(ex, index: str, c, field: str, shard: int) -> list:
    """One shard's distinct field values (sorted ints) — classic leg and
    oracle: walk the not-null (∩ filter) columns and read each BSI value."""
    f = ex.holder.field(index, field)
    bsig = f.bsi_group(field) if f is not None else None
    if bsig is None:
        raise NotFoundError(f"bsiGroup not found: {field}")
    frag = ex.holder.fragment(index, field, VIEW_BSI_GROUP_PREFIX + field, shard)
    if frag is None:
        return []
    depth = bsig.bit_depth()
    base = frag.not_null(depth)
    filt = ex._bsi_filter(index, c, shard)
    if filt is not None:
        base = base.intersect(filt)
    vals: set[int] = set()
    for col in base.columns().tolist():
        v, ok = frag.value(int(col), depth)
        if ok:
            vals.add(v + bsig.min)
    return sorted(vals)


def merge_distinct_lists(a: list, b: list) -> list:
    return sorted(set(a) | set(b))


def decode_presence_words(words, base: int) -> list[int]:
    """Packed u32 presence bitmap → ascending value list (bit position
    is the stored value, ``base`` = bsig.min). Shared by the batched
    and fused Distinct finishers."""
    vals: list[int] = []
    for wi, w in enumerate(words.tolist()):
        w = int(w)
        while w:
            low = w & -w
            vals.append(base + wi * 32 + low.bit_length() - 1)
            w ^= low
    return vals


def heat_fields(c) -> list[str]:
    """Fields an analytic call reads — heat-ledger attribution for the
    fused launch sites, which bypass ``_map_reduce``'s per-shard loop."""
    if c.name == "GroupBy":
        try:
            plan = parse_groupby(c)
        except ValueError:
            return []
        fields = [f for f, _ in plan.dims]
        if plan.agg_field:
            fields.append(plan.agg_field)
        return fields
    fname, ok = c.string_arg("field")
    return [fname] if ok and fname else []
