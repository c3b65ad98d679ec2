"""Planner — cache keys, generation vectors, and common-subexpression
elimination for the executor.

The port of ``pilosa_tpu/plan/planner.py``.

Two jobs sit here, both keyed by canonical subtree hashes (plan/canon):

* **Whole-call cache keys.** ``call_cache_key`` decides whether a call's
  result may be cached at all (it must depend only on fragment state —
  attr-store reads have no generation counter, so anything touching
  them is uncacheable) and, when it may, derives the cache key plus a
  generation-vector thunk covering every fragment that could contribute.
  The vector enumerates EVERY view of each referenced field over the
  query's shard set: coarser than strictly necessary (a write to a
  field's BSI view invalidates a standard-view entry on the same
  field), but exact in the direction that matters — no write that can
  change the result is ever missed, including time-quantum fan-out and
  view creation.

* **CSE rewrite.** ``rewrite_for_cse`` walks the calls of one query
  (which, via the pipeline's cross-request combiner, may be a whole
  gang of coalesced HTTP requests): bitmap subtrees that are already
  cached — or that repeat within the query — are replaced by
  ``__cached`` placeholder nodes carrying the materialized per-shard
  rows. The executor evaluates a placeholder by reading those rows
  (CPU path) or packing them into device words (device path), so
  ``Count(Intersect(hot, cold))`` recomputes only the cold leg.
  Placeholders hash as the subtree they replaced (canon.CACHED_CALL),
  so a rewritten call keeps its original cache identity.

Local-only: substituted trees are never serialized, so the executor
gates all of this behind single-node / remote-leg execution — on a
cluster the coordinator's calls travel to shard owners as text and each
owner runs its own planner against its own fragments.
"""

from __future__ import annotations

from typing import Callable, Optional

from pilosa_tpu_torch.pql.ast import Call
from pilosa_tpu_torch.plan.canon import CACHED_CALL, call_hash

# bitmap-valued calls the CSE rewrite may substitute
BITMAP_CALLS = ("Row", "Union", "Intersect", "Difference", "Xor", "Range")
# compound calls whose cacheability is their children's
_COMPOUND = ("Union", "Intersect", "Difference", "Xor", "Count")


def subtree_fields(c: Call) -> Optional[frozenset]:
    """Field names this subtree reads, or None when the result can
    depend on state the generation vector cannot see (attr stores,
    write calls, unknown call names, malformed args — let the executor
    produce the error uncached)."""
    name = c.name
    if name == CACHED_CALL:
        return c.args.get("_fields")
    try:
        if name in _COMPOUND:
            fields: set = set()
            for ch in c.children:
                f = subtree_fields(ch)
                if f is None:
                    return None
                fields |= f
            return frozenset(fields)
        if name in ("Row", "Range"):
            if c.children:
                return None
            return frozenset([c.field_arg()])
        if name == "TopN":
            if c.args.get("attrName") or c.args.get("attrValues"):
                return None  # attr filters read stores with no generation
            field, ok = c.string_arg("_field")
            if not ok:
                return None
            fields = {field}
            for ch in c.children:
                f = subtree_fields(ch)
                if f is None:
                    return None
                fields |= f
            return frozenset(fields)
        if name in ("Sum", "Min", "Max"):
            field, ok = c.string_arg("field")
            if not ok:
                return None
            fields = {field}
            for ch in c.children:
                f = subtree_fields(ch)
                if f is None:
                    return None
                fields |= f
            return frozenset(fields)
        if name == "Rows":
            field, ok = c.string_arg("_field")
            if not ok:
                return None
            return frozenset([field])
        if name == "GroupBy":
            # dims (Rows), aggregate (bare Sum) and filter are all
            # children — their union covers every fragment read
            if not c.children:
                return None
            fields = set()
            for ch in c.children:
                f = subtree_fields(ch)
                if f is None:
                    return None
                fields |= f
            return frozenset(fields)
        if name in ("Distinct", "Percentile"):
            field, ok = c.string_arg("field")
            if not ok:
                return None
            fields = {field}
            for ch in c.children:
                f = subtree_fields(ch)
                if f is None:
                    return None
                fields |= f
            return frozenset(fields)
    except (ValueError, TypeError):
        return None
    return None  # writes / unknown calls


def extract_row_operands(calls) -> list[tuple[str, int]]:
    """(field, row_id) for every plain Row leaf under ``calls`` — the
    plan-driven prefetcher's staging list (executor/tiering.py). Only
    leaves the stager can promote as a standard-view row block qualify;
    malformed or range-style Rows are skipped, never raised."""
    out: list[tuple[str, int]] = []

    def walk(c: Call) -> None:
        if c.name == "Row" and not c.children:
            try:
                field = c.field_arg()
                row_id, ok = c.uint_arg(field)
            except (ValueError, TypeError):
                return
            if ok:
                out.append((field, int(row_id)))
            return
        if c.name == "Rows":
            # GroupBy dimension with explicit ids — each id is a
            # standard-view row block the stager can promote ahead of
            # the segmented-reduction launch. Discovered dims (no ids=)
            # are unknowable before execution; skip them.
            try:
                field, ok = c.string_arg("_field")
                ids, has_ids = c.uint_slice_arg("ids")
            except (ValueError, TypeError):
                return
            if ok and has_ids:
                out.extend((field, int(r)) for r in ids)
            return
        for ch in c.children:
            walk(ch)

    for c in calls:
        walk(c)
    return out


def generation_vector(holder, index: str, fields, shards) -> tuple:
    """((field, view, shard, generation), ...) for every EXISTING
    fragment of the referenced fields over the shard set. A write bumps
    its fragment's generation; a restore bumps it; a new fragment or
    view changes the vector's shape — all read as a mismatch by the
    cache. Sorted, so the vector is a pure function of state."""
    try:
        idx = holder.index(index)
        if idx is None:
            return ("noindex",)
        vec = []
        for fname in sorted(fields):
            fld = idx.field(fname)
            if fld is None:
                vec.append((fname, None))
                continue
            for vname in sorted(fld.views):
                view = fld.views.get(vname)
                if view is None:
                    continue  # deleted between the sort and the read
                frags = view.fragments
                for s in shards:
                    frag = frags.get(s)
                    if frag is not None:
                        vec.append((fname, vname, s, frag.generation))
        return tuple(vec)
    except (RuntimeError, KeyError):
        # a concurrent schema mutation raced the dict walk: answer with
        # a vector that can never match, so this lookup misses instead
        # of guessing
        return ("racing", id(object()))


def _opt_bits(opt, attrless: bool) -> tuple:
    """The ExecOptions bits that can change a call's raw result."""
    return (bool(opt.remote), attrless or bool(opt.exclude_row_attrs))


def call_cache_key(
    executor, index: str, c: Call, shards, opt
) -> Optional[tuple[tuple, Callable[[], tuple]]]:
    """(cache key, generation-vector thunk) for a whole top-level call,
    or None when the call is uncacheable."""
    fields = subtree_fields(c)
    if fields is None:
        return None
    if c.name == "Row" and not opt.exclude_row_attrs:
        # top-level Row() calls get row attrs attached
        # (executor._execute_bitmap_call); attr stores have no
        # generation counter, so such results must not be cached
        fld = executor.holder.field(index, next(iter(fields)))
        if fld is not None and fld.row_attr_store is not None:
            return None
    key = (index, call_hash(c), tuple(shards), _opt_bits(opt, attrless=False))
    holder = executor.holder
    return key, lambda: generation_vector(holder, index, fields, shards)


def subtree_cache_key(index: str, h: str, shards_t: tuple, opt) -> tuple:
    """Key for a SUBTREE row entry: always attr-less (nested bitmap
    nodes never attach attrs), so top-level bitmap calls that exclude
    attrs and nested occurrences of the same subtree share one entry.
    The index name is part of the key (as in call_cache_key): the
    PlanCache is process-wide and generation vectors carry no index
    identity, so same-schema indexes with matching generation counts
    would otherwise serve each other's results."""
    return (index, h, shards_t, _opt_bits(opt, attrless=True))


def rewrite_for_cse(executor, index: str, calls: list, shards, opt) -> list:
    """Substitute cached / repeated bitmap subtrees with ``__cached``
    placeholder nodes (intra-query + intra-gang CSE). Input calls are
    never mutated; untouched calls pass through identically."""
    pc = executor.plan_cache
    shards_t = tuple(shards)
    holder = executor.holder

    # (hash, fields) per node, memoized by object identity — the scan
    # and substitution passes each visit every node once
    memo: dict[int, Optional[tuple]] = {}

    def info(node: Call) -> Optional[tuple]:
        k = id(node)
        if k not in memo:
            fields = subtree_fields(node)
            memo[k] = None if fields is None else (call_hash(node), fields)
        return memo[k]

    # pass 1: occurrence counts of cacheable bitmap subtrees (all
    # depths; a subtree repeated inside two distinct parents still
    # shares). Top-level calls are the whole-call cache's job.
    counts: dict[str, int] = {}

    def scan(node: Call, top: bool) -> None:
        if not top and node.name in BITMAP_CALLS:
            i = info(node)
            if i is not None:
                counts[i[0]] = counts.get(i[0], 0) + 1
        for ch in node.children:
            scan(ch, False)

    for c in calls:
        scan(c, True)

    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.executor.executor import ExecOptions

    sub_opt = ExecOptions(
        remote=opt.remote,
        exclude_row_attrs=True,
        exclude_columns=opt.exclude_columns,
    )
    resolved: dict[str, tuple] = {}  # h -> (Row, frozen genvec)

    def resolve(node: Call, h: str, fields) -> Optional[tuple]:
        hit = resolved.get(h)
        if hit is not None:
            return hit
        key = subtree_cache_key(index, h, shards_t, opt)
        # Freeze the vector BEFORE resolving: the device plan cache
        # stamps the packed u32 stack of this Row with g0, and a stamp
        # taken after a concurrent write could certify stale content as
        # fresh. Frozen, a racing write can only over-invalidate.
        g0 = generation_vector(holder, index, fields, shards)
        gv = lambda: g0
        if counts.get(h, 0) >= 2:
            # repeated within this query/gang: build once, share
            row = pc.get_or_build(
                key,
                gv,
                lambda: executor._execute_bitmap_call(index, node, shards, sub_opt),
            )
        else:
            row = pc.get(key, gv)  # probe-only: feed hot legs back in
        if isinstance(row, Row):
            hit = (row, g0)
            resolved[h] = hit
            return hit
        return None

    def substitute(node: Call, top: bool) -> Call:
        if not top and node.name in BITMAP_CALLS:
            i = info(node)
            if i is not None:
                h, fields = i
                hit = resolve(node, h, fields)
                if hit is not None:
                    row, g0 = hit
                    return Call(
                        CACHED_CALL,
                        args={
                            "_h": h,
                            "_row": row,
                            "_fields": fields,
                            # for the device-resident plan cache:
                            # the frozen stamp and a fresh-vector thunk
                            # (canon.call_hash ignores extra args here)
                            "_genvec": g0,
                            "_gv": lambda: generation_vector(
                                holder, index, fields, shards
                            ),
                        },
                    )
        if node.children:
            new = [substitute(ch, False) for ch in node.children]
            if any(a is not b for a, b in zip(new, node.children)):
                return Call(node.name, node.args, new)
        return node

    out = []
    for c in calls:
        i = info(c)
        if i is not None and pc.contains(
            (index, i[0], shards_t, _opt_bits(opt, attrless=False))
        ):
            # the whole call is (probably) cached — the _execute_call
            # hook will serve it; descending here would waste probes
            out.append(c)
            continue
        out.append(substitute(c, True))
    return out


def resolve_keys(executor, index: str, idx, calls) -> None:
    """Keyed-surface entry point: resolve string keys to integer ids
    in-place across every call tree BEFORE canonicalization, so the
    CSE hashes and plan-cache keys above only ever see resolved ids —
    two spellings of the same keyed subtree share one cache entry, and
    re-keying an id can never serve a stale cached row. Delegates to
    the translate subsystem (translate/resolve.py)."""
    from pilosa_tpu_torch.translate import resolve

    ts = executor.translate_store
    if ts is None:
        return
    for c in calls:
        resolve.resolve_call(ts, index, idx, c)
