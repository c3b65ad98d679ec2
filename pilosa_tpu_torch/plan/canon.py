"""PQL AST canonicalization — one stable identity per query subtree.

The executor's result cache, the planner's common-subexpression
elimination, and the serving pipeline's singleflight all need the same
primitive: two call trees that must produce identical results should
map to the same key. Raw query text is a bad key — PQL's commutative
operators admit arbitrarily many spellings of one computation
(``Intersect(Row(a), Row(b))`` vs ``Intersect(Row(b), Row(a))``,
``Union(a, Union(b, c))`` vs ``Union(a, b, c)``, permuted option
order). Canonicalization rewrites to a normal form:

* **flatten** nested ``Union``/``Intersect`` into their parent (both
  are associative);
* **sort** the operands of commutative ops (``Union``, ``Intersect``,
  ``Xor``) by their canonical serialization;
* **normalize** argument order (sorted keys) and literal spelling
  (type-tagged encoding, so ``1`` and ``1.0`` and ``"1"`` stay
  distinct).

``Difference`` is NOT commutative and is left untouched beyond child
recursion; operands are never deduplicated (``Xor(a, a)`` is empty, not
``a``). The canonical serialization is hashed (sha256) into a compact
content key; the ``__cached`` placeholder nodes the planner substitutes
hash as the subtree they replaced, so a rewritten tree keeps the
original tree's identity.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from threading import Lock
from typing import Optional

from pilosa_tpu_torch.pql.ast import Call, Condition, Query

# associative ops whose same-name children splice into the parent
FLATTEN = ("Union", "Intersect")
# commutative ops whose operand order is irrelevant to the result
COMMUTATIVE = ("Union", "Intersect", "Xor")

# the planner's substitution placeholder (plan/planner.py): carries the
# canonical hash of the subtree it replaced in args["_h"], so rewritten
# trees serialize — and therefore hash — exactly as the original
CACHED_CALL = "__cached"


def _enc_value(v) -> str:
    """Type-tagged literal encoding: distinct types never collide
    (True vs 1, 1 vs 1.0 vs "1"), and strings are length-prefixed so a
    crafted string can't forge another encoding's shape."""
    if v is None:
        return "n"
    if isinstance(v, bool):
        return "b1" if v else "b0"
    if isinstance(v, int):
        return f"i{v}"
    if isinstance(v, float):
        return f"f{v!r}"
    if isinstance(v, str):
        return f"s{len(v)}:{v}"
    if isinstance(v, list):
        return "l[" + ",".join(_enc_value(x) for x in v) + "]"
    if isinstance(v, Condition):
        return f"c({v.op}){_enc_value(v.value)}"
    return f"o{v!r}"


def _canon_children(c: Call) -> list[Call]:
    """Children with nested same-op Union/Intersect spliced in."""
    if c.name not in FLATTEN:
        return c.children
    out: list[Call] = []
    for ch in c.children:
        if ch.name == c.name and ch.children and not ch.args:
            out.extend(_canon_children(ch))
        else:
            out.append(ch)
    return out


def canonicalize(c: Call) -> Call:
    """A NEW canonical Call tree (input untouched): nested
    Union/Intersect flattened, commutative operands sorted. Useful for
    inspection/debugging; keys should use call_hash, which canonicalizes
    implicitly."""
    kids = [canonicalize(ch) for ch in _canon_children(c)]
    if c.name in COMMUTATIVE:
        kids.sort(key=call_hash)
    return Call(c.name, dict(c.args), kids)


def call_hash(c: Call) -> str:
    """Stable content hash of one call subtree, invariant under
    operand order (commutative ops), Union/Intersect nesting, and
    argument order.

    Hashing is bottom-up — a node hashes over its children's HASHES,
    not their serializations — so a planner-substituted ``__cached``
    placeholder (which carries the replaced subtree's hash) is exactly
    transparent: the rewritten parent keeps the original tree's
    identity."""
    if c.name == CACHED_CALL:
        return str(c.args["_h"])
    kid_hashes = [call_hash(k) for k in _canon_children(c)]
    if c.name in COMMUTATIVE:
        kid_hashes.sort()
    args = ";".join(f"{k}={_enc_value(c.args[k])}" for k in sorted(c.args))
    s = f"{c.name}({args}|{','.join(kid_hashes)})"
    return hashlib.sha256(s.encode()).hexdigest()[:24]


def query_hash(q: Query) -> str:
    """Whole-query hash: per-call hashes joined IN ORDER (results are
    positional, so call order is part of the identity)."""
    return hashlib.sha256(
        "|".join(call_hash(c) for c in q.calls).encode()
    ).hexdigest()[:24]


# -- serving-pipeline signature ---------------------------------------------

# text -> signature memo: dashboards repeat byte-identical query texts,
# so the hot path usually skips the re-parse. Bounded LRU under a lock
# (the handler calls this from many transport threads).
_SIG_MAX = 1024
_sig_lru: "OrderedDict[str, Optional[str]]" = OrderedDict()
_sig_mu = Lock()


def query_signature(text: str) -> Optional[str]:
    """Canonical signature for a query TEXT, or None when it doesn't
    parse (the caller falls back to the raw text so a syntax error
    still reaches the executor and 400s there). Used by the serving
    pipeline's singleflight so argument-order-permuted duplicates
    coalesce."""
    with _sig_mu:
        if text in _sig_lru:
            _sig_lru.move_to_end(text)
            return _sig_lru[text]
    from pilosa_tpu_torch.pql import parse

    try:
        sig: Optional[str] = "pqh:" + query_hash(parse(text))
    except Exception:
        sig = None
    with _sig_mu:
        _sig_lru[text] = sig
        _sig_lru.move_to_end(text)
        while len(_sig_lru) > _SIG_MAX:
            _sig_lru.popitem(last=False)
    return sig
