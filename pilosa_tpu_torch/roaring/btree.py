"""B+tree container store — the analog of the reference's enterprise
container backend (enterprise/b/btree.go, containers_btree.go, swapped
in via the `enterprise` build tag at enterprise/enterprise.go:30-32).

The default store is a plain dict (reference SliceContainers,
roaring/containers.go:17-177): ideal for the common few-containers case
but every sorted iteration re-sorts the key set. For bitmaps with very
large container counts (billions of columns → millions of containers)
a B+tree gives ordered iteration and range scans without re-sorting,
and O(log n) point ops without the slice-shift cost of a sorted array.

``BTreeContainers`` implements the mapping protocol the Bitmap uses
(get/set/del/iterate/len/clear, key iteration in sorted order), so it
drops in via the module-level ``set_default_container_store`` switch in
``pilosa_tpu_torch.roaring.bitmap`` — the same seam the reference flips with
its build tag.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections.abc import KeysView
from typing import Iterator, Optional


class _BTreeKeysView(KeysView):
    """Lazy set-like key view; `&`/`|` results materialize as plain
    sets (sized to the result, not the tree)."""

    @classmethod
    def _from_iterable(cls, it):
        return set(it)

# Max keys per node. 2*t children. Small enough to keep list shifts
# cheap, large enough for shallow trees (64^3 ≈ 260k containers at
# depth 3).
_ORDER = 64

_MISSING = object()


class _Node:
    __slots__ = ("keys", "vals", "children", "next")

    def __init__(self, leaf: bool) -> None:
        self.keys: list[int] = []
        self.vals: Optional[list] = [] if leaf else None
        self.children: Optional[list["_Node"]] = None if leaf else []
        self.next: Optional["_Node"] = None  # leaf chain for ordered scans

    @property
    def leaf(self) -> bool:
        return self.vals is not None


class BTreeContainers:
    """B+tree keyed by container key (high 48 bits of the bit position),
    values are Container objects. Leaves are chained for in-order
    iteration."""

    def __init__(self) -> None:
        self._root = _Node(leaf=True)
        self._first = self._root
        self._len = 0

    # -- search --

    def _find_leaf(self, key: int) -> _Node:
        node = self._root
        while not node.leaf:
            i = bisect_right(node.keys, key)
            node = node.children[i]
        return node

    def get(self, key: int, default=None):
        leaf = self._find_leaf(key)
        i = bisect_left(leaf.keys, key)
        if i < len(leaf.keys) and leaf.keys[i] == key:
            return leaf.vals[i]
        return default

    def __getitem__(self, key: int):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __contains__(self, key: int) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    # -- insert --

    def __setitem__(self, key: int, value) -> None:
        root = self._root
        split = self._insert(root, key, value)
        if split is not None:
            sep, right = split
            new_root = _Node(leaf=False)
            new_root.keys = [sep]
            new_root.children = [root, right]
            self._root = new_root

    def _insert(self, node: _Node, key: int, value):
        """Insert into subtree; return (separator, new_right_node) if
        the node split, else None."""
        if node.leaf:
            i = bisect_left(node.keys, key)
            if i < len(node.keys) and node.keys[i] == key:
                node.vals[i] = value
                return None
            node.keys.insert(i, key)
            node.vals.insert(i, value)
            self._len += 1
            if len(node.keys) <= _ORDER:
                return None
            # Split leaf: right gets the upper half; separator is the
            # first key of the right leaf (B+tree convention).
            mid = len(node.keys) // 2
            right = _Node(leaf=True)
            right.keys = node.keys[mid:]
            right.vals = node.vals[mid:]
            del node.keys[mid:]
            del node.vals[mid:]
            right.next = node.next
            node.next = right
            return right.keys[0], right
        i = bisect_right(node.keys, key)
        split = self._insert(node.children[i], key, value)
        if split is None:
            return None
        sep, right = split
        node.keys.insert(i, sep)
        node.children.insert(i + 1, right)
        if len(node.keys) <= _ORDER:
            return None
        mid = len(node.keys) // 2
        sep_up = node.keys[mid]
        new_right = _Node(leaf=False)
        new_right.keys = node.keys[mid + 1 :]
        new_right.children = node.children[mid + 1 :]
        del node.keys[mid:]
        del node.children[mid + 1 :]
        return sep_up, new_right

    # -- delete --
    #
    # Lazy deletion: remove from the leaf without rebalancing. Bitmap
    # workloads delete containers rarely (only when a container empties)
    # and re-insert into the same key space; underfull leaves cost a
    # little depth, never correctness. The reference's enterprise tree
    # rebalances; this trade keeps the hot insert/lookup path simple.

    def __delitem__(self, key: int) -> None:
        leaf = self._find_leaf(key)
        i = bisect_left(leaf.keys, key)
        if i >= len(leaf.keys) or leaf.keys[i] != key:
            raise KeyError(key)
        del leaf.keys[i]
        del leaf.vals[i]
        self._len -= 1

    def pop(self, key: int, *default):
        try:
            v = self[key]
        except KeyError:
            if default:
                return default[0]
            raise
        del self[key]
        return v

    # -- iteration / misc --

    def __iter__(self) -> Iterator[int]:
        leaf = self._first
        while leaf is not None:
            yield from leaf.keys
            leaf = leaf.next

    def keys(self):
        return _BTreeKeysView(self)

    def values(self):
        leaf = self._first
        while leaf is not None:
            yield from leaf.vals
            leaf = leaf.next

    def items(self):
        leaf = self._first
        while leaf is not None:
            yield from zip(leaf.keys, leaf.vals)
            leaf = leaf.next

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def clear(self) -> None:
        self._root = _Node(leaf=True)
        self._first = self._root
        self._len = 0
