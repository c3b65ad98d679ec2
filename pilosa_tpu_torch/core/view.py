"""View — container of fragments by shard (reference view.go).

View names: ``standard``, time-quantum subviews ``standard_2017…``, and
``bsig_<field>`` for bit-sliced integer groups (reference view.go:30-35).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from pilosa_tpu_torch import SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core import cache as cache_mod

VIEW_STANDARD = "standard"
VIEW_BSI_GROUP_PREFIX = "bsig_"


def view_path(index_path: str, field: str, view: str) -> str:
    return os.path.join(index_path, field, "views", view)


class View:
    def __init__(
        self,
        path: Optional[str],
        index: str,
        field: str,
        name: str,
        cache_type: str = cache_mod.CACHE_TYPE_RANKED,
        cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
        row_attr_store=None,
        broadcaster: Optional[Callable[[str, int], None]] = None,
    ) -> None:
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        # called with (index, shard) when a new max shard appears
        # (reference view.go:216-247 CreateShardMessage broadcast)
        self.broadcaster = broadcaster
        self.fragments: dict[int, Fragment] = {}
        self.mu = threading.RLock()

    # -- lifecycle --

    def open(self) -> None:
        """Register on-disk fragments WITHOUT opening them: a holder
        tree with thousands of fragments opens in O(touched) — each
        fragment mmaps and parses on first access (reference keeps
        startup cheap the same way via zero-copy mmap open,
        fragment.go:167-224; we go one step lazier)."""
        if not self.path:
            return
        frag_dir = os.path.join(self.path, "fragments")
        os.makedirs(frag_dir, exist_ok=True)
        for name in sorted(os.listdir(frag_dir)):
            if name.endswith(".cache") or name.endswith(".snapshotting"):
                continue
            try:
                shard = int(name)
            except ValueError:
                continue
            self.fragments[shard] = self._new_fragment(shard)

    def close(self) -> None:
        for f in self.fragments.values():
            f.close()  # no-op for never-opened fragments

    def _fragment_path(self, shard: int) -> Optional[str]:
        if not self.path:
            return None
        return os.path.join(self.path, "fragments", str(shard))

    def _new_fragment(self, shard: int) -> Fragment:
        return Fragment(
            self._fragment_path(shard),
            self.index,
            self.field,
            self.name,
            shard,
            cache_type=self.cache_type,
            cache_size=self.cache_size,
            row_attr_store=self.row_attr_store,
        )

    def fragment(self, shard: int) -> Optional[Fragment]:
        frag = self.fragments.get(shard)
        return frag.ensure_open() if frag is not None else None

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        with self.mu:
            frag = self.fragments.get(shard)
            if frag is None:
                if self.path:
                    os.makedirs(os.path.join(self.path, "fragments"), exist_ok=True)
                prev_max = max(self.fragments) if self.fragments else -1
                frag = self._new_fragment(shard)
                frag.open()
                self.fragments[shard] = frag
                if shard > prev_max and self.broadcaster:
                    self.broadcaster(self.index, shard)
        # open() discovery registers fragments UNOPENED (lazy startup);
        # mutating one before its first open would hit the empty
        # placeholder Bitmap — with no op-log attached — and the first
        # ensure_open() would then replace storage with the mmapped
        # file, silently discarding (acked!) writes. Open outside the
        # view lock: fragment opens are slow (mmap + recovery scan) and
        # ensure_open is a flag check once open.
        return frag.ensure_open()

    def available_shards(self) -> list[int]:
        return sorted(self.fragments)

    # -- routed ops (reference view.go:289-330) --

    def row(self, row_id: int) -> Row:
        out = Row()
        for shard in sorted(self.fragments):
            out.merge(self.fragments[shard].ensure_open().row(row_id))
        return out

    def set_bit(self, row_id: int, column_id: int) -> bool:
        shard = column_id // SHARD_WIDTH
        return self.create_fragment_if_not_exists(shard).set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragment(column_id // SHARD_WIDTH)
        if frag is None:
            return False
        return frag.clear_bit(row_id, column_id)

    def value(self, column_id: int, bit_depth: int) -> tuple[int, bool]:
        frag = self.fragment(column_id // SHARD_WIDTH)
        if frag is None:
            return 0, False
        return frag.value(column_id, bit_depth)

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        shard = column_id // SHARD_WIDTH
        return self.create_fragment_if_not_exists(shard).set_value(
            column_id, bit_depth, value
        )
