"""Index — container of fields + column attributes (reference index.go)."""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from pilosa_tpu_torch.core.field import Field, FieldOptions


class Index:
    def __init__(
        self,
        path: Optional[str],
        name: str,
        keys: bool = False,
        column_attr_store=None,
        broadcaster=None,
        new_attr_store=None,
    ) -> None:
        self.path = path
        self.name = name
        self.keys = keys
        self.column_attrs = column_attr_store
        self.broadcaster = broadcaster
        self.new_attr_store = new_attr_store  # factory: path -> attr store
        self.fields: dict[str, Field] = {}
        self.remote_max_shard = 0  # reference index.go:214-237
        self.mu = threading.RLock()

    # -- lifecycle --

    def open(self) -> None:
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            self._load_meta()
            for name in sorted(os.listdir(self.path)):
                fpath = os.path.join(self.path, name)
                if not os.path.isdir(fpath) or name.startswith("."):
                    continue
                f = self._new_field(name)
                f.open()
                self.fields[name] = f

    def close(self) -> None:
        for f in self.fields.values():
            f.close()

    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def save_meta(self) -> None:
        if not self.path:
            return
        with open(self._meta_path(), "w") as f:
            json.dump({"keys": self.keys}, f)

    def _load_meta(self) -> None:
        try:
            with open(self._meta_path(), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            self.save_meta()
            return
        try:
            self.keys = json.loads(raw).get("keys", False)
        except (ValueError, UnicodeDecodeError):
            # reference data dir: .meta is a protobuf IndexMeta
            from pilosa_tpu_torch.utils.protometa import decode_index_meta

            self.keys = decode_index_meta(raw)["keys"]

    # -- fields --

    def _field_attr_store(self, name: str):
        if self.new_attr_store is None:
            return None
        if self.path:
            return self.new_attr_store(os.path.join(self.path, name, ".data"))
        return self.new_attr_store(None)

    def _new_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        return Field(
            os.path.join(self.path, name) if self.path else None,
            self.name,
            name,
            options=options,
            row_attr_store=self._field_attr_store(name),
            broadcaster=self.broadcaster,
        )

    def field(self, name: str) -> Optional[Field]:
        return self.fields.get(name)

    def create_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self.mu:
            if name in self.fields:
                raise ValueError(f"field already exists: {name}")
            return self._create_field_if_not_exists(name, options)

    def create_field_if_not_exists(
        self, name: str, options: Optional[FieldOptions] = None
    ) -> Field:
        with self.mu:
            f = self.fields.get(name)
            if f is not None:
                return f
            return self._create_field_if_not_exists(name, options)

    def _create_field_if_not_exists(
        self, name: str, options: Optional[FieldOptions]
    ) -> Field:
        _validate_name(name)
        f = self._new_field(name, options)
        f.open()
        f.save_meta()
        self.fields[name] = f
        return f

    def delete_field(self, name: str) -> None:
        with self.mu:
            f = self.fields.pop(name, None)
            if f is None:
                raise ValueError(f"field not found: {name}")
            f.close()
            if f.path and os.path.isdir(f.path):
                import shutil

                shutil.rmtree(f.path)

    # -- shards --

    def max_shard(self) -> int:
        """Max shard across all fields, including gossip-propagated remote
        max (reference index.go:214-237)."""
        m = 0
        for f in self.fields.values():
            m = max(m, f.max_shard())
        return max(m, self.remote_max_shard)

    def set_remote_max_shard(self, n: int) -> None:
        self.remote_max_shard = max(self.remote_max_shard, n)

    def available_shards(self) -> list[int]:
        shards: set[int] = set()
        for f in self.fields.values():
            shards.update(f.available_shards())
        return sorted(shards)


def _validate_name(name: str) -> None:
    """reference validateName: lowercase alnum + dash/underscore, must
    start with a letter."""
    import re

    if not re.fullmatch(r"[a-z][a-z0-9_-]{0,63}", name):
        raise ValueError(f"invalid index or field name: {name!r}")
