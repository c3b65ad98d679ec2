"""Holder — root container of indexes (reference holder.go).

The server keeps its key-translation logs in ``<data-dir>/translate``
(server/server.py). The holder does not open that directory as an index,
and refuses an index of that name in a data directory; the JAX package's
holder lists it as an empty index (ROADMAP C3).
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Optional

from pilosa_tpu_torch.core.index import Index, _validate_name

# the server's key-translation directory under the data directory
TRANSLATE_DIR = "translate"


class Holder:
    def __init__(self, path: Optional[str] = None, broadcaster=None, new_attr_store=None) -> None:
        self.path = path
        self.broadcaster = broadcaster
        self.new_attr_store = new_attr_store
        self.indexes: dict[str, Index] = {}
        self.mu = threading.RLock()
        self.opened = False

    # -- lifecycle (reference Open:93-149) --

    def open(self) -> None:
        with self.mu:
            if self.path:
                os.makedirs(self.path, exist_ok=True)
                for name in sorted(os.listdir(self.path)):
                    ipath = os.path.join(self.path, name)
                    if not os.path.isdir(ipath) or name.startswith(".") or name == TRANSLATE_DIR:
                        continue
                    idx = self._new_index(name)
                    idx.open()
                    self.indexes[name] = idx
            self.opened = True

    def close(self) -> None:
        with self.mu:
            for idx in self.indexes.values():
                idx.close()
            self.opened = False

    def has_data(self) -> bool:
        return bool(self.indexes)

    # -- node id persistence (reference loadNodeID:518) --

    def load_node_id(self) -> str:
        if not self.path:
            return uuid.uuid4().hex[:16]
        os.makedirs(self.path, exist_ok=True)
        id_path = os.path.join(self.path, ".id")
        try:
            with open(id_path) as f:
                node_id = f.read().strip()
                if node_id:
                    return node_id
        except FileNotFoundError:
            pass
        node_id = uuid.uuid4().hex[:16]
        with open(id_path, "w") as f:
            f.write(node_id)
        return node_id

    # -- indexes --

    def _new_index(self, name: str) -> Index:
        column_attrs = None
        if self.new_attr_store is not None:
            p = os.path.join(self.path, name, ".data") if self.path else None
            column_attrs = self.new_attr_store(p)
        return Index(
            os.path.join(self.path, name) if self.path else None,
            name,
            column_attr_store=column_attrs,
            broadcaster=self.broadcaster,
            new_attr_store=self.new_attr_store,
        )

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, keys: bool = False) -> Index:
        with self.mu:
            if name in self.indexes:
                raise ValueError(f"index already exists: {name}")
            return self._create_index(name, keys)

    def create_index_if_not_exists(self, name: str, keys: bool = False) -> Index:
        with self.mu:
            idx = self.indexes.get(name)
            if idx is not None:
                return idx
            return self._create_index(name, keys)

    def _create_index(self, name: str, keys: bool) -> Index:
        _validate_name(name)
        if self.path and name == TRANSLATE_DIR:
            raise ValueError(f"invalid index name: {name!r} holds the key-translation logs")
        idx = self._new_index(name)
        idx.keys = keys
        idx.open()
        idx.save_meta()
        self.indexes[name] = idx
        return idx

    def delete_index(self, name: str) -> None:
        with self.mu:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise ValueError(f"index not found: {name}")
            idx.close()
            if idx.path and os.path.isdir(idx.path):
                shutil.rmtree(idx.path)

    # -- convenience lookups (reference holder.go fragment accessors) --

    def field(self, index: str, field: str):
        idx = self.index(index)
        return idx.field(field) if idx else None

    def view(self, index: str, field: str, view: str):
        f = self.field(index, field)
        return f.view(view) if f else None

    def fragment(self, index: str, field: str, view: str, shard: int):
        v = self.view(index, field, view)
        return v.fragment(shard) if v else None

    # -- schema sync (reference Schema:213 / applySchema:233) --

    def schema(self) -> list[dict]:
        out = []
        for iname in sorted(self.indexes):
            idx = self.indexes[iname]
            fields = []
            for fname in sorted(idx.fields):
                f = idx.fields[fname]
                fields.append(
                    {
                        "name": fname,
                        "options": f.options.to_dict(),
                        "views": sorted(f.views),
                    }
                )
            out.append({"name": iname, "keys": idx.keys, "fields": fields})
        return out

    def apply_schema(self, schema: list[dict]) -> None:
        """Merge a remote schema (create anything missing)."""
        from pilosa_tpu_torch.core.field import FieldOptions

        with self.mu:
            for ischema in schema:
                if self.path and ischema["name"] == TRANSLATE_DIR:
                    continue  # the JAX package's phantom index (ROADMAP C3)
                idx = self.create_index_if_not_exists(
                    ischema["name"], ischema.get("keys", False)
                )
                for fschema in ischema.get("fields", []):
                    field = idx.create_field_if_not_exists(
                        fschema["name"],
                        FieldOptions.from_dict(fschema.get("options", {})),
                    )
                    for vname in fschema.get("views", []):
                        field.create_view_if_not_exists(vname)
