"""Programmatic API (L6) — validated surface over holder/executor
(reference api.go).

The port of ``pilosa_tpu/server/api.py``: queries, schema, imports,
export, fragment data, backup and restore, keyed indexes and fields, key
imports, column attributes, attribute diffs and the translate stores
(the executor's ``translate_store``). On a static cluster (``cluster``,
parallel/cluster.py) schema changes go to every node as messages,
imports and ingest waves route to their shards' owners, and ``status``
lists the nodes. Keys on a cluster (the translate plane, ROADMAP A8c)
and the multihost legs of the reference (A8d) are not ported.
``status`` adds a ``device`` block: the executor's device and its
health gate.
"""

from __future__ import annotations

import io
import json
import time
from typing import Optional

import numpy as np

from pilosa_tpu_torch import SHARD_WIDTH, __version__
from pilosa_tpu_torch.core import FieldOptions, Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.executor import ExecOptions
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.server import deadline, pipeline
from pilosa_tpu_torch.server.config import A8C
from pilosa_tpu_torch.utils import events, heat, metrics, profiler, trace

# the cluster state a single node reports (reference cluster.go:42-45);
# a static cluster is NORMAL from the moment its server serves
STATE_NORMAL = "NORMAL"


class APIError(Exception):
    def __init__(self, message: str, status: int = 400) -> None:
        super().__init__(message)
        self.status = status


from pilosa_tpu_torch.utils.errors import NotFoundError as _SharedNotFound  # noqa: E402


def unported(what: str, item: str) -> APIError:
    """The 501 a request for a subsystem this port lacks answers."""
    return APIError(
        f"{what} is not ported to pilosa_tpu_torch yet (ROADMAP {item})", status=501
    )


class NotFoundError(APIError, _SharedNotFound):
    """API-level 404. Subclasses BOTH APIError (carries the status for
    the HTTP layer) and the shared utils.errors.NotFoundError, so
    ``except`` on either type catches it — no same-named-type trap."""

    def __init__(self, message: str) -> None:
        APIError.__init__(self, message, status=404)


class API:
    def __init__(self, holder, executor, cluster=None, server=None) -> None:
        self.holder = holder
        self.executor = executor
        self.cluster = cluster
        self.server = server

    def _send_sync(self, msg: dict) -> None:
        """A schema change goes to every other node of a cluster."""
        if self.server is not None:
            self.server.send_sync(msg)

    def _refuse_keys(self, what: str) -> None:
        """Keys on a cluster need the translate plane: minting on each
        node would fork the cluster's id space."""
        if self.cluster is not None:
            raise unported(f"{what} on a cluster", A8C)

    # -- query (reference api.Query:96-150) --

    def query(
        self,
        index: str,
        query: str,
        shards: Optional[list[int]] = None,
        remote: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        column_attrs: bool = False,
        profile: bool = False,
        cache: bool = True,
        trace_ctx: Optional[tuple] = None,
        waterfall: bool = False,
    ) -> dict:
        # deadline boundary: cancel BEFORE the parse — an expired
        # request must cost the server nothing past this line
        dl = deadline.current()
        if dl is not None:
            dl.check(metrics.STAGE_QUERY)
        opt = ExecOptions(
            remote=remote,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns,
            # cache=false bypasses the plan result cache; profile=true
            # does too — a profiled query must show real execution, not
            # a cache hit's absence of spans. profile=waterfall likewise:
            # a cache hit has no device leg to attribute
            cache=cache and not profile and not waterfall,
        )
        # root span: forced by profile=true or a sampled upstream
        # traceparent (the ingress point ADOPTS the caller's trace id),
        # else admitted by the tracer's sample rate / slow-query
        # threshold (NOP when off — the untraced query allocates no
        # span anywhere below)
        root = trace.TRACER.trace(
            metrics.STAGE_QUERY, force=profile, ctx=trace_ctx, index=index
        )
        # always-on attribution: every served query carries a
        # waterfall accumulator — a plain dict in a contextvar, one get
        # + float add per instrumented leg, no spans, no sampling gate.
        # Created HERE (not the HTTP thread) because pipeline thunks run
        # on worker threads where the handler's contextvars don't reach.
        wf: dict = {}
        t_q0 = time.monotonic()
        # an UNSAMPLED upstream context still propagates its ids to
        # dispatch items and outbound RPC headers, span-free
        with root, trace.push_ctx(
            trace_ctx if root is trace.NOP_SPAN else None
        ), trace.attrib_activate(wf):
            # when this query came through the serving pipeline, its
            # admission-queue wait predates the root span — backfill it
            # so profile=true shows where serving latency went
            wait = pipeline.current_queue_wait()
            if wait > 0:
                wf[trace.WF_PIPELINE_QUEUE] = wait
                if root is not trace.NOP_SPAN:
                    root.record(
                        metrics.STAGE_PIPELINE_WAIT, root.t0 - wait, wait
                    )
            try:
                t0p = time.monotonic()
                q = parse(query)
                wf[trace.WF_PLAN_CANON] = time.monotonic() - t0p
            except Exception as e:
                raise APIError(f"parsing: {e}") from e
            idx = self.holder.index(index)
            if idx is None:
                raise NotFoundError(f"index not found: {index}")
            if self.cluster is not None and (idx.keys or any(f.options.keys for f in idx.fields.values())):
                self._refuse_keys("a keyed index or field")
            results = self.executor.execute(index, q, shards, opt)
        resp: dict = {"results": results}
        # total covers parse → results plus the pre-span pipeline wait;
        # the handler pops _waterfall into the aggregator + SLO monitor
        total_s = (time.monotonic() - t_q0) + wf.get(trace.WF_PIPELINE_QUEUE, 0.0)
        resp["_waterfall"] = profiler.WATERFALL.summarize(wf, total_s)
        if waterfall:
            resp["profile"] = {"waterfall": resp["_waterfall"]}
        if profile:
            resp["profile"] = trace.TRACER.stitched(root.to_dict())
        if remote and root is not trace.NOP_SPAN:
            # federation remote leg: return this process's serialized
            # span tree in the response envelope so the root process
            # grafts it into ONE stitched trace (Dapper-style)
            # stitched: a rank-0 replay span grafts into this leader's
            # buffer synchronously, so it rides back in the envelope too
            resp["spans"] = [trace.TRACER.stitched(root.to_dict())]
        if column_attrs and idx.column_attrs is not None:
            cols = set()
            for r in results:
                if isinstance(r, Row):
                    cols.update(int(c) for c in r.columns())
            attr_sets = []
            for col in sorted(cols):
                attrs = idx.column_attrs.attrs(col)
                if attrs:
                    attr_sets.append({"id": col, "attrs": attrs})
            resp["columnAttrs"] = attr_sets
        return resp

    # -- schema CRUD --

    def create_index(self, name: str, keys: bool = False) -> None:
        if keys:
            self._refuse_keys("a keyed index")
        try:
            self.holder.create_index(name, keys=keys)
        except ValueError as e:
            raise APIError(str(e), status=409 if "exists" in str(e) else 400)
        self._send_sync({"type": "create-index", "index": name, "keys": keys})

    def delete_index(self, name: str) -> None:
        try:
            self.holder.delete_index(name)
        except ValueError as e:
            raise NotFoundError(str(e))
        self._send_sync({"type": "delete-index", "index": name})

    def create_field(self, index: str, field: str, options: dict) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        fopts = FieldOptions.from_dict(options or {})
        if fopts.keys:
            self._refuse_keys("a keyed field")
        try:
            idx.create_field(field, fopts)
        except ValueError as e:
            raise APIError(str(e), status=409 if "exists" in str(e) else 400)
        self._send_sync(
            {"type": "create-field", "index": index, "field": field, "options": options or {}}
        )

    def delete_field(self, index: str, field: str) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            idx.delete_field(field)
        except ValueError as e:
            raise NotFoundError(str(e))
        self._send_sync({"type": "delete-field", "index": index, "field": field})

    def delete_view(self, index: str, field: str, view: str) -> None:
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        v = f.views.pop(view, None)
        if v is not None:
            v.close()
            if v.path:
                import shutil

                shutil.rmtree(v.path, ignore_errors=True)

    def schema(self) -> list[dict]:
        return self.holder.schema()

    def fragment_inventory(self) -> list[dict]:
        """Every (index, field, view, shard) this node holds — the
        resize coordinator unions these across old owners so fragment
        moves enumerate what EXISTS, not the whole shard space (the
        reference's availableShards bitmaps serve the same purpose,
        cluster.go:689-773)."""
        out = []
        for iname, idx in self.holder.indexes.items():
            for fname, fld in idx.fields.items():
                for vname, view in fld.views.items():
                    for shard in sorted(view.fragments):
                        out.append(
                            {
                                "index": iname,
                                "field": fname,
                                "view": vname,
                                "shard": shard,
                            }
                        )
        return out

    def views(self, index: str, field: str) -> list[str]:
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        return sorted(f.views)

    # -- imports (reference api.Import:652-696) --

    def import_bits(
        self,
        index: str,
        field: str,
        row_ids: list[int],
        column_ids: list[int],
        timestamps: Optional[list] = None,
        row_keys: Optional[list[str]] = None,
        column_keys: Optional[list[str]] = None,
    ) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        ts = self.executor.translate_store
        if column_keys or row_keys:
            self._refuse_keys("a keyed import")
        if column_keys:
            if ts is None:
                raise APIError("translate store not configured")
            column_ids = ts.translate_columns_to_ids(index, column_keys)
        if row_keys:
            if ts is None:
                raise APIError("translate store not configured")
            row_ids = ts.translate_rows_to_ids(index, field, row_keys)
        # route bit groups to their shard owners (the reference's client
        # groups by owner before posting, http/client.go:276,922; routing
        # here keeps single-endpoint imports correct in a cluster)
        if self._clustered():
            self._route_import(index, field, row_ids, column_ids, timestamps)
            return
        f.import_bits(row_ids, column_ids, _parse_timestamps(timestamps))

    def import_bits_local(self, index, field, row_ids, column_ids, timestamps=None):
        """Internal: import bits into this node only (the owner-side leg
        of a routed import; on one node the same as ``import_bits``)."""
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        f.import_bits(row_ids, column_ids, _parse_timestamps(timestamps))

    def _clustered(self) -> bool:
        return self.cluster is not None and len(self.cluster.nodes) > 1

    def _owner_groups(self, index: str, column_ids):
        """(shard, positions, owners) for each shard the columns touch, in
        shard order."""
        groups: dict[int, list[int]] = {}
        for i, col in enumerate(column_ids):
            groups.setdefault(int(col) // SHARD_WIDTH, []).append(i)
        for shard, idxs in sorted(groups.items()):
            yield shard, idxs, self.cluster.shard_nodes(index, shard)

    def _route_import(self, index, field, row_ids, column_ids, timestamps) -> None:
        for _, idxs, owners in self._owner_groups(index, column_ids):
            rows = [row_ids[i] for i in idxs]
            cols = [column_ids[i] for i in idxs]
            tss = [timestamps[i] for i in idxs] if timestamps else None
            for node in owners:
                if node.id == self.cluster.node_id:
                    self.import_bits_local(index, field, rows, cols, tss)
                else:
                    self.cluster.client.import_bits_local(node.uri, index, field, rows, cols, tss)

    # -- ingest write waves (server/ingest.py group commit) --

    def apply_write_wave(
        self, index: str, field: str, row_ids, column_ids, sets=None
    ) -> int:
        """Apply one coalesced ingest write wave: sets AND clears in a
        single batch, one op-log group commit + fsync and one
        generation bump per touched fragment. Returns the number of
        bits that changed. In a cluster, shard groups route to their
        owners first; a remote owner acks only after its own ingest
        queue group-commits, so durability is owner-side."""
        if not self._clustered():
            return self.apply_write_wave_local(index, field, row_ids, column_ids, sets)
        flags = sets if sets is not None else [True] * len(column_ids)
        total = 0
        for _, idxs, owners in self._owner_groups(index, column_ids):
            rows = [int(row_ids[i]) for i in idxs]
            cols = [int(column_ids[i]) for i in idxs]
            ss = [bool(flags[i]) for i in idxs]
            # every owner applies the group, but it counts ONCE toward the
            # wave's total (replicas must not inflate the changed count);
            # the local owner's exact count is preferred when there is one
            local_changed = None
            remote_changed = None
            for node in owners:
                if node.id == self.cluster.node_id:
                    local_changed = self.apply_write_wave_local(index, field, rows, cols, ss)
                else:
                    c = self.cluster.client.ingest(node.uri, index, field, rows, cols, ss)
                    remote_changed = max(remote_changed or 0, c)
            if local_changed is not None:
                total += local_changed
            elif remote_changed is not None:
                total += remote_changed
        return total

    def apply_write_wave_local(
        self, index: str, field: str, row_ids, column_ids, sets=None
    ) -> int:
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        flags = sets if sets is not None else [True] * len(row_ids)
        groups: dict[int, list[int]] = {}
        for i, col in enumerate(column_ids):
            groups.setdefault(int(col) // SHARD_WIDTH, []).append(i)
        v = f.create_view_if_not_exists(VIEW_STANDARD)
        changed = 0
        for shard, idxs in sorted(groups.items()):
            frag = v.create_fragment_if_not_exists(shard)
            changed += frag.apply_bit_batch(
                [int(row_ids[i]) for i in idxs],
                [int(column_ids[i]) for i in idxs],
                [bool(flags[i]) for i in idxs],
            )
            heat.record_write(index, field, shard, len(idxs))
        return changed

    def import_values(
        self,
        index: str,
        field: str,
        column_ids: list[int],
        values: list[int],
        column_keys: Optional[list[str]] = None,
    ) -> None:
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        ts = self.executor.translate_store
        if column_keys:
            self._refuse_keys("a keyed import")
            if ts is None:
                raise APIError("translate store not configured")
            column_ids = ts.translate_columns_to_ids(index, column_keys)
        if self._clustered():
            for _, idxs, owners in self._owner_groups(index, column_ids):
                cols = [column_ids[i] for i in idxs]
                vals = [values[i] for i in idxs]
                for node in owners:
                    if node.id == self.cluster.node_id:
                        self.import_values_local(index, field, cols, vals)
                    else:
                        self.cluster.client.import_values_local(node.uri, index, field, cols, vals)
            return
        f.import_values(column_ids, values)

    def import_values_local(self, index, field, column_ids, values):
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        f.import_values(column_ids, values)

    # -- export (reference api.ExportCSV:328) --

    def export_csv(self, index: str, field: str, shard: int) -> bytes:
        """CSV bytes for one shard, "row,col\\n" lines (the reference's
        Go csv writer likewise emits bare \\n, http/handler.go
        handleGetExport) — both paths byte-identical so cross-node
        export diffs can't depend on whether the native library built."""
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        frag = self.holder.fragment(index, field, VIEW_STANDARD, shard)
        if frag is None:
            return b""
        positions = np.asarray(frag.storage.slice_all(), dtype=np.uint64)
        if positions.size == 0:
            return b""
        rows = positions // np.uint64(SHARD_WIDTH)
        cols = np.uint64(frag.shard * SHARD_WIDTH) + (
            positions % np.uint64(SHARD_WIDTH)
        )
        # native formatter (inverse of the import parser); Python
        # fallback when the library isn't built
        from pilosa_tpu_torch import native_bridge

        out = native_bridge.format_csv_pairs(rows, cols)
        if out is not None:
            return out
        return (
            "".join(f"{r},{c}\n" for r, c in zip(rows.tolist(), cols.tolist()))
        ).encode()

    # -- fragment sync endpoints (reference api.go:376-472) --

    def fragment_blocks(
        self, index: str, field: str, shard: int, view: str = VIEW_STANDARD
    ) -> list[dict]:
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise NotFoundError("fragment not found")
        return [
            {"id": bid, "checksum": digest.hex()} for bid, digest in frag.blocks()
        ]

    def fragment_block_data(
        self, index: str, field: str, view: str, shard: int, block: int
    ) -> dict:
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise NotFoundError("fragment not found")
        rows, cols = frag.block_data(block)
        return {"rows": rows.tolist(), "columns": cols.tolist()}

    def marshal_fragment(self, index: str, field: str, view: str, shard: int) -> bytes:
        """Fragment backup archive: a tar with "data" (roaring bytes),
        "cache" (protobuf id list), and "digest" (blake2b-128 hex of
        the data entry) entries, the reference's WriteTo format
        (fragment.go:1511-1568) extended with the checksum the restore
        side verifies before applying. A quarantined fragment refuses
        (503): its bits are poisoned and must not propagate to peers."""
        import hashlib
        import io
        import tarfile

        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            raise NotFoundError("fragment not found")
        frag.check_serving()
        from pilosa_tpu_torch.core.cache import encode_cache

        with frag.mu:  # consistent (data, cache) snapshot under writers
            data = frag.storage.to_bytes()
            cbuf = encode_cache(frag.cache.ids())
        digest = hashlib.blake2b(data, digest_size=16).hexdigest().encode()
        out = io.BytesIO()
        with tarfile.open(fileobj=out, mode="w") as tw:
            for name, blob in (("data", data), ("cache", cbuf), ("digest", digest)):
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                info.mode = 0o600
                tw.addfile(info, io.BytesIO(blob))
        return out.getvalue()

    def unmarshal_fragment(
        self, index: str, field: str, view: str, shard: int, data: bytes
    ) -> None:
        """Restore a fragment from a tar archive (reference ReadFrom,
        fragment.go:1570-1681) or from raw roaring bytes (this
        framework's pre-tar wire format). The archive's checksum (the
        "digest" entry, when present) is verified and the bytes fully
        PARSED before the live fragment is touched — a corrupt backup
        can never clobber a healthy fragment mid-apply."""
        import hashlib
        import io
        import tarfile

        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        v = f.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(shard)
        from pilosa_tpu_torch.core.cache import decode_cache
        from pilosa_tpu_torch.roaring import Bitmap

        cache_ids = None
        want_digest = None
        try:
            with tarfile.open(fileobj=io.BytesIO(data)) as tr:
                members = {m.name: m for m in tr.getmembers()}
                entry = members.get("data")
                blob = tr.extractfile(entry) if entry is not None else None
                if blob is None:
                    raise APIError("fragment archive has no 'data' entry")
                data = blob.read()
                centry = members.get("cache")
                cfile = tr.extractfile(centry) if centry is not None else None
                if cfile is not None:
                    cache_ids = decode_cache(cfile.read())
                dentry = members.get("digest")
                dfile = tr.extractfile(dentry) if dentry is not None else None
                if dfile is not None:
                    want_digest = dfile.read().decode("ascii", "replace").strip()
        except tarfile.ReadError:
            pass  # raw roaring bytes

        if want_digest is not None:
            got = hashlib.blake2b(data, digest_size=16).hexdigest()
            if got != want_digest:
                metrics.count(metrics.RESTORE_REFUSED)
                events.record(
                    events.RESTORE_REFUSED,
                    index=index,
                    field=field,
                    view=view,
                    shard=shard,
                    reason="fragment archive digest mismatch",
                )
                raise APIError(
                    "fragment archive checksum mismatch; restore refused",
                    status=400,
                )
        try:
            storage = Bitmap.unmarshal_binary(data)
        except Exception as e:
            metrics.count(metrics.RESTORE_REFUSED)
            events.record(
                events.RESTORE_REFUSED,
                index=index,
                field=field,
                view=view,
                shard=shard,
                reason="fragment archive unparseable",
            )
            raise APIError(
                f"fragment archive unparseable; restore refused: {e}",
                status=400,
            )
        self._replace_fragment_storage(frag, storage, cache_ids)

    def _replace_fragment_storage(self, frag, storage, cache_ids=None) -> None:
        """Swap a fragment's bitmap for an already-verified one and
        rebuild every derived structure. Clears any quarantine: the
        incoming storage passed verification, so this IS the repair."""
        with frag.mu:
            op_writer = frag.storage.op_writer
            frag.storage = storage
            frag.storage.op_writer = op_writer
            frag.generation += 1
            frag.quarantined = False
            frag.quarantine_reason = ""
            frag._delta_reset()  # wholesale replace: no replayable deltas
            frag._row_cache.clear()
            frag.checksums.clear()
            frag._occ = None
            frag._recompute_max_row_id()
            frag.cache.clear()
            if cache_ids is None:
                # raw-bytes restore carries no cache entry: rebuild from
                # the restored rows so TopN answers immediately
                cache_ids = frag.row_ids()
            for row_id in cache_ids:
                # already under frag.mu — use the unlocked row read
                frag.cache.bulk_add(
                    row_id, frag._unprotected_row(row_id).count()
                )
            frag.cache.invalidate()
            frag.snapshot()

    # -- holder backup / restore --

    BACKUP_MANIFEST_VERSION = 1

    def backup(self) -> bytes:
        """Full-holder backup: a tar of the schema plus every fragment's
        roaring bytes, led by a MANIFEST.json naming every member with
        its blake2b-128 digest and size. The manifest is written FIRST
        so a restore can verify the whole archive before applying a
        byte. A quarantined fragment refuses the backup (503) — backing
        up known-poisoned bits would launder the corruption into the
        recovery path."""
        import hashlib
        import io
        import tarfile

        entries: list[tuple[str, bytes]] = []
        schema_blob = json.dumps(self.holder.schema()).encode()
        entries.append(("schema.json", schema_blob))
        for iname, idx in self.holder.indexes.items():
            for fname, fld in idx.fields.items():
                for vname, view in fld.views.items():
                    for shard, frag in sorted(view.fragments.items()):
                        frag.check_serving()
                        with frag.mu:
                            data = frag.storage.to_bytes()
                        entries.append(
                            (f"fragments/{iname}/{fname}/{vname}/{shard}", data)
                        )
        # the key-translation logs ride along: a restored holder must
        # resolve exactly the archive's keys (translate/<store>.log)
        ts = self.executor.translate_store
        if ts is not None:
            for name, blob in ts.store_files():
                entries.append((f"translate/{name}.log", blob))
        manifest = {
            "version": self.BACKUP_MANIFEST_VERSION,
            "entries": {
                name: {
                    "blake2b": hashlib.blake2b(blob, digest_size=16).hexdigest(),
                    "size": len(blob),
                }
                for name, blob in entries
            },
        }
        out = io.BytesIO()
        with tarfile.open(fileobj=out, mode="w") as tw:
            for name, blob in [
                ("MANIFEST.json", json.dumps(manifest, indent=1).encode())
            ] + entries:
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                info.mode = 0o600
                tw.addfile(info, io.BytesIO(blob))
        metrics.count(metrics.BACKUP_ARCHIVES)
        return out.getvalue()

    def restore(self, archive: bytes) -> dict:
        """Restore a holder backup. EVERYTHING is verified before
        ANYTHING is applied: the manifest must name exactly the members
        present, every blob must match its recorded digest and size,
        the schema must parse, and every fragment blob must parse as a
        roaring bitmap. Any failure refuses the whole restore (400)
        with the holder untouched."""
        import hashlib
        import io
        import tarfile

        from pilosa_tpu_torch.roaring import Bitmap
        from pilosa_tpu_torch.translate.store import SpaceStore

        def refuse(reason: str) -> APIError:
            metrics.count(metrics.RESTORE_REFUSED)
            events.record(events.RESTORE_REFUSED, reason=reason)
            return APIError(f"{reason}; restore refused", status=400)

        try:
            with tarfile.open(fileobj=io.BytesIO(archive)) as tr:
                blobs = {}
                for m in tr.getmembers():
                    f = tr.extractfile(m)
                    if f is not None:
                        blobs[m.name] = f.read()
        except tarfile.ReadError:
            raise refuse("backup archive is not a tar")
        mblob = blobs.pop("MANIFEST.json", None)
        if mblob is None:
            raise refuse("backup archive has no MANIFEST.json")
        try:
            manifest = json.loads(mblob)
            version = manifest["version"]
            want = manifest["entries"]
        except Exception:
            raise refuse("backup manifest unparseable")
        if version != self.BACKUP_MANIFEST_VERSION:
            raise refuse(f"backup manifest version {version} unsupported")
        if set(want) != set(blobs):
            missing = sorted(set(want) - set(blobs))[:3]
            extra = sorted(set(blobs) - set(want))[:3]
            raise refuse(
                f"backup members diverge from manifest"
                f" (missing={missing} extra={extra})"
            )
        for name, meta in want.items():
            blob = blobs[name]
            if len(blob) != meta.get("size"):
                raise refuse(f"backup entry {name} size mismatch")
            got = hashlib.blake2b(blob, digest_size=16).hexdigest()
            if got != meta.get("blake2b"):
                raise refuse(f"backup entry {name} checksum mismatch")
        try:
            schema = json.loads(blobs["schema.json"])
        except Exception:
            raise refuse("backup schema.json unparseable")
        fragments = []
        for name, blob in blobs.items():
            if not name.startswith("fragments/"):
                continue
            parts = name.split("/")
            if len(parts) != 5 or not parts[4].isdigit():
                raise refuse(f"backup entry {name} has a malformed path")
            try:
                storage = Bitmap.unmarshal_binary(blob)
            except Exception:
                raise refuse(f"backup entry {name} unparseable")
            fragments.append((parts[1], parts[2], parts[3], int(parts[4]), storage))
        translate_blobs = {}
        ts = self.executor.translate_store
        for name, blob in blobs.items():
            if not name.startswith("translate/") or not name.endswith(".log"):
                continue
            store = name[len("translate/") : -len(".log")]
            if "/" not in store or ".." in store or store.startswith(("/", "\\")):
                raise refuse(f"backup entry {name} has a malformed path")
            # a tampered log would rebind every key written through it:
            # its frames must parse, CRCs intact, to its last byte
            probe = SpaceStore(None, "probe")
            if probe._replay(blob) != len(blob):
                raise refuse(f"backup entry {name} unparseable")
            translate_blobs[store] = blob
        if translate_blobs and ts is None:
            raise refuse("backup has translate entries but no translate store")
        # -- verification complete: apply --
        self.holder.apply_schema(schema)
        for iname, fname, vname, shard, storage in fragments:
            fld = self.holder.field(iname, fname)
            view = fld.create_view_if_not_exists(vname)
            frag = view.create_fragment_if_not_exists(shard)
            self._replace_fragment_storage(frag, storage)
        if translate_blobs:
            # replace-all within the translate plane: the restored holder
            # resolves exactly the archive's keys (an archive without
            # translate members leaves the local stores as they are)
            ts.restore_stores(translate_blobs)
        self._send_sync({"type": "schema", "schema": schema})
        metrics.count(metrics.RESTORE_APPLIED)
        return {"fragments": len(fragments), "version": version}

    # -- caches --

    def recalculate_caches(self) -> None:
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                for v in f.views.values():
                    for frag in v.fragments.values():
                        frag.cache.recalculate()
        # rank reorders can change TopN candidate walks without any
        # fragment generation bump: cached TopN results are stale
        pc = getattr(self.executor, "plan_cache", None)
        if pc is not None:
            pc.epoch_reset()
        self._send_sync({"type": "recalculate-caches"})

    # -- info / status --

    def version(self) -> str:
        return __version__

    def info(self) -> dict:
        import os

        return {
            "shardWidth": SHARD_WIDTH,
            "cpuPhysicalCores": os.cpu_count(),
            "cpuLogicalCores": os.cpu_count(),
        }

    def status(self) -> dict:
        cl = self.cluster
        out = {
            "state": cl.state if cl is not None else STATE_NORMAL,
            "nodes": [n.to_dict() for n in cl.nodes] if cl is not None else [],
            "localID": cl.node_id if cl is not None else "",
        }
        integ = self._integrity_status()
        if integ:
            out["integrity"] = integ
        # the card and its health gate: after a sticky CUDA error the
        # gate stays tripped and reads run on the CPU leg, counted here
        ex = self.executor
        health = getattr(ex, "health", None)
        out["device"] = {
            "type": ex.device.type,
            "healthy": health.healthy if health is not None else True,
            "trips": health.trips if health is not None else 0,
            "cpu_fallbacks": metrics.snapshot().get(
                metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0
            ),
        }
        return out

    def _integrity_status(self) -> dict:
        """Quarantined fragments + scrub-unrecoverable records for
        /status — empty dict when the holder is healthy so the common
        path stays unchanged."""
        quarantined = []
        for iname, idx in self.holder.indexes.items():
            for fname, fld in idx.fields.items():
                for vname, view in fld.views.items():
                    for shard, frag in view.fragments.items():
                        if frag.quarantined:
                            quarantined.append(
                                {
                                    "index": iname,
                                    "field": fname,
                                    "view": vname,
                                    "shard": shard,
                                    "reason": frag.quarantine_reason,
                                }
                            )
        out: dict = {}
        if quarantined:
            out["quarantined"] = quarantined
        return out

    def max_shards(self) -> dict[str, int]:
        return {
            name: idx.max_shard() for name, idx in self.holder.indexes.items()
        }

    def hosts(self) -> list[dict]:
        if self.cluster is None:
            return []
        return [n.to_dict() for n in self.cluster.nodes]

    def shard_nodes(self, index: str, shard: int) -> list[dict]:
        if self.cluster is None:
            return []
        return [n.to_dict() for n in self.cluster.shard_nodes(index, shard)]

    # -- cluster messages and liveness (wired by the cluster layer) --

    def cluster_message(self, msg: dict) -> None:
        if self.server is None:
            raise APIError("cluster not configured")
        self.server.receive_message(msg)

    def probe_node(self, uri: str) -> bool:
        """Probe ``uri``'s /status with the cluster's short probe
        timeout: the relay half of SWIM indirect probing. Only URIs of
        known cluster members are probed, as memberlist's ping-req only
        targets members, so the endpoint is no open relay into arbitrary
        internal addresses."""
        if self.cluster is None:
            return False
        from pilosa_tpu_torch.utils.uri import same_endpoint

        with self.cluster.mu:
            known = any(same_endpoint(n.uri, uri) for n in self.cluster.nodes)
        if not known:
            return False
        try:
            self.cluster._probe_client.status(uri)
            return True
        except Exception:
            return False

    # -- attribute diffs (reference api.go attr-diff path, holder.go:654-740) --

    def column_attr_diff(self, index: str, blocks: list) -> dict:
        """Column attrs of the blocks whose checksums differ from the
        caller's."""
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        return _attr_diff(idx.column_attrs, blocks)

    def row_attr_diff(self, index: str, field: str, blocks: list) -> dict:
        f = self.holder.field(index, field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        return _attr_diff(f.row_attr_store, blocks)

    # -- key translation --

    def _translate_store(self):
        self._refuse_keys("the translate store")
        ts = self.executor.translate_store
        if ts is None:
            raise APIError("translate store not configured")
        return ts

    def get_translate_data(self, offset: int, store: str = "") -> bytes:
        ts = self._translate_store()
        if store:
            try:
                return ts.read_store(store, offset)
            except ValueError as e:
                raise APIError(str(e), status=400)
        data, _ = ts.read_from(offset)
        return data

    def translate_stores(self) -> list:
        """Durable translate stores with byte offsets: what a peer polls
        to pull key assignments."""
        return self._translate_store().stores()

    def translate_debug(self) -> dict:
        ts = self.executor.translate_store
        if ts is None:
            return {"enabled": False}
        out = ts.stats()
        out["enabled"] = True
        return out

    def translate_ingest_keys(self, index: str, field: str, row_keys, column_keys) -> tuple:
        """Keyed ingest: the batch's keys become ids BEFORE the ingest
        queue sees it, so write waves carry ids only; the assignments
        group-commit with one fsync a store."""
        ts = self._translate_store()
        rows = cols = None
        if column_keys:
            cols = ts.translate_columns_to_ids(index, [str(k) for k in column_keys])
        if row_keys:
            rows = ts.translate_rows_to_ids(index, field, [str(k) for k in row_keys])
        return rows, cols

    def translate_keys(self, index: str, field: str, keys: list) -> list:
        """Mint (or look up) ids for keys: the owner's end of a forwarded
        mint. It mints here, never forwards again, and answers 409 when
        another node owns a key's space (minting here would fork the
        cluster's id space). One node owns every space."""
        ts = self._translate_store()
        keys = [str(k) for k in keys]
        owner = ts.misowned(index, field, keys)
        if owner:
            raise APIError(
                f"not the owner of these keys (owner={owner}); minting "
                "here would fork the cluster id space — post to the "
                "owner or fix translate-primary-url",
                status=409,
            )
        return ts.mint(index, field, keys)


def _attr_diff(store, blocks: list) -> dict:
    """Attrs of the store's 100-id blocks whose checksum differs from the
    caller's [block, hex digest] list, keyed by id as strings."""
    if store is None:
        return {}
    theirs = {b[0]: bytes.fromhex(b[1]) for b in blocks}
    out: dict = {}
    for bid, digest in store.blocks():
        if theirs.get(bid) != digest:
            out.update(store.block_data(bid))
    return {str(k): v for k, v in out.items()}


def _parse_timestamps(timestamps):
    if not timestamps or not any(t for t in timestamps):
        return None
    from datetime import datetime

    return [
        datetime.fromtimestamp(t) if isinstance(t, (int, float)) and t else None
        for t in timestamps
    ]
