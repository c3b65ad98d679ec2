"""Command-line interface (L8) — reference cmd/ + ctl/.

The port of ``pilosa_tpu/cli/main.py``. Subcommands: server, import,
export, backup, restore, check, inspect, metrics, events, debug-bundle,
config, generate-config. Config precedence: flags > env (PILOSA_TPU_*)
> TOML file (reference cmd/root.go:90-146). ``server --device cpu``
runs the kernels' plain versions; without it the server needs CUDA.
A flag that needs a subsystem the port lacks (a cluster, a mesh,
multihost) exits non-zero naming its ROADMAP item.

Run as ``python -m pilosa_tpu_torch <subcommand>``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import signal
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime

from pilosa_tpu_torch import __version__


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pilosa_tpu_torch",
        description="bitmap index on PyTorch and CUDA",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("server", help="run a server node")
    p.add_argument("-c", "--config", help="TOML config file")
    p.add_argument("-d", "--data-dir", help="data directory")
    p.add_argument("-b", "--bind", help="host:port to bind")
    p.add_argument(
        "--device",
        help="torch device to run on: cuda (default) or cpu (the kernels' "
        "plain versions)",
    )
    p.add_argument("--device-policy", choices=["never", "auto", "always"])
    p.add_argument(
        "--mesh-devices",
        help="device mesh over the shard axis (not ported yet: ROADMAP A8)",
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        default=None,
        help="multihost serving (not ported yet: ROADMAP A8)",
    )
    p.add_argument(
        "--coordinator-address",
        help="multihost coordinator host:port (not ported yet: ROADMAP A8)",
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="this rank's process id, 0..N-1 (0 = serving leader)",
    )
    p.add_argument(
        "--num-processes",
        type=int,
        default=None,
        help="total process count in the multihost deployment",
    )
    p.add_argument("--cluster-disabled", action="store_true", default=None)
    p.add_argument("--coordinator", action="store_true", default=None)
    p.add_argument("--coordinator-host")
    p.add_argument("--replicas", type=int)
    p.add_argument("--hosts", help="comma-separated static cluster hosts")
    p.add_argument("--verbose", action="store_true", default=None)
    p.add_argument("--tls-certificate", help="TLS certificate path (enables https)")
    p.add_argument("--tls-certificate-key", help="TLS certificate key path")
    p.add_argument(
        "--tls-skip-verify",
        action="store_true",
        default=None,
        help="clients skip TLS peer verification",
    )
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("import", help="bulk-import CSV bits or values")
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--field", required=True)
    p.add_argument("--create", action="store_true", help="create schema if missing")
    p.add_argument(
        "--field-type", default="set", help="field type when creating (set/int/time)"
    )
    p.add_argument("--field-min", type=int, default=0)
    p.add_argument("--field-max", type=int, default=0)
    p.add_argument("--time-quantum", default="")
    p.add_argument(
        "--values",
        action="store_true",
        help="rows are col,value pairs for an int field",
    )
    # reference default: 10M-bit import buffer (ctl/import.go:84).
    # Every batch pays a snapshot per touched fragment, so a small
    # default made big imports quadratic-ish (measured: 2M bits in 20
    # batches spent ~90 s re-snapshotting growing fragments)
    p.add_argument("--batch-size", type=int, default=10_000_000)
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("export", help="export a field as CSV")
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--field", required=True)
    p.add_argument("-o", "--output", help="output file (default stdout)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "backup",
        help="download a full-holder backup archive (schema + every "
        "fragment, with a per-entry checksum manifest)",
    )
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument("-o", "--output", required=True, help="archive file to write")
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser(
        "restore",
        help="restore a holder backup archive; the whole archive is "
        "checksum-verified before any byte is applied",
    )
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument("archive", help="archive file written by backup")
    p.set_defaults(fn=cmd_restore)

    p = sub.add_parser(
        "check",
        help="verify integrity of fragment files",
    )
    p.add_argument("files", nargs="+", help="fragment files")
    p.add_argument(
        "--repair",
        action="store_true",
        help="fragment files only: truncate a torn op-log tail in place "
        "(offline repair; the snapshot base and every intact op survive)",
    )
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("inspect", help="dump container layout of a fragment file")
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "metrics",
        help="fetch a node's Prometheus /metrics (or recent query traces)",
    )
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument(
        "--traces",
        action="store_true",
        help="fetch /debug/traces (recent query span trees) instead",
    )
    p.add_argument(
        "--pipeline",
        action="store_true",
        help="fetch /debug/pipeline (serving-pipeline queue/shed/batch "
        "snapshot) instead",
    )
    p.add_argument(
        "--cache",
        action="store_true",
        help="fetch /debug/plancache (plan result-cache hit/invalidation/"
        "bytes snapshot) instead",
    )
    p.add_argument(
        "--dispatch",
        action="store_true",
        help="fetch /debug/dispatch (continuous-batching dispatch engine "
        "wave/queue/idle snapshot) instead",
    )
    p.add_argument(
        "--fleet",
        action="store_true",
        help="fetch the fleet-aggregated exposition (/metrics?fleet=true, "
        "gang/federation leaders only) instead",
    )
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "events",
        help="fetch a node's lifecycle event journal (/debug/events)",
    )
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument(
        "--kind",
        help="only events of this kind (e.g. gang.transition, gang.degrade, "
        "gang.reform, client.retry_exhausted)",
    )
    p.add_argument(
        "--since",
        type=int,
        default=0,
        help="only events with a sequence number above this",
    )
    p.add_argument(
        "--follow",
        action="store_true",
        help="tail the journal live: print new events as JSONL, polling "
        "from the last seen seq (Ctrl-C to stop)",
    )
    p.add_argument(
        "--interval",
        type=float,
        default=1.0,
        help="poll interval in seconds for --follow",
    )
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser(
        "debug-bundle",
        help="capture a node's forensics bundle (/debug/bundle) to a tar: "
        "config, status, metrics, traces, events tail, heat snapshot, "
        "governor stats",
    )
    p.add_argument("--host", default="http://localhost:10101")
    p.add_argument(
        "-o", "--output", default="pilosa-debug-bundle.tar",
        help="output tar path",
    )
    p.set_defaults(fn=cmd_debug_bundle)

    p = sub.add_parser("config", help="print the effective configuration")
    p.add_argument("-c", "--config", help="TOML config file")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("generate-config", help="print the default configuration")
    p.set_defaults(fn=cmd_generate_config)

    args = parser.parse_args(argv)
    return args.fn(args)


def _load_config(args):
    from pilosa_tpu_torch.server import Config

    cfg = Config.from_toml(args.config) if getattr(args, "config", None) else Config()
    cfg.apply_env()
    return cfg


def cmd_server(args) -> int:
    from pilosa_tpu_torch.server import Server

    cfg = _load_config(args)
    if args.data_dir:
        cfg.data_dir = args.data_dir
    if args.bind:
        cfg.bind = args.bind
    if args.device:
        cfg.device = args.device
    if args.device_policy:
        cfg.device_policy = args.device_policy
    if args.mesh_devices:
        cfg.mesh_devices = args.mesh_devices
    if args.verbose is not None:
        cfg.verbose = args.verbose
    if args.cluster_disabled is not None:
        cfg.cluster.disabled = args.cluster_disabled
    if args.coordinator is not None:
        cfg.cluster.coordinator = args.coordinator
        cfg.cluster.disabled = False
    if args.coordinator_host:
        cfg.cluster.coordinator_host = args.coordinator_host
        cfg.cluster.disabled = False
    if args.replicas:
        cfg.cluster.replicas = args.replicas
    if args.hosts:
        cfg.cluster.hosts = args.hosts.split(",")
        cfg.cluster.disabled = False
    if args.tls_certificate:
        cfg.tls.certificate_path = args.tls_certificate
    if args.tls_certificate_key:
        cfg.tls.certificate_key_path = args.tls_certificate_key
    if args.tls_skip_verify is not None:
        cfg.tls.skip_verify = args.tls_skip_verify
    if args.distributed is not None:
        cfg.distributed_enabled = args.distributed
    if args.coordinator_address:
        cfg.distributed_coordinator = args.coordinator_address
        cfg.distributed_enabled = True
    if args.process_id is not None:
        cfg.distributed_process_id = args.process_id
    if args.num_processes is not None:
        cfg.distributed_num_processes = args.num_processes

    try:
        server = Server(cfg)
    except (NotImplementedError, RuntimeError) as e:
        # a subsystem not ported yet (the message names its ROADMAP
        # item), or CUDA asked for and absent
        print(f"server: {e}", file=sys.stderr)
        return 2
    stop = []
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    server.open()
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        server.close()
    return 0


def _post(host, path, body, is_json=True, timeout: float = 60) -> dict:
    data = json.dumps(body).encode() if is_json else body
    req = urllib.request.Request(host + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _try_native_csv(path):
    """(rows, cols) u64 arrays via the native parser, or None. Probes
    the first few KB before committing: a file the fast path cannot
    take (timestamps, quoting — fully supported by the csv loop) costs
    a 4 KB read, not a full-file slurp; the qualifying file parses
    straight from an mmap, so peak memory is the output arrays."""
    import mmap as _mmap

    from pilosa_tpu_torch import native_bridge

    try:
        with open(path, "rb") as bf:
            mm = _mmap.mmap(bf.fileno(), 0, access=_mmap.ACCESS_READ)
    except (OSError, ValueError):  # unmmappable (empty file, pipe)
        return None
    try:
        head = mm[:4096]
        if len(head) == 4096:
            cut = head.rfind(b"\n")
            if cut < 0:
                return None  # one huge line: not this format
            head = head[: cut + 1]
        if native_bridge.parse_csv_pairs(head) is None:
            return None
        try:
            return native_bridge.parse_csv_pairs(mm)
        except MemoryError:
            # output arrays (~16 B/pair) didn't fit: the csv loop
            # streams in batch_size chunks and completes where the
            # one-shot arrays cannot
            return None
    finally:
        mm.close()


def cmd_import(args) -> int:
    host = args.host if args.host.startswith("http") else f"http://{args.host}"
    if args.create:
        try:
            _post(host, f"/index/{args.index}", {})
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise
        opts = {"type": args.field_type}
        if args.field_type == "int":
            opts.update(min=args.field_min, max=args.field_max)
        if args.time_quantum:
            opts["timeQuantum"] = args.time_quantum
        try:
            _post(host, f"/index/{args.index}/field/{args.field}", {"options": opts})
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise

    def flush(rows, cols, timestamps):
        if not cols:
            return
        # the server json-decodes the body and runs merge+snapshot
        # before responding; scale the timeout with the batch (a 10M-bit
        # reference-default batch is ~150 MB of JSON) instead of letting
        # a fixed 60 s abort a large import mid-way
        timeout = max(60.0, 60.0 + len(cols) / 20_000)
        if args.values:
            # value-mode CSV is columnID,value (reference
            # ctl/import.go:404-415), so the first CSV field — parsed
            # into `rows` — is the column id and the second the value
            _post(
                host,
                f"/index/{args.index}/field/{args.field}/import-value",
                {"columnIDs": rows, "values": cols},
                timeout=timeout,
            )
        else:
            body = {"rowIDs": rows, "columnIDs": cols}
            if any(t for t in timestamps):
                body["timestamps"] = timestamps
            _post(
                host,
                f"/index/{args.index}/field/{args.field}/import",
                body,
                timeout=timeout,
            )

    total = 0
    for path in args.files:
        if path != "-" and args.batch_size > 0:
            # native fast path: strict numeric 2-column CSV parses at
            # C speed (native/bitmap_kernels.cpp pt_parse_csv_pairs);
            # any deviation — timestamps, quoting, junk — returns None
            # and the Python csv loop below handles it with proper
            # per-line errors (reference ctl/import.go semantics)
            parsed = _try_native_csv(path)
            if parsed is not None:
                a, b = parsed
                for lo in range(0, len(a), args.batch_size):
                    hi = min(lo + args.batch_size, len(a))
                    # the strict format has no timestamp column; flush
                    # skips the key for an empty list
                    flush(a[lo:hi].tolist(), b[lo:hi].tolist(), [])
                    total += hi - lo
                continue
        f = sys.stdin if path == "-" else open(path)
        rows, cols, timestamps = [], [], []
        try:
            for lineno, record in enumerate(csv.reader(f), 1):
                if not record or not record[0].strip():
                    continue
                try:
                    a = int(record[0])
                    b = int(record[1])
                except (ValueError, IndexError) as e:
                    print(f"{path}:{lineno}: bad record {record!r}: {e}", file=sys.stderr)
                    return 1
                rows.append(a)
                cols.append(b)
                ts = 0
                if len(record) > 2 and record[2].strip():
                    ts = int(
                        datetime.strptime(
                            record[2].strip(), "%Y-%m-%dT%H:%M"
                        ).timestamp()
                    )
                timestamps.append(ts)
                if len(cols) >= args.batch_size:
                    flush(rows, cols, timestamps)
                    total += len(cols)
                    rows, cols, timestamps = [], [], []
        finally:
            if f is not sys.stdin:
                f.close()
        flush(rows, cols, timestamps)
        total += len(cols)
    print(f"imported {total} records", file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    host = args.host if args.host.startswith("http") else f"http://{args.host}"
    with urllib.request.urlopen(host + "/internal/shards/max", timeout=60) as resp:
        max_shards = json.loads(resp.read()).get("standard", {})
    max_shard = max_shards.get(args.index, 0)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for shard in range(max_shard + 1):
            url = f"{host}/export?index={args.index}&field={args.field}&shard={shard}"
            with urllib.request.urlopen(url, timeout=60) as resp:
                out.write(resp.read().decode())
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_backup(args) -> int:
    """Stream GET /backup to a file (reference ctl/backup.go)."""
    host = args.host if args.host.startswith("http") else f"http://{args.host}"
    host = host.rstrip("/")
    r = urllib.request.Request(host + "/backup", method="GET")
    with urllib.request.urlopen(r, timeout=600) as resp:
        data = resp.read()
    with open(args.output, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    print(f"backup: wrote {len(data)} bytes to {args.output}")
    return 0


def cmd_restore(args) -> int:
    """POST an archive to /restore (reference ctl/restore.go). The
    server verifies the manifest before applying; a refusal (400)
    exits non-zero with the server's reason."""
    host = args.host if args.host.startswith("http") else f"http://{args.host}"
    host = host.rstrip("/")
    with open(args.archive, "rb") as f:
        data = f.read()
    r = urllib.request.Request(host + "/restore", data=data, method="POST")
    try:
        with urllib.request.urlopen(r, timeout=600) as resp:
            body = json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            reason = json.loads(e.read() or b"{}").get("error", str(e))
        except Exception:
            reason = str(e)
        print(f"restore: REFUSED: {reason}", file=sys.stderr)
        return 1
    print(f"restore: applied ({body.get('fragments', 0)} fragments)")
    return 0


def _open_lazy(path):
    """Mmap-open a roaring file: check/inspect of a 1B-scale fragment
    (~15.6M containers) must stream, not materialize one Python object
    per container. Same open semantics as the fragment runtime."""
    from pilosa_tpu_torch.roaring import Bitmap

    return Bitmap.open_mmap_file(path)


def cmd_check(args) -> int:
    """Fragment-file integrity check (reference ctl/check.go). Source
    trees are the repository's invariant checker's, not this CLI's."""
    code = [p for p in args.files if os.path.isdir(p) or p.endswith(".py")]
    if code:
        print(
            f"check: {code[0]}: this command verifies fragment files; source "
            "trees go through the repository's invariant checker",
            file=sys.stderr,
        )
        return 2
    return _check_fragments(args.files, repair=args.repair)


def _check_fragments(files, repair: bool = False) -> int:
    rc = 0
    for path in files:
        if path.endswith(".cache") or path.endswith(".snapshotting"):
            continue
        try:
            # byte-level integrity first (digest trailer + op-log CRC
            # walk): a rotted base or torn tail must exit non-zero
            # BEFORE the container walk can trip over decoded garbage
            err = _check_file_bytes(path, repair=repair)
            if err is not None:
                raise ValueError(err)
            b = _open_lazy(path)
            # container-level invariants (streaming: one ephemeral
            # decode at a time)
            n_containers = 0
            for key in b._iter_keys_sorted():
                c = b.containers[key]
                p = c.positions()
                if p.size != c.n:
                    raise ValueError(
                        f"container {key}: cardinality mismatch {p.size} != {c.n}"
                    )
                if p.size > 1 and not (p[:-1] < p[1:]).all():
                    raise ValueError(f"container {key}: positions not sorted/unique")
                n_containers += 1
            # validate the sidecar BEFORE printing the fragment's ok
            # line: a corrupt sidecar must not leave 'path: ok' on
            # stdout for a path that exits 1
            occ = _check_occ_sidecar(path, b)
            print(f"{path}: ok (bits={b.count()}, containers={n_containers}, ops={b.op_n})")
            if occ is not None:
                print(f"{path}.occ: {occ}")
        except Exception as e:
            print(f"{path}: FAILED: {e}", file=sys.stderr)
            rc = 1
    return rc


def _check_file_bytes(path: str, repair: bool = False) -> "str | None":
    """Offline byte-level verification (reference ctl/check.go, extended
    for the checksummed snapshot format): the blake2b digest trailer
    over the base, then a CRC/framing walk of the op-log tail. Returns
    an error string (→ exit 1), or None. With ``repair``, a torn tail
    is truncated in place at the last valid record boundary — the
    exact cut crash recovery would make at the next open, done offline
    so the file verifies clean NOW."""
    from pilosa_tpu_torch.roaring import bitmap as bm

    with open(path, "rb") as f:
        data = f.read()
    if len(data) < bm.HEADER_BASE_SIZE:
        return None  # empty/new fragment: nothing to verify
    try:
        base_end = bm.snapshot_base_end(data)
    except Exception as e:
        return f"snapshot header unparseable: {e}"
    if bm.has_digest_trailer(data, base_end):
        if not bm.verify_digest_trailer(data, base_end):
            return "snapshot digest mismatch (base bytes rotted)"
    ops_offset = bm.ops_offset_of(data)
    valid_end, n_ops = bm.scan_op_log(data, ops_offset)
    if valid_end < len(data):
        torn = len(data) - valid_end
        if not repair:
            return (
                f"op log torn/corrupt at byte {valid_end} "
                f"({torn} trailing bytes; --repair truncates them)"
            )
        with open(path, "r+b") as f:
            f.truncate(valid_end)
            f.flush()
            os.fsync(f.fileno())
        print(
            f"{path}: repaired (truncated {torn} torn bytes; "
            f"{n_ops} intact ops kept)"
        )
    return None


def _check_occ_sidecar(path: str, b) -> "str | None":
    """Validate a .occ occupancy sidecar against the fragment it
    accelerates: the mmap store's loader applies the staleness stamp
    (size/mtime/base) exactly as the serving path would, then the keys
    and prefix sums are recomputed from the file and compared. Returns
    a status string, or None when no sidecar exists / the store isn't
    mmap-backed."""
    import os as _os

    import numpy as np

    if not _os.path.exists(path + ".occ"):
        return None
    store = getattr(b, "containers", None)
    if not hasattr(store, "_occ_sidecar_load"):
        return None
    got = store._occ_sidecar_load()
    if got is None:
        return "stale (stamp mismatch; serving ignores it — safe to delete)"
    from pilosa_tpu_torch.roaring.mmapstore import occ_arrays

    keys, cs = occ_arrays(*store.keys_and_counts())
    if np.array_equal(got[0], keys) and np.array_equal(got[1], cs):
        return f"ok (containers={keys.size}, bits={int(cs[-1]) if cs.size else 0})"
    # a sidecar that PASSES the staleness stamp but disagrees with the
    # file would poison sparse staging — that is a real integrity
    # failure, not a stale-and-ignored accelerator
    raise ValueError(
        ".occ sidecar passes the staleness stamp but disagrees with the file"
    )


def cmd_inspect(args) -> int:
    """Dump container layout (reference ctl/inspect.go)."""
    names = {1: "array", 2: "bitmap", 3: "run"}
    for path in args.files:
        b = _open_lazy(path)
        print(f"{path}: bits={b.count()} containers={len(b.containers)} opN={b.op_n}")
        print(f"{'KEY':>12} {'TYPE':>8} {'N':>8} {'SIZE':>8}")
        for key in b._iter_keys_sorted():
            c = b.containers[key]
            print(f"{key:>12} {names.get(c.typ, '?'):>8} {c.n:>8} {c.size():>8}")
    return 0


def cmd_metrics(args) -> int:
    """Dump a node's observability surface: Prometheus text from
    /metrics, the recent-trace ring buffer with --traces, the
    serving-pipeline snapshot with --pipeline, the plan result-cache
    snapshot with --cache, or the dispatch-engine snapshot with
    --dispatch."""
    host = args.host if args.host.startswith("http") else f"http://{args.host}"
    if getattr(args, "dispatch", False):
        path = "/debug/dispatch"
    elif getattr(args, "cache", False):
        path = "/debug/plancache"
    elif args.pipeline:
        path = "/debug/pipeline"
    elif args.traces:
        path = "/debug/traces"
    else:
        path = "/metrics"
    if getattr(args, "fleet", False):
        path = "/metrics?fleet=true"
    try:
        with urllib.request.urlopen(host + path, timeout=60) as resp:
            body = resp.read().decode()
    except urllib.error.HTTPError as e:
        # a surface of a subsystem not ported yet answers 501 with
        # its ROADMAP item
        try:
            reason = json.loads(e.read() or b"{}").get("error", str(e))
        except ValueError:
            reason = str(e)
        print(f"metrics: {path}: HTTP {e.code}: {reason}", file=sys.stderr)
        return 1
    if path.startswith("/metrics"):
        print(body, end="")
    else:
        print(json.dumps(json.loads(body), indent=2))
    return 0


def cmd_events(args) -> int:
    """Dump a node's lifecycle event journal: gang state transitions,
    degrades, re-formations, and retry exhaustions, each stamped with
    seq/time/trace/gang/rank/epoch. ``--follow`` tails the journal
    live, paging from the durable backing via ``since=<last seq>``."""
    host = args.host if args.host.startswith("http") else f"http://{args.host}"

    def fetch(since: int) -> list:
        query = []
        if args.kind:
            query.append(f"kind={urllib.parse.quote(args.kind)}")
        if since:
            query.append(f"since={since}")
        path = "/debug/events" + (("?" + "&".join(query)) if query else "")
        with urllib.request.urlopen(host + path, timeout=60) as resp:
            return json.loads(resp.read().decode()).get("events", [])

    if not getattr(args, "follow", False):
        evs = fetch(args.since)
        print(json.dumps({"events": evs}, indent=2))
        return 0
    since = args.since
    try:
        while True:
            for ev in fetch(since):
                print(json.dumps(ev, separators=(",", ":")), flush=True)
                if ev.get("seq", 0) > since:
                    since = ev["seq"]
            time.sleep(max(0.05, args.interval))
    except KeyboardInterrupt:
        return 0


def cmd_debug_bundle(args) -> int:
    """Stream GET /debug/bundle to a tar file — everything an incident
    writeup needs from a live (or about-to-die) node in one capture."""
    host = args.host if args.host.startswith("http") else f"http://{args.host}"
    host = host.rstrip("/")
    r = urllib.request.Request(host + "/debug/bundle", method="GET")
    with urllib.request.urlopen(r, timeout=120) as resp:
        data = resp.read()
    with open(args.output, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    print(f"debug-bundle: wrote {len(data)} bytes to {args.output}")
    return 0


def cmd_config(args) -> int:
    cfg = _load_config(args)
    print(cfg.to_toml(), end="")
    return 0


def cmd_generate_config(args) -> int:
    from pilosa_tpu_torch.server import Config

    print(Config().to_toml(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
