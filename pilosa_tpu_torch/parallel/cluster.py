"""Cluster — shard placement, replication, liveness and the status
exchange of a static cluster (reference cluster.go).

The port of ``pilosa_tpu/parallel/cluster.py``'s static part: a fixed
host list, placement, map/reduce of reads across nodes with the re-map
onto a replica, the write fan-out, the schema, max-shard and status
messages, and the liveness prober. The control plane is host-side HTTP
carrying the reference's message set (reference broadcast.go:52-158);
the data plane (queries, imports) flows through InternalClient as in the
reference.

Not here, with the ROADMAP item that ports each: the join handshake,
resize and anti-entropy (A8b), the translate plane (A8c), and gangs and
federation (A8d). A follower that would join a coordinator raises, and
so does a message of those subsystems.

Placement is hash-identical to the reference (FNV partition + jump
hash + ring replicas), so both packages place every shard alike.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Optional

from pilosa_tpu_torch.parallel.client import ClientError, InternalClient
from pilosa_tpu_torch.parallel.hashing import DEFAULT_PARTITION_N, Jmphasher, partition
from pilosa_tpu_torch.parallel.node import Node
from pilosa_tpu_torch.parallel.wire import pairs_to_tuples
from pilosa_tpu_torch.server.config import A8B, A8C, A8D
from pilosa_tpu_torch.utils import heat, metrics, trace

STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"

# messages of the subsystems later slices of the multi-device plane
# port, with the ROADMAP item of each
_LATER_MESSAGES = {
    "node-join": A8B,
    "resize-instruction": A8B,
    "resize-complete": A8B,
    "holder-clean": A8B,
    "set-coordinator": A8B,
    "translate-keys": A8C,
    "gang-state": A8D,
    "leader-uri": A8D,
}

# per-node liveness states (the reference's memberlist SWIM
# alive/suspect/dead, gossip/gossip.go:431-494)
NODE_READY = "READY"
NODE_SUSPECT = "SUSPECT"
NODE_DOWN = "DOWN"


class ShardUnavailableError(Exception):
    """reference errShardUnavailable (executor.go:1699)."""


class Cluster:
    def __init__(
        self,
        node_id: str,
        uri: str,
        replica_n: int = 1,
        partition_n: int = DEFAULT_PARTITION_N,
        hasher=None,
        static: bool = True,
        coordinator: bool = True,
        topology_path: Optional[str] = None,
        logger=None,
        probe_timeout: float = 2.0,
        down_after: int = 3,
        ssl_context=None,
    ) -> None:
        self.node_id = node_id
        self.uri = uri
        self.replica_n = replica_n
        self.partition_n = partition_n
        self.hasher = hasher or Jmphasher()
        self.static = static
        self.is_coordinator = coordinator
        self.topology_path = topology_path
        self.logger = logger
        self.state = STATE_STARTING
        self.nodes: list[Node] = []
        self.client = InternalClient(ssl_context=ssl_context)
        self.server = None  # attached Server (broadcaster target)
        self.mu = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=16)
        # liveness probing (SWIM analog): consecutive probe failures per
        # node; down_after failures → DOWN, any failure → SUSPECT
        self.down_after = down_after
        self._fail_counts: dict[str, int] = {}
        # nodes with a DOWN-verification probe in flight (guarded by
        # self.mu): a chatty unreachable peer must cost at most ONE
        # blocked pool thread, not one per inbound message
        self._verifying: set[str] = set()
        self.probe_timeout = probe_timeout
        self._probe_client = InternalClient(
            timeout=probe_timeout, ssl_context=ssl_context
        )
        # the local leg's seam (the reference's, there for a gang leader):
        # a callable (index, call, shards, opt) -> the leg's result. The
        # server sets it to its executor's shard-batched remote leg; unset,
        # the local leg maps each shard with the executor's map_fn
        self.local_executor: Optional[Callable] = None

    # -- wiring --------------------------------------------------------------

    def attach_server(self, server) -> None:
        self.server = server
        me = Node(self.node_id, self.uri, is_coordinator=self.is_coordinator)
        with self.mu:
            if not any(n.id == me.id for n in self.nodes):
                self.nodes.append(me)
            self._sort_nodes()
        if self.static:
            self.state = STATE_NORMAL
            self._save_topology()
        elif self.is_coordinator:
            # the coordinator's CONFIG is operator intent: load the
            # node list but never let persisted placement params shadow
            # a deliberate config change (it re-broadcasts its values)
            self._load_topology(adopt_params=False)
            self.state = STATE_NORMAL
            self._save_topology()
        else:
            raise NotImplementedError(
                "joining a cluster through its coordinator is not ported to "
                f"pilosa_tpu_torch yet (ROADMAP {A8B})"
            )

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _sort_nodes(self) -> None:
        self.nodes.sort(key=lambda n: n.id)

    def set_nodes(self, nodes: list[Node]) -> None:
        """Static topology injection (tests / cluster.hosts config)."""
        with self.mu:
            self.nodes = list(nodes)
            self._sort_nodes()

    def local_node(self) -> Node:
        for n in self.nodes:
            if n.id == self.node_id:
                return n
        raise KeyError(self.node_id)

    def coordinator_node(self) -> Optional[Node]:
        for n in self.nodes:
            if n.is_coordinator:
                return n
        return None

    # -- topology persistence (reference .topology, cluster.go:1519-1554) ---

    def _save_topology(self) -> None:
        if not self.topology_path:
            return
        os.makedirs(os.path.dirname(self.topology_path) or ".", exist_ok=True)
        with open(self.topology_path, "w") as f:
            # placement parameters persist with the topology: an
            # adopted replicaN must survive a restart, or the node
            # reverts to its misconfigured local value and recreates
            # the ownership divergence adoption exists to close
            json.dump(
                {
                    "nodes": [n.to_dict() for n in self.nodes],
                    "replicaN": self.replica_n,
                    "partitionN": self.partition_n,
                },
                f,
            )

    def _load_topology(self, adopt_params: bool = True) -> None:
        if not self.topology_path:
            return
        try:
            with open(self.topology_path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return
        if isinstance(raw, list):  # legacy format: bare node list
            raw = {"nodes": raw}
        saved = [Node.from_dict(d) for d in raw.get("nodes", [])]
        with self.mu:
            by_id = {n.id: n for n in self.nodes}
            for n in saved:
                if n.id not in by_id:
                    # liveness is runtime evidence, not durable fact: a
                    # DOWN/SUSPECT persisted before a restart says
                    # nothing about the peer NOW (memberlist likewise
                    # starts every member alive and lets probing
                    # re-discover). Without this, a full-cluster
                    # restart would boot with peers stuck DOWN — and
                    # DOWN is only cleared by an active probe success.
                    n.state = NODE_READY
                    self.nodes.append(n)
            self._sort_nodes()
            if adopt_params:
                for key, attr in (
                    ("replicaN", "replica_n"),
                    ("partitionN", "partition_n"),
                ):
                    v = raw.get(key)
                    if v and int(v) != getattr(self, attr):
                        if self.logger:
                            self.logger.printf(
                                "restoring cluster %s=%s from topology "
                                "(local config had %s)",
                                attr, v, getattr(self, attr),
                            )
                        setattr(self, attr, int(v))

    # -- liveness (reference memberlist SWIM probing + NodeStatus
    #    push/pull, gossip/gossip.go:431-494, server.go:565-630) ------------

    # peers asked to confirm a suspect before it can be marked down
    # (reference memberlist IndirectChecks default = 3; we use 2 —
    # clusters here are typically small)
    INDIRECT_PROBES = 2

    def probe_nodes(self) -> None:
        """One liveness sweep: short-timeout /status probe of every peer,
        with SWIM-style INDIRECT confirmation — a direct failure is
        re-tried through up to INDIRECT_PROBES healthy third nodes
        (/internal/probe ping-req) before it counts, so one partitioned
        link cannot mark a healthy node DOWN (reference memberlist
        probing, gossip/gossip.go:431-494). A failure moves the node to
        SUSPECT; down_after consecutive failures to DOWN (skipped by
        query planning but kept in the topology — removal stays
        operator-initiated, reference cluster.go:1629-1631). A
        successful probe restores READY. Probes fan out through the
        pool, so a sweep costs one WORST-CASE peer verdict — direct
        probe timeout plus up to INDIRECT_PROBES serial relay
        round-trips for a dead peer (each relay blocks its own probe
        timeout before answering alive=false) — not O(dead peers) of
        them; the wait below is deadlined so one wedged relay
        connection cannot stall liveness forever."""

        def probe(node):
            try:
                self._probe_client.status(node.uri)
                alive = True
            except (ClientError, OSError):
                alive = self._probe_via_peers(node)
            self._note_probe(node, alive)

        futures = [self._pool.submit(probe, n) for n in self._other_nodes()]
        # worst case per peer: direct timeout + INDIRECT_PROBES relays,
        # each costing a request timeout that already includes the
        # relay's own probe; generous margin, but never unbounded
        deadline = time.monotonic() + self.probe_timeout * (
            2 + 2 * self.INDIRECT_PROBES
        )
        for f in futures:
            try:
                f.result(timeout=max(0.1, deadline - time.monotonic()))
            except FuturesTimeoutError:
                # concurrent.futures.TimeoutError only aliases the
                # builtin on 3.11+; catching the futures class works on
                # every supported Python
                continue  # verdict lands via _note_probe when it finishes

    def _probe_via_peers(self, target: Node) -> bool:
        """Ask up to INDIRECT_PROBES healthy peers to probe ``target``;
        alive if ANY confirms. Relays are chosen RANDOMLY per probe
        (like memberlist's k-random member selection) — a fixed choice
        would let one bad relay pair permanently defeat indirect
        confirmation — excluding self, the target, and already-DOWN
        nodes. With no eligible relay (2-node cluster) the direct
        verdict stands."""
        import random

        with self.mu:
            eligible = [
                n
                for n in self.nodes
                if n.id not in (self.node_id, target.id)
                and n.state != NODE_DOWN
            ]
        relays = random.sample(
            eligible, min(self.INDIRECT_PROBES, len(eligible))
        )
        for relay in relays:
            try:
                if self._probe_client.probe_indirect(relay.uri, target.uri):
                    if self.logger:
                        self.logger.printf(
                            "indirect probe: %s reached %s (direct path failed)",
                            relay.id, target.id,
                        )
                    return True
            except (ClientError, OSError):
                continue
        return False

    def _note_probe(self, node: Node, alive: bool, *, traffic: bool = False) -> None:
        """Record liveness evidence. ``traffic`` marks passive evidence
        (a message received from the node) as opposed to an active
        direct/indirect probe verdict. Passive evidence can refresh a
        READY/SUSPECT node but can NOT resurrect a DOWN one: a message
        sent while the node was still alive may land after the prober
        declared it DOWN (send/receive are not ordered with probe
        sweeps), and flipping DOWN->READY on that stale evidence would
        route queries to a dead node until the next sweep. Only a
        successful probe — evidence the node answers NOW — clears DOWN
        (memberlist similarly requires a live ack to refute death)."""
        with self.mu:
            # a concurrent ClusterStatus application rebuilds self.nodes
            # from dicts — re-resolve by id so the result lands on the
            # object the planner actually reads, not an orphaned ref
            node = next((n for n in self.nodes if n.id == node.id), node)
            if alive:
                if traffic and node.state == NODE_DOWN:
                    # verify off-thread instead: if the peer really is
                    # back (e.g. it just restarted and pushed its
                    # status), the probe success — active evidence —
                    # clears DOWN within one round-trip. One in-flight
                    # verification per node, or sustained traffic from
                    # a dead-to-us peer would queue a pool task per
                    # message and starve the probe sweeps.
                    if node.id not in self._verifying:
                        self._verifying.add(node.id)
                        self._pool.submit(self._verify_down, node)
                    return
                changed = node.state != NODE_READY
                node.state = NODE_READY
                self._fail_counts.pop(node.id, None)
            else:
                c = self._fail_counts.get(node.id, 0) + 1
                self._fail_counts[node.id] = c
                want = NODE_DOWN if c >= self.down_after else NODE_SUSPECT
                changed = node.state != want
                node.state = want
        if changed:
            if self.logger:
                self.logger.printf("node %s -> %s", node.id, node.state)
            # announce the state flip so every node's planner agrees;
            # off-thread so a query-path caller never blocks on fan-out
            if self.is_coordinator:
                threading.Thread(target=self._broadcast_status, daemon=True).start()

    def _verify_down(self, node: Node) -> None:
        """Direct probe of a DOWN node that just sent us traffic; a
        success is the active evidence required to clear DOWN."""
        try:
            self._probe_client.status(node.uri)
        except (ClientError, OSError):
            return
        finally:
            with self.mu:
                self._verifying.discard(node.id)
        self._note_probe(node, True)

    def push_node_status(self, sync: bool = False) -> None:
        """Periodic NodeStatus exchange: schema + maxShards to peers
        (the reference's gossip push/pull payload, server.go:602-630) so
        schema and shard-count drift heals without waiting for a write.
        ``sync`` (boot-time join sync) fans the per-peer pushes out
        through the pool and joins with a deadline: open() pays ~one
        probe timeout total, not peers × timeout when several are
        black-holed."""
        if self.server is None:
            return
        holder = self.server.holder
        msg = {
            "type": "node-status",
            "node_id": self.node_id,
            "schema": holder.schema(),
            "maxShards": {
                name: idx.max_shard() for name, idx in holder.indexes.items()
            },
        }
        if not sync:
            self.send_async(msg)
            return

        def push(n):
            try:
                self._probe_client.send_message(n.uri, msg)
            except (ClientError, OSError):
                pass  # down peer: its own boot push heals the reverse path

        futs = [self._pool.submit(push, n) for n in self._other_nodes()]
        deadline = time.monotonic() + self.probe_timeout * 2
        for f in futs:
            try:
                f.result(timeout=max(0.1, deadline - time.monotonic()))
            except FuturesTimeoutError:
                pass  # laggard keeps pushing in the background

    def pull_node_status(self) -> None:
        """Startup state PULL: fetch each live peer's schema + max
        shards directly (the other half of memberlist's join-time
        push/pull). A node restarted LAST would otherwise have pushed
        its state but received nobody's — its peers pushed while it was
        down — and serve local-shards-only answers until the periodic
        exchange."""
        if self.server is None:
            return
        holder = self.server.holder

        def pull(n):
            try:
                schema = self._probe_client.schema(n.uri)
                if schema:
                    holder.apply_schema(schema)
                for name, m in (self._probe_client.max_shards(n.uri) or {}).items():
                    idx = holder.index(name)
                    if idx is not None:
                        idx.set_remote_max_shard(int(m))
            except (ClientError, OSError):
                pass  # peer down: its push will heal us when it boots

        # parallel fan-out + deadlined join, like the boot-time push:
        # several black-holed peers cost ~one probe timeout, not their sum
        futs = [self._pool.submit(pull, n) for n in self._other_nodes()]
        deadline = time.monotonic() + self.probe_timeout * 2
        for f in futs:
            try:
                f.result(timeout=max(0.1, deadline - time.monotonic()))
            except FuturesTimeoutError:
                pass

    def _apply_node_status(self, msg: dict) -> None:
        self._apply_remote_holder_state(msg)
        # traffic from a node is liveness evidence — but passive: it
        # cannot clear DOWN (see _note_probe)
        sender = next((n for n in self.nodes if n.id == msg.get("node_id")), None)
        if sender is not None:
            self._note_probe(sender, True, traffic=True)

    def _apply_remote_holder_state(self, msg: dict) -> None:
        """Merge a peer's schema + maxShards into the local holder (the
        shared payload of ClusterStatus and NodeStatus messages)."""
        if self.server is None:
            return
        if msg.get("schema"):
            self.server.holder.apply_schema(msg["schema"])
        for name, m in (msg.get("maxShards") or {}).items():
            idx = self.server.holder.index(name)
            if idx is not None:
                idx.set_remote_max_shard(m)

    def receive_message(self, msg: dict) -> None:
        typ = msg.get("type")
        if typ == "cluster-status":
            self._apply_cluster_status(msg)
        elif typ == "node-status":
            self._apply_node_status(msg)
        elif typ == "node-leave":
            pass  # deliberate: no automatic removal (reference cluster.go:1629)
        elif typ in _LATER_MESSAGES:
            raise ValueError(
                f"cluster message {typ!r} is not ported to pilosa_tpu_torch "
                f"yet (ROADMAP {_LATER_MESSAGES[typ]})"
            )
        else:
            raise ValueError(f"unknown cluster message: {typ}")

    def _apply_cluster_status(self, msg: dict) -> None:
        with self.mu:
            # the whole status payload — node list, cluster state,
            # placement parameters — is authoritative only from the
            # COORDINATOR: a follower's broadcast carries its own
            # (possibly stale or misconfigured) copy, and adopting a
            # stale node list cluster-wide is an outage. A follower's
            # status still counts as liveness + schema evidence
            # (handled by the caller / _apply_remote_holder_state).
            if msg.get("fromCoordinator"):
                self.nodes = [Node.from_dict(d) for d in msg["nodes"]]
                self._sort_nodes()
                self.state = msg["state"]
                for key, attr in (
                    ("replicaN", "replica_n"),
                    ("partitionN", "partition_n"),
                ):
                    v = msg.get(key)
                    if v and v != getattr(self, attr):
                        if self.logger:
                            self.logger.printf(
                                "adopting cluster %s=%s (local config had %s)",
                                attr, v, getattr(self, attr),
                            )
                        setattr(self, attr, int(v))
            self._save_topology()
        self._apply_remote_holder_state(msg)

    def _broadcast_status(self) -> None:
        msg = self._status_message()
        self._apply_cluster_status(msg)
        self.send_async(msg)

    def _status_message(self) -> dict:
        holder = self.server.holder if self.server else None
        with self.mu:
            node_dicts = [n.to_dict() for n in self.nodes]
            state = self.state
        return {
            "type": "cluster-status",
            "state": state,
            "nodes": node_dicts,
            "schema": holder.schema() if holder else [],
            # reference NodeStatus carries MaxShards in gossip push/pull
            # (server.go:602-630)
            "maxShards": (
                {name: idx.max_shard() for name, idx in holder.indexes.items()}
                if holder
                else {}
            ),
            # placement parameters are CLUSTER-wide semantics, not
            # per-node config: a joiner with a different replicas=
            # setting would compute different shard ownership than the
            # rest of the cluster — its holder-clean then deletes
            # fragments the others think it owns (observed data loss).
            # The coordinator's values ride every status broadcast and
            # peers adopt them; fromCoordinator gates adoption so a
            # follower's own broadcast (e.g. a local abort) can never
            # overwrite the cluster's parameters with its misconfig.
            "replicaN": self.replica_n,
            "partitionN": self.partition_n,
            "fromCoordinator": self.is_coordinator,
        }

    # -- broadcaster (reference broadcast.go / server.go:520-547) ------------

    def _other_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.id != self.node_id]

    def send_sync(self, msg: dict) -> None:
        errs = []
        for n in self._other_nodes():
            try:
                self.client.send_message(n.uri, msg)
            except ClientError as e:
                errs.append(e)
        if errs:
            raise errs[0]

    def send_async(self, msg: dict, client: Optional[InternalClient] = None) -> None:
        """Best-effort broadcast (errors swallowed). Sequential on
        purpose: consecutive broadcasts keep per-peer ordering, which
        keeps ClusterStatus application monotone without sequence
        numbers. ``client`` overrides the transport (the boot-time sync
        passes the short-timeout probe client)."""
        client = client or self.client
        for n in self._other_nodes():
            try:
                client.send_message(n.uri, msg)
            except (ClientError, OSError):
                pass

    # -- placement (reference cluster.go:776-857) ----------------------------

    def partition(self, index: str, shard: int) -> int:
        return partition(index, shard, self.partition_n)

    def partition_nodes(self, partition_id: int) -> list[Node]:
        with self.mu:
            nodes = self.nodes
            n = len(nodes)
            if n == 0:
                return []
            idx = self.hasher.hash(partition_id, n)
            replica_n = min(self.replica_n, n)
            return [nodes[(idx + i) % n] for i in range(replica_n)]

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        return self.partition_nodes(self.partition(index, shard))

    def owns_shard(self, index: str, shard: int) -> bool:
        return any(n.id == self.node_id for n in self.shard_nodes(index, shard))

    def contains_shards(self, index: str, max_shard: int) -> list[int]:
        return [
            s for s in range(max_shard + 1) if self.owns_shard(index, s)
        ]

    # -- distributed map/reduce (reference mapReduce, executor.go:1444-1593) -

    def map_reduce(self, index, shards, c, opt, map_fn, reduce_fn, zero_factory=None):
        shards = list(shards or [])
        # Fresh accumulators everywhere: adopting a mapped value as the
        # accumulator would let reduce_fn mutate cached fragment rows.
        result = zero_factory() if zero_factory else None
        pending = shards
        banned_nodes: set[str] = set()
        # the pool workers don't inherit this thread's contextvars: hand
        # the active span (None when untraced) to each leg explicitly; the
        # local leg runs in a copy of this thread's context, so it keeps
        # the request's deadline and its node's launch scope (ops.cuda)
        parent = trace.current()
        while pending:
            by_node = self._shards_by_node(index, pending, banned_nodes)
            if pending and not by_node:
                raise ShardUnavailableError(f"shards unavailable: {pending}")
            next_pending: list[int] = []
            futures = []
            for node, node_shards in by_node:
                if node.id == self.node_id:
                    leg = (
                        (self._map_executor_leg, parent, index, c, node_shards, opt)
                        if self.local_executor is not None
                        else (self._map_local_leg, parent, node_shards, map_fn, reduce_fn, zero_factory)
                    )
                    futures.append(
                        (node, node_shards, self._pool.submit(contextvars.copy_context().run, *leg))
                    )
                else:
                    futures.append(
                        (node, node_shards, self._pool.submit(
                            self._map_remote_leg, parent, node, index, c,
                            node_shards, opt,
                        ))
                    )
            for node, node_shards, fut in futures:
                try:
                    v = fut.result()
                except (ClientError, ConnectionError) as e:
                    # failover: ban the node, re-map its shards onto
                    # replicas (reference mapReduce:1496-1509). Only
                    # transport-level failures feed the liveness tracker
                    # — an HTTP error or slow query proves the node is
                    # alive, just unable to serve this request.
                    banned_nodes.add(node.id)
                    metrics.count(metrics.CLUSTER_REMOTE_ERRORS, node=node.uri)
                    if getattr(e, "transport", isinstance(e, ConnectionError)):
                        self._note_probe(node, False)
                    next_pending.extend(node_shards)
                    if self.logger:
                        self.logger.printf("node %s failed, re-mapping: %s", node.id, e)
                    continue
                result = v if result is None else reduce_fn(result, v)
            pending = next_pending
        return result

    def _shards_by_node(self, index, shards, banned: set[str]) -> list:
        """Assign each shard to its first live owner (reference
        shardsByNode, executor.go:1444-1458). Nodes marked DOWN by the
        liveness prober are skipped up front — failover before the
        query pays a timeout; SUSPECT nodes stay in rotation.

        Raises ShardUnavailableError when ANY shard has no assignable
        owner — a partially-assigned plan would silently return a wrong
        aggregate as success."""
        by_id: dict[str, tuple[Node, list[int]]] = {}
        for shard in shards:
            owners = self.shard_nodes(index, shard)
            live = [n for n in owners if n.id not in banned and n.state != NODE_DOWN]
            # all owners down → try them anyway rather than failing fast
            # (the prober may be stale)
            candidates = live or [n for n in owners if n.id not in banned]
            if not candidates:
                raise ShardUnavailableError(
                    f"shard {index}/{shard} has no live owner"
                )
            node = candidates[0]
            by_id.setdefault(node.id, (node, []))[1].append(shard)
        return list(by_id.values())

    def _map_local_leg(self, parent, shards, map_fn, reduce_fn, zero_factory=None):
        if parent is None:
            return self._map_local(shards, map_fn, reduce_fn, zero_factory)
        with parent.child(metrics.STAGE_MAP_LOCAL, shards=len(shards)):
            return self._map_local(shards, map_fn, reduce_fn, zero_factory)

    def _map_local(self, shards, map_fn, reduce_fn, zero_factory=None):
        result = zero_factory() if zero_factory else None
        parent = trace.current()  # single branch per shard when untraced
        for shard in shards:
            if parent is not None:
                with parent.child(metrics.STAGE_MAP_SHARD, shard=shard):
                    v = map_fn(shard)
            else:
                v = map_fn(shard)
            result = v if result is None else reduce_fn(result, v)
        return result

    def _map_executor_leg(self, parent, index, c, shards, opt):
        """Local leg through the executor (``local_executor``, the
        reference's seam for a gang leader's local leg): this node's
        shards as a remote leg would run them, shard-batched, decoded
        like a remote leg's answer."""
        if parent is None:
            return self.local_executor(index, c, shards, opt)
        with parent.child(metrics.STAGE_MAP_LOCAL, shards=len(shards)):
            return self.local_executor(index, c, shards, opt)

    def _map_remote_leg(self, parent, node, index, c, shards, opt):
        """Remote leg wrapper: per-node fan-out RPC latency lands in
        cluster.map_remote_seconds (label node) and, when the query is
        traced, as a cluster.map_remote span."""
        t0 = time.monotonic()
        try:
            if parent is None:
                return self._map_remote(node, index, c, shards, opt)
            with parent.child(
                metrics.STAGE_MAP_REMOTE, node=node.uri, shards=len(shards)
            ):
                return self._map_remote(node, index, c, shards, opt)
        finally:
            metrics.observe(
                metrics.CLUSTER_MAP_REMOTE_SECONDS,
                time.monotonic() - t0,
                node=node.uri,
            )

    def _map_remote(self, node, index, c, shards, opt):
        """Remote leg: ship the call string; decode the single result
        (reference remoteExec, executor.go:1393-1440). The current
        trace context rides the RPC as a traceparent header — inside a
        traced query this runs under the cluster.map_remote child span,
        so the remote process's spans graft back exactly there."""
        results = self.client.query_node(
            node.uri,
            index,
            str(c),
            shards=shards,
            remote=True,
            trace_ctx=trace.current_ctx(),
            cache=opt.cache,
        )
        if not results:
            return None
        return self._decode_remote(c, results[0])

    @staticmethod
    def _decode_remote(c, raw):
        """Map the JSON wire shape back to executor result types."""
        from pilosa_tpu_torch.core import Row
        from pilosa_tpu_torch.executor import ValCount

        if isinstance(raw, dict):
            if "columns" in raw or "keys" in raw or "attrs" in raw:
                return Row(*raw.get("columns", []))
            if "value" in raw and "count" in raw:
                return ValCount(raw["value"], raw["count"])
        if c.name == "GroupBy":
            # un-finalized wire group list ([{group, count[, sum]}, ...]);
            # the coordinator merges legs then ranks/limits once
            return list(raw) if isinstance(raw, list) else raw
        if c.name == "Distinct":
            return [int(v) for v in raw] if isinstance(raw, list) else raw
        if isinstance(raw, list):
            return pairs_to_tuples(raw)
        return raw

    # -- write fan-out (reference executeSetBit/executeClearBit) -------------

    def set_bit(self, index, c, field, row_id, col_id, timestamp, opt) -> bool:
        return self._write_bit(
            index, c, field, row_id, col_id, opt, lambda: field.set_bit(row_id, col_id, timestamp)
        )

    def clear_bit(self, index, c, field, row_id, col_id, opt) -> bool:
        return self._write_bit(
            index, c, field, row_id, col_id, opt, lambda: field.clear_bit(row_id, col_id)
        )

    def _write_bit(self, index, c, field, row_id, col_id, opt, local_fn) -> bool:
        from pilosa_tpu_torch import SHARD_WIDTH

        shard = col_id // SHARD_WIDTH
        ret = False
        for node in self.shard_nodes(index, shard):
            if node.id == self.node_id:
                # the local apply: the heat write hook fires here,
                # mirroring the executor's local-apply leg
                heat.record_write(index, getattr(field, "name", ""), shard, 1)
                if local_fn():
                    ret = True
            elif not opt.remote:
                res = self.client.query_node(
                    node.uri,
                    index,
                    str(c),
                    shards=None,
                    remote=True,
                    trace_ctx=trace.current_ctx(),
                )
                if res and res[0] is True:
                    ret = True
        return ret

    def forward_to_all(self, index, c, opt) -> None:
        """SetValue/attrs replicate to every node (reference
        executeSetValue remote fan-out)."""
        if opt.remote:
            return
        for node in self._other_nodes():
            self.client.query_node(
                node.uri,
                index,
                str(c),
                shards=None,
                remote=True,
                trace_ctx=trace.current_ctx(),
            )
