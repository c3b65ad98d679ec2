"""Query executor (L4) — lowers PQL call trees onto shard kernels.

The port of ``pilosa_tpu/executor/executor.py``: its single-node legs.
Mirrors the reference's executor (reference executor.go): top-level
dispatch by call name, per-shard leaf functions, cross-shard map/reduce.
Two execution paths per shard:

  * CPU    — roaring Row algebra (the correctness oracle, always available)
  * device — packed-word PyTorch ops and the hand-written CUDA kernels
             over staged fragment state: bitmap subtrees fold
             elementwise, Count(chain) runs the fused tree count, TopN
             scores every candidate chunk in one launch (dense or
             block-sparse) and replays the reference's ranked walk, BSI
             Range runs the range kernel, and Sum and GroupBy run the
             GroupBy segmented reduction.

Every device leg asks the stager for its tensors on each call and never
holds one across calls. A write (``Set``, ``Clear``, ``SetValue``) bumps
its fragment's generation; the next read of a staged entry replays the
fragment's delta log onto it as one word-delta scatter (a new tensor)
instead of restaging it, and a stager with tiered staging on builds
cold rows from container payloads, expanded on the device when they are
compact enough (executor/stager.py).

Both paths are bit-identical; ``device_policy`` picks ("never" | "auto"
| "always"). The device path runs on ``device`` — ``cuda`` unless the
caller asks for ``"cpu"``, where the same legs run the kernels' plain
versions (the tests do). Without CUDA and without an explicit device
the constructor raises; it never quietly runs on the CPU.

Serving executors pass the device health gate (``health``, executor/
devicehealth.py) and the HBM governor (``governor``, executor/hbm.py):
read calls then run under the gate, an allocation failure relieves the
governor's tiers and retries once before the call degrades to the CPU
leg, and a tripped gate or the post-degrade cooldown routes every read
to the CPU leg until the device answers again. Writes skip the guard.

A multi-call read (or a lone analytic call) goes through whole-query
fusion first (executor/fusion.py, on by default as in the reference):
its fusable calls lower to kernels enqueued back to back with one fetch,
and the rest take the per-call legs. With a plan cache (plan/cache.py)
whole-call results are cached against fragment generations, and the
planner (plan/planner.py) substitutes cached or repeated bitmap subtrees
with ``__cached`` placeholders, whose stacks a device plan cache keeps
on the card.

Attributes and keys (translate/, utils/attrstore.py): with a translate
store, string keys resolve to ids before the planner canonicalizes a
query (writes mint, reads only look up) and results translate back;
``SetRowAttrs``/``SetColumnAttrs`` write the attribute stores, a
top-level ``Row()`` carries its row's attributes, and a TopN attribute
filter narrows each shard's candidate rows before they are scored, so
the rows that pass are scored on the device path like any other. The
cluster, mesh and dispatch engine of the JAX executor are not here (A6,
A8).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Optional

import numpy as np
import torch

from pilosa_tpu_torch import SHARD_WIDTH, ops
from pilosa_tpu_torch.core import Row, TopOptions, VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD
from pilosa_tpu_torch.core.cache import pairs_arrays as cache_pairs_arrays
from pilosa_tpu_torch.core.cache import sort_pairs
from pilosa_tpu_torch.core.fragment import DEFAULT_MIN_THRESHOLD, FragmentQuarantinedError
from pilosa_tpu_torch.core.timequantum import TIME_FORMAT, views_by_time_range
from pilosa_tpu_torch.executor import analytics
from pilosa_tpu_torch.executor.batcher import BatchedScorer
from pilosa_tpu_torch.executor.devicehealth import DeviceDown
from pilosa_tpu_torch.executor.hbm import (
    DeviceOom,
    HbmGovernor,
    OomRecovery,
    classify_device_error,
)
from pilosa_tpu_torch.executor.stager import DeviceStager
from pilosa_tpu_torch.pql import BETWEEN, NEQ, Call, Condition, parse
from pilosa_tpu_torch.plan.canon import CACHED_CALL
from pilosa_tpu_torch.pql.ast import WRITE_CALLS
from pilosa_tpu_torch.roaring import Bitmap
from pilosa_tpu_torch.utils import chaos, heat, metrics, trace
from pilosa_tpu_torch.utils.errors import NotFoundError

_W32 = SHARD_WIDTH // 32

# Minimum touched containers across a query's fragments before "auto"
# picks the device path (tiny fragments are faster in roaring on host).
AUTO_DEVICE_MIN_CONTAINERS = 64
# post-OOM-degrade cooldown: after a device call degrades to CPU, the
# device predicates stay CPU-forced this long so the immediate re-run
# (and the next queries) don't launch straight back into the same OOM
OOM_CPU_COOLDOWN_S = 30.0
# Widest coalesced launch of the stacked TopN and chain-count scorers.
MAX_BATCH = 32
# The device plan cache's budget when the caller names none (the
# reference's bare-executor default; the server passes its own knob).
DEVICE_CACHE_BYTES = 256 << 20

_deadline_mod = None


def _deadline():
    """The request-deadline module (server/deadline.py), imported on
    first use: the server package imports the executor."""
    global _deadline_mod
    if _deadline_mod is None:
        from pilosa_tpu_torch.server import deadline as _m

        _deadline_mod = _m
    return _deadline_mod


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda`` — and an error when CUDA is asked for (or nothing is) and
    absent, never a silent CPU."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


@dataclass
class ValCount:
    """reference executor.go:1762."""

    val: int = 0
    count: int = 0

    def add(self, other: "ValCount") -> "ValCount":
        return ValCount(self.val + other.val, self.count + other.count)

    def smaller(self, other: "ValCount") -> "ValCount":
        if self.count == 0 or (other.val < self.val and other.count > 0):
            return other
        return ValCount(self.val, self.count)

    def larger(self, other: "ValCount") -> "ValCount":
        if self.count == 0 or (other.val > self.val and other.count > 0):
            return other
        return ValCount(self.val, self.count)


def pairs_add(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge id/count pair lists, summing counts (reference Pairs.Add)."""
    m = dict(a)
    for id_, cnt in b:
        m[id_] = m.get(id_, 0) + cnt
    return list(m.items())


@dataclass
class ExecOptions:
    """reference execOptions (executor.go:1714). ``cache`` = False
    bypasses the plan result cache (lookups, inserts and the CSE
    rewrite). ``remote`` is carried for the HTTP API; the port has no
    cluster yet (ROADMAP A8), so it changes nothing."""

    remote: bool = False
    exclude_row_attrs: bool = False
    exclude_columns: bool = False
    # plan result cache participation (the `cache=false` query option)
    cache: bool = True
    # run a multi-call query's calls serially instead of through the
    # read pool
    serial: bool = False


class _NotDeviceable(Exception):
    """Raised when a call subtree can't run on the device path."""


class _ScoreCarry:
    """Cross-pass TopN score carry: pass 1's chunk scores, appended as
    whole arrays and resolved at pass-2 seed time, so pass 2 usually
    needs no device launch at all (the winners' counts were scored in
    pass 1 against the same source and fragment snapshot)."""

    __slots__ = ("_by_shard", "_n")

    def __init__(self) -> None:
        # shard -> [(ids, scores), ...]: seed() is called once per shard
        self._by_shard: dict[int, list] = {}
        self._n = 0

    def __len__(self) -> int:  # `if carry:` seeds only when non-empty
        return self._n

    def add(self, shard: int, ids, scores) -> None:
        # scores may be pow2- or chunk-size-padded past len(ids): slice
        if len(ids):
            self._by_shard.setdefault(shard, []).append((ids, scores[: len(ids)]))
            self._n += 1

    def add_stacked(self, shards, ids_by_shard, mat) -> None:
        for i, ids in enumerate(ids_by_shard):
            if ids:
                self._by_shard.setdefault(shards[i], []).append(
                    (ids, mat[i][: len(ids)])
                )
                self._n += 1

    def seed(self, shard: int, rids) -> dict[int, int]:
        """{rid: score} for the requested ids present in this carry.
        Chunks are disjoint id ranges per shard (prefix walks), so no
        overwrite ambiguity."""
        chunks = self._by_shard.get(shard)
        if not chunks or not rids:
            return {}
        lut: dict[int, object] = {}
        for ids, scores in chunks:
            sc = scores.tolist() if hasattr(scores, "tolist") else scores
            lut.update(zip(ids, sc))
        return {rid: int(lut[rid]) for rid in rids if rid in lut}


def _make_chain_scorer(ex: "Executor") -> BatchedScorer:
    """Coalescing scorer for fused Count(chain) launches: concurrent
    same-shape chains (identical tree + leaf shapes — the key) run as
    ONE batched tree-count launch, i32[Q] counts back; a lone chain
    launches at Q = 1. Pads with a repeat of a real source; pad lanes'
    counts are never read. On an H100, 8 concurrent clients ran
    3-13 % more chains per second coalesced than with one launch per
    query (chain_batch_probe.py)."""
    return BatchedScorer(
        max_batch=MAX_BATCH,
        single_fn=ex._chain_count_single,
        batch_fn=ex._chain_count_batch,
        pad_fn=lambda proto: proto,
    )


def _make_stacked_scorer() -> BatchedScorer:
    """Coalescing scorer for the cross-shard stacked-sparse TopN path;
    num_rows rides in the staged bundle, and so does its grouping."""
    return BatchedScorer(
        max_batch=MAX_BATCH,
        single_fn=lambda src, st: ops.sparse_intersection_counts_stacked(src, *st, groups=st.groups),
        batch_fn=lambda srcs, st: ops.sparse_intersection_counts_stacked_batch_list(
            srcs, *st, groups=st.groups
        ),
    )


def _fence(out) -> None:
    """Wait for the device work producing ``out`` (a tensor, or a tuple
    of them): the stream's own sync, not a whole-device one."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            return


def _timed_kernel(kind: str, fn, recovery=None):
    """Wrap a kernel call so every launch is observed as
    spmd.execute_seconds and lands as a spmd.kernel span when the caller
    is traced (the port compiles nothing per shape, so there is no
    first-launch compile to split off). The fence pins the measurement
    to device completion, so the time feeds the waterfall as
    device.compute.

    With ``recovery`` (an executor's OomRecovery) the launch and its
    fence are the OOM-recovery boundary: an allocation failure evicts
    through the HBM governor and retries once before the call degrades
    to the CPU leg (``DeviceOom``). The chaos hook (utils/chaos.py) fires
    inside that attempt, so a retry re-consults the injection counter;
    a wrapper without recovery (the analytic kernels, which the
    reference launches bare) has no hook, as there."""

    def attempt(*args, **kw):
        cf = chaos.FAULTS
        if cf is not None and recovery is not None:
            cf.on_kernel(kind)
        out = fn(*args, **kw)
        _fence(out)
        return out

    def run(*args, **kw):
        t0 = time.monotonic()
        if recovery is not None:
            out = recovery.run(lambda: attempt(*args, **kw), kind=kind)
        else:
            out = attempt(*args, **kw)
        dt = time.monotonic() - t0
        metrics.observe(metrics.SPMD_EXECUTE_SECONDS, dt, kind=kind)
        trace.attrib_add(trace.WF_DEVICE_COMPUTE, dt)
        sp = trace.current()
        if sp is not None:
            sp.record(metrics.STAGE_SPMD_KERNEL, t0, dt, kind=kind)
        return out

    return run


_timed_groupby = _timed_kernel("groupby_reduce", ops.groupby_reduce)
_timed_plane_counts = _timed_kernel("groupby_reduce", ops.bsi_plane_counts)
_timed_plane_counts_batched = _timed_kernel("groupby_reduce", ops.bsi_plane_counts_batched)
_timed_bsi_min = _timed_kernel("bsi_min", ops.bsi_min)
_timed_bsi_max = _timed_kernel("bsi_max", ops.bsi_max)
_timed_minmax_batched = _timed_kernel("bsi_minmax", ops.bsi_minmax_batched)
_timed_percentile = _timed_kernel("bsi_percentile", ops.bsi_percentile_batched)
_timed_distinct = _timed_kernel("bsi_distinct", ops.bsi_distinct_presence)


def _fetch_bits(bits: torch.Tensor, count: torch.Tensor) -> tuple[int, int]:
    """(value, count) from a recurrence's device (bits bool[D], count)
    in one transfer: bit i of the value is bits[i]."""
    got = _fetch(torch.cat([count.reshape(1).to(torch.int64), bits.to(torch.int64)]))
    return sum(1 << i for i, b in enumerate(got[1:].tolist()) if b), int(got[0])


def _sum_from_counts(counts: np.ndarray, depth: int, base: int) -> "ValCount":
    """Σ counts[i] << i in Python ints (counts[depth] is the not-null
    count), offset by the field's minimum per value."""
    vsum = sum(int(counts[i]) << i for i in range(depth))
    vcount = int(counts[depth])
    if vcount == 0:
        return ValCount()
    return ValCount(vsum + vcount * base, vcount)


def _fetch(arr) -> np.ndarray:
    """Materialize a device result on host, crediting the D2H
    transfer+decode waterfall leg when attribution is active."""
    t0 = time.monotonic() if trace.attrib_current() is not None else None
    if isinstance(arr, torch.Tensor):
        out = arr.cpu().numpy()
    else:
        out = np.asarray(arr)
    if t0 is not None:
        trace.attrib_add(trace.WF_TRANSFER_DECODE, time.monotonic() - t0)
    return out


class Executor:
    def __init__(
        self,
        holder,
        device=None,
        stager: Optional[DeviceStager] = None,
        device_policy: str = "auto",
        max_writes_per_request: int = 5000,
        health=None,
        governor: Optional[HbmGovernor] = None,
        analytics_max_groups: Optional[int] = None,
        translate_store=None,
        auto_min_containers: Optional[int] = None,
        plan_cache=None,
        fusion_enabled: bool = True,
        fusion_max_calls: int = 64,
        plan_cache_device_bytes: int = DEVICE_CACHE_BYTES,
    ) -> None:
        self.holder = holder
        # key <-> id translation (translate/); None: ids only
        self.translate_store = translate_store
        self.device = resolve_device(device)
        self.stager = stager or DeviceStager(self.device)
        if self.stager.device != self.device:
            raise ValueError(
                f"stager stages on {self.stager.device}, executor runs on {self.device}"
            )
        if device_policy not in ("never", "auto", "always"):
            raise ValueError(f"unknown device_policy: {device_policy!r}")
        self.device_policy = device_policy
        self.max_writes_per_request = max_writes_per_request
        # GroupBy cross products past this many groups fail before staging
        self.analytics_max_groups = (
            int(analytics_max_groups)
            if analytics_max_groups is not None
            else analytics.DEFAULT_MAX_GROUPS
        )
        # the auto policy's crossover, in estimated touched containers;
        # the server passes its auto-device-min-containers knob
        self.auto_min_containers = (
            int(auto_min_containers)
            if auto_min_containers is not None
            else AUTO_DEVICE_MIN_CONTAINERS
        )
        # coalesces concurrent TopN scoring against the same staged
        # matrix into one batched kernel launch (see batcher.py)
        self.scorer = BatchedScorer()
        # concurrent cross-shard TopN queries sharing a staged candidate
        # chunk coalesce into one stacked kernel launch
        self.stacked_scorer = _make_stacked_scorer()
        self.chain_scorer = _make_chain_scorer(self)
        # tree-count programs keyed by tree structure (bounded by
        # distinct query shapes)
        self._tree_progs: dict[str, ops.TreeProgram] = {}
        self._tree_mu = threading.Lock()
        self._read_pool = None  # lazy; see _execute_calls()
        self._read_pool_mu = threading.Lock()
        # checkouts of the read pool, so close() can drain them; once
        # closing, checkouts get None (their calls run serially inline)
        self._read_pool_cv = threading.Condition(self._read_pool_mu)
        self._read_pool_users = 0
        self._read_pool_closing = False
        # optional device health gate (executor/devicehealth.py):
        # serving executors pass one so a wedged card degrades reads to
        # the CPU roaring path instead of hanging them; bare executors
        # (tests, benches) skip the per-call guard hop
        self.health = health
        if health is not None:
            health.on_restore = self._on_device_restore
        # one HBM byte ledger for every device-resident tenant
        # (executor/hbm.py): the stager's entries and the batchers' pad
        # zeros; the stager's budget becomes its share
        self.governor = governor if governor is not None else HbmGovernor()
        self.stager.set_governor(self.governor)
        for sc in (self.scorer, self.stacked_scorer, self.chain_scorer):
            sc.set_governor(self.governor)
        # OOM recovery policy at the device-call boundaries: evict ->
        # retry once -> degrade this call to the CPU leg; the health
        # gate trips only on repeat unrecovered failures
        self._oom_cpu_until = 0.0
        self.oom_cpu_cooldown_s = float(
            os.environ.get("PILOSA_OOM_CPU_COOLDOWN_S", OOM_CPU_COOLDOWN_S)
        )
        self._oom = OomRecovery(
            governor=self.governor,
            health=self.health,
            on_degrade=self._on_oom_degrade,
        )
        self._timed_tree_count = _timed_kernel("tree_count", ops.tree_count, recovery=self._oom)
        # generation-stamped result cache (plan/cache.py); None = off,
        # the default for bare executors (the server passes one)
        self.plan_cache = plan_cache
        # whole-query fusion (executor/fusion.py): the fusable calls of a
        # multi-call read enqueue back to back and come back in one fetch
        if fusion_enabled:
            from pilosa_tpu_torch.executor.fusion import QueryFuser

            self.fuser = QueryFuser(self, max_calls=fusion_max_calls)
        else:
            self.fuser = None
        # device-resident plan cache: __cached subtree stacks stay on the
        # card instead of being packed and uploaded again; 0 disables it
        if plan_cache_device_bytes > 0 and plan_cache is not None:
            from pilosa_tpu_torch.plan.cache import DevicePlanCache

            self.device_cache = DevicePlanCache(plan_cache_device_bytes)
            self.device_cache.set_governor(self.governor)
        else:
            self.device_cache = None

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    # -- entry point (reference Execute, executor.go:83) ---------------------

    # check: disable=dispatch-bypass (the port has no dispatch engine yet: ROADMAP A6)
    def execute(
        self,
        index_name: str,
        query,
        shards: Optional[list[int]] = None,
        opt: Optional[ExecOptions] = None,
    ) -> list[Any]:
        sp = trace.current()
        if sp is None:  # untraced: no span objects anywhere below
            return self._execute(index_name, query, shards, opt)
        with sp.child(metrics.STAGE_EXECUTOR, index=index_name):
            return self._execute(index_name, query, shards, opt)

    def _execute(
        self,
        index_name: str,
        query,
        shards: Optional[list[int]] = None,
        opt: Optional[ExecOptions] = None,
    ) -> list[Any]:
        if isinstance(query, str):
            query = parse(query)
        opt = opt or ExecOptions()
        # deadline boundary: a request whose deadline passed while it
        # crossed the API layer is cancelled before any shard work
        dl = _deadline().current()
        if dl is not None:
            dl.check(metrics.STAGE_EXECUTOR)
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        if (
            self.max_writes_per_request
            and query.write_call_n() > self.max_writes_per_request
        ):
            raise ValueError(
                f"too many writes: {query.write_call_n()} > {self.max_writes_per_request}"
            )
        if shards is None and self._needs_shards(query.calls):
            shards = list(range(idx.max_shard() + 1))
        translate = self.translate_store is not None and not opt.remote
        if translate:
            # keys -> ids BEFORE canonicalization (plan/planner.py): CSE
            # hashes and plan-cache keys see resolved integer ids only
            from pilosa_tpu_torch.plan import planner

            planner.resolve_keys(self, index_name, idx, query.calls)
        calls = query.calls
        reads_only = query.write_call_n() == 0
        if self.plan_cache is not None and opt.cache and self._local_batchable(opt) and shards and reads_only:
            # CSE against the result cache (plan/planner.py): bitmap
            # subtrees repeated across this query's calls (a pipeline-
            # combined query may hold many requests) build once, and
            # subtrees already cached feed in as materialized rows
            from pilosa_tpu_torch.plan import planner

            t0_cse = time.monotonic()
            with trace.child(metrics.STAGE_PLAN_CANON):
                calls = planner.rewrite_for_cse(self, index_name, calls, shards, opt)
            trace.attrib_add(trace.WF_PLAN_CANON, time.monotonic() - t0_cse)
        # whole-query fusion: the fuser serves the calls it can lower (or
        # finds cached); the rest run per call below and the results
        # merge by position. A lone analytic call is itself a K-way panel
        fused: dict[int, Any] = {}
        if (
            self.fuser is not None
            and (len(calls) > 1 or any(c.name in analytics.ANALYTIC_CALLS for c in calls))
            and reads_only
            and not opt.serial
            and shards
        ):
            fused = self.fuser.try_execute(index_name, calls, shards, opt) or {}
        rest = [c for i, c in enumerate(calls) if i not in fused]
        results = self._execute_calls(index_name, rest, shards, opt, dl, reads_only)
        if fused:
            it = iter(results)
            results = [fused[i] if i in fused else next(it) for i in range(len(calls))]
        if translate:
            from pilosa_tpu_torch.translate import resolve

            results = [
                resolve.translate_result(self.translate_store, index_name, idx, call, r)
                for call, r in zip(calls, results)
            ]
        return results

    def _execute_calls(self, index_name, calls, shards, opt, dl, reads_only: bool) -> list[Any]:
        if len(calls) > 1 and reads_only and not opt.serial:
            # an all-read request has no cross-call ordering constraints;
            # running the calls concurrently lets the BatchedScorer
            # coalesce their TopN scoring into batched kernel launches
            parent = trace.current()  # contextvars don't follow pool workers
            attrib = trace.attrib_current()  # nor does the waterfall
            pdl = dl  # nor the request deadline

            def run_call(call):
                with trace.activate(parent), _deadline().activate(pdl), trace.attrib_activate(attrib):
                    return self._execute_call(index_name, call, shards, opt)

            pool = self._read_pool_acquire()
            if pool is None:
                # close() has begun: run serially inline rather than
                # submit to a pool that is shutting down
                return [run_call(c) for c in calls]
            try:
                return list(pool.map(run_call, calls))
            finally:
                self._read_pool_release()
        return [self._execute_call(index_name, call, shards, opt) for call in calls]

    def _read_pool_acquire(self):
        """Check out the shared read pool (built lazily), or None once
        close() has begun. The count of checkouts lets close() drain the
        ``pool.map`` users before it shuts the pool down, and nothing
        builds a pool after close()."""
        with self._read_pool_cv:
            if self._read_pool_closing:
                return None
            if self._read_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._read_pool = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="pql-read"
                )
            self._read_pool_users += 1
            return self._read_pool

    def _read_pool_release(self) -> None:
        with self._read_pool_cv:
            self._read_pool_users -= 1
            if self._read_pool_users == 0:
                self._read_pool_cv.notify_all()

    @staticmethod
    def _needs_shards(calls: list[Call]) -> bool:
        for c in calls:
            if c.name not in ("Clear", "Set", "SetRowAttrs", "SetColumnAttrs", "SetValue"):
                return True
        return False

    # -- dispatch (reference executeCall, executor.go:165) -------------------

    def _cpu_forced(self) -> bool:
        """True while the device gate is tripped, or while the
        post-OOM-degrade cooldown runs under the ``auto`` policy.
        Checked by the device predicates, so it applies on EVERY thread
        without per-thread state. Only a serving executor (one with a
        health gate) ever moves reads to the CPU: a bare executor's
        device errors propagate to its caller, and ``always`` keeps
        every read on the device until the gate trips."""
        if self.health is None:
            return False
        if not self.health.healthy:
            return True
        return self.device_policy != "always" and time.monotonic() < self._oom_cpu_until

    def _on_oom_degrade(self) -> None:
        """A device call degraded to CPU after failed OOM recovery:
        force the CPU predicates for a cooldown so the immediate re-run
        (and the next queries) don't launch straight back into the OOM."""
        self._oom_cpu_until = time.monotonic() + self.oom_cpu_cooldown_s

    def _on_device_restore(self) -> None:
        """Replace machinery whose locks abandoned guard workers may
        hold forever (a batch leader hung inside a dead launch keeps its
        scorer's lock; a hung upload keeps the stager's). Fresh
        instances start clean, and results and tensors the wedged card
        produced leave both plan caches. A context lost to a sticky CUDA
        error never gets here: its probe keeps failing, so the gate
        stays tripped and reads stay on the CPU leg."""
        self.scorer = BatchedScorer()
        self.stacked_scorer = _make_stacked_scorer()
        self.chain_scorer = _make_chain_scorer(self)
        # the ledger forgets the old scorers' pad zeros with them
        self.governor.reset("batcher")
        for sc in (self.scorer, self.stacked_scorer, self.chain_scorer):
            sc.set_governor(self.governor)
        self._oom_cpu_until = 0.0
        self.stager.reset_after_wedge()
        if self.plan_cache is not None:
            self.plan_cache.epoch_reset()
        if self.device_cache is not None:
            self.device_cache.epoch_reset()

    def _execute_call(self, index, c: Call, shards, opt) -> Any:
        metrics.count(metrics.EXECUTOR_CALLS, call=c.name)
        sp = trace.current()
        if sp is None:
            return self._execute_call_cached(index, c, shards, opt)
        with sp.child(metrics.STAGE_CALL, call=c.name):
            return self._execute_call_cached(index, c, shards, opt)

    def _local_batchable(self, opt) -> bool:
        """Whether this call's legs all run here, so the plan cache, the
        CSE rewrite and the shard-batched legs may serve it. Always, on
        one node; the multi-device plane (ROADMAP A8) makes it depend on
        ``opt.remote``, as in the reference."""
        return True

    def _execute_call_cached(self, index, c: Call, shards, opt) -> Any:
        """Whole-call result cache around dispatch (plan/cache.py): a
        generation-valid entry answers without touching the executor; a
        miss executes under singleflight and stamps the entry with the
        generation vector read before the build. Writes and uncacheable
        calls (malformed arguments, attribute reads) go straight
        through."""
        pc = self.plan_cache
        if pc is None or not opt.cache or not self._local_batchable(opt) or shards is None or c.name in WRITE_CALLS:
            return self._execute_call_guarded(index, c, shards, opt)
        from pilosa_tpu_torch.plan import planner

        keyinfo = planner.call_cache_key(self, index, c, shards, opt)
        if keyinfo is None:
            return self._execute_call_guarded(index, c, shards, opt)
        key, genvec_fn = keyinfo
        return pc.get_or_build(key, genvec_fn, lambda: self._execute_call_guarded(index, c, shards, opt))

    def _execute_call_guarded(self, index, c: Call, shards, opt) -> Any:
        """Read calls run under the device health gate when one is
        configured: a wedged card trips the gate and the same call
        re-runs on the CPU roaring path (reads are pure, so safe to
        re-run; the gate state itself forces the CPU predicates, so the
        re-run is device-free on every thread). Writes never touch the
        device and skip the guard. Every read served on the CPU leg
        because the device is gated off or cooling down after an OOM is
        counted (``executor.device_down_fallback``).

        A bare executor (no health gate) has no fallback: its device
        errors reach the caller. So do the port's own launch failures
        (``ops.cuda.LaunchError``: a kernel refused its arguments), and
        a degraded call under ``always``, which nothing moves off the
        device.

        The guard's pool threads select no stream or device: every
        launch, from them, the read pool and the batchers alike, goes
        to the default stream of the device the tensors live on."""
        if self.health is None or c.name in WRITE_CALLS or self.device_policy == "never":
            # a bare executor, a write (writes never touch the device)
            # or the CPU policy: no guard, no fallback
            return self._execute_call_inner(index, c, shards, opt)
        if self._cpu_forced():
            metrics.count(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK)
            return self._execute_call_inner(index, c, shards, opt)
        try:
            # the guard pool is another thread: hand the span over
            parent = trace.current()
            attrib = trace.attrib_current()
            dl = _deadline().current()
            return self.health.guard(
                lambda: self._execute_call_inner_on(parent, attrib, dl, index, c, shards, opt)
            )
        except DeviceOom:
            # an unrecovered OOM degraded this call: the OOM cooldown
            # forces the CPU predicates, unless the policy is "always"
            if not self._cpu_forced():
                raise
        except DeviceDown:
            # gate closed (the CPU predicates are forced), or a guard
            # pool saturated on a live device (this call re-runs here,
            # outside the guard)
            pass
        except Exception as e:
            # a raw device fault that escaped the kernel boundaries
            # (e.g. surfaced at a staging upload or a batcher fetch):
            # apply the same recovery policy here — classify, journal,
            # evict, set the CPU cooldown — then serve from the CPU leg
            if classify_device_error(e) is None:
                raise

            def _reraise():
                raise e

            try:
                self._oom.run(_reraise, kind="call")
            except DeviceOom:
                if not self._cpu_forced():
                    raise
        metrics.count(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK)
        return self._execute_call_inner(index, c, shards, opt)

    def _execute_call_inner_on(self, parent, attrib, dl, index, c, shards, opt) -> Any:
        with trace.activate(parent), trace.attrib_activate(attrib), _deadline().activate(dl):
            return self._execute_call_inner(index, c, shards, opt)

    def _execute_call_inner(self, index, c: Call, shards, opt) -> Any:
        name = c.name
        if name == "Sum":
            return self._execute_sum(index, c, shards, opt)
        if name == "Min":
            return self._execute_minmax(index, c, shards, opt, is_min=True)
        if name == "Max":
            return self._execute_minmax(index, c, shards, opt, is_min=False)
        if name == "Clear":
            return self._execute_clear_bit(index, c)
        if name == "Count":
            return self._execute_count(index, c, shards, opt)
        if name == "Set":
            return self._execute_set_bit(index, c)
        if name == "SetValue":
            self._execute_set_value(index, c)
            return None
        if name == "SetRowAttrs":
            self._execute_set_row_attrs(index, c)
            return None
        if name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c)
            return None
        if name == "TopN":
            return self._execute_topn(index, c, shards, opt)
        if name == "GroupBy":
            return self._execute_groupby(index, c, shards, opt)
        if name == "Distinct":
            return self._execute_distinct(index, c, shards, opt)
        if name == "Percentile":
            return self._execute_percentile(index, c, shards, opt)
        if name == "Rows":
            raise ValueError("Rows() can only be used inside GroupBy()")
        return self._execute_bitmap_call(index, c, shards, opt)

    # -- map/reduce seam -----------------------------------------------------

    def _map_reduce(self, index, shards, c, opt, map_fn, reduce_fn, zero_factory=None):
        """Single-node: loop shards in order (deterministic reduce order).

        zero_factory builds a FRESH accumulator: reduce_fn may mutate its
        first argument (Row.merge), and mapped values can be cached
        fragment rows that must never be mutated."""
        result = zero_factory() if zero_factory else None
        parent = trace.current()
        # one contextvar read, then a monotonic compare per shard: expired
        # work stops at the next shard boundary
        dl = _deadline().current()
        attrib = trace.attrib_current()
        if heat.LEDGER.enabled:
            _heat_read = heat.LEDGER.record_read
            try:
                _heat_field = c.field_arg()
            except (ValueError, AttributeError):
                _heat_field = ""
        else:
            _heat_read = None
            _heat_field = ""
        for shard in shards:
            if dl is not None:
                dl.check(metrics.STAGE_MAP_SHARD)
            if _heat_read is not None:
                _heat_read(index, _heat_field, shard)
            if parent is not None:
                with parent.child(metrics.STAGE_MAP_SHARD, shard=shard):
                    v = map_fn(shard)
            else:
                v = map_fn(shard)
            if result is None:
                result = v
            elif attrib is None:
                result = reduce_fn(result, v)
            else:
                t0r = time.monotonic()
                result = reduce_fn(result, v)
                attrib[trace.WF_REDUCE] = attrib.get(trace.WF_REDUCE, 0.0) + (
                    time.monotonic() - t0r
                )
        return result

    def _heat_read_legs(self, index, c, shards) -> None:
        """Shard-batched device launches bypass ``_map_reduce``'s
        per-shard loop, so their read legs land here."""
        if not heat.LEDGER.enabled or not shards:
            return
        try:
            field = c.field_arg()
        except (ValueError, AttributeError):
            field = ""
        rec = heat.LEDGER.record_read
        for s in shards:
            rec(index, field, s)

    def _analytics_heat_legs(self, index, fields, shards) -> None:
        """Analytic launches bypass ``_map_reduce``'s per-shard loop AND
        touch several fields per launch (dimension rows + aggregate
        planes), so their legs record here: one read per (field, shard)."""
        if not heat.LEDGER.enabled or not shards:
            return
        rec = heat.LEDGER.record_read
        for f in fields:
            for s in shards:
                rec(index, f, s)

    # -- bitmap calls ---------------------------------------------------------

    def _execute_bitmap_call(self, index, c: Call, shards, opt) -> Row:
        def map_fn(shard):
            return self._bitmap_call_shard(index, c, shard)

        def reduce_fn(prev: Row, v: Row) -> Row:
            prev.merge(v)
            return prev

        other = self._map_reduce(index, shards, c, opt, map_fn, reduce_fn, zero_factory=Row)
        # a top-level Row() carries its row's attributes (reference
        # executeBitmapCall, executor.go:338-385)
        if c.name == "Row" and not opt.exclude_row_attrs:
            field_name = c.field_arg()
            fld = self.holder.field(index, field_name)
            if fld is not None and fld.row_attr_store is not None:
                row_id, ok = c.uint_arg(field_name)
                if ok:
                    other.attrs = fld.row_attr_store.attrs(row_id) or {}
        return other

    def _bitmap_call_shard(self, index, c: Call, shard: int) -> Row:
        """reference executeBitmapCallShard (executor.go:388-405)."""
        if self._use_device(index, c, shard):
            try:
                words = self._device_bitmap(index, c, shard)
                return _row_from_device(words, shard)
            except _NotDeviceable:
                pass
        return self._bitmap_call_shard_cpu(index, c, shard)

    def _bitmap_call_shard_cpu(self, index, c: Call, shard: int) -> Row:
        name = c.name
        if name == CACHED_CALL:
            # a planner-substituted subtree (plan/planner.py): its
            # materialized per-shard rows are the result
            seg = c.args["_row"].shard_segment(shard)
            return Row() if seg is None else Row.from_segment(shard, seg)
        if name == "Row":
            return self._row_shard(index, c, shard)
        if name == "Difference":
            return self._nary_shard(index, c, shard, "difference", require=True)
        if name == "Intersect":
            return self._nary_shard(index, c, shard, "intersect", require=True)
        if name == "Range":
            return self._range_shard(index, c, shard)
        if name == "Union":
            return self._nary_shard(index, c, shard, "union", require=False)
        if name == "Xor":
            return self._nary_shard(index, c, shard, "xor", require=False)
        raise ValueError(f"unknown call: {name}")

    def _row_shard(self, index, c: Call, shard: int) -> Row:
        field_name = c.field_arg()
        f = self.holder.field(index, field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise ValueError(f"Row() must specify {field_name}")
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return Row()
        return frag.row(row_id)

    def _nary_shard(self, index, c: Call, shard: int, op: str, require: bool) -> Row:
        if require and not c.children:
            raise ValueError(f"empty {c.name} query is currently not supported")
        other = Row()
        for i, child in enumerate(c.children):
            row = self._bitmap_call_shard(index, child, shard)
            other = row if i == 0 else getattr(other, op)(row)
        other.invalidate_count()
        return other

    def _time_range_views(self, index, c: Call):
        """(field, row id, quantum views in [start, end]) of a time-range
        Range(); no views when the field has no time quantum."""
        field_name = c.field_arg()
        f = self.holder.field(index, field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise ValueError("Range() must specify row")
        start_str, ok = c.string_arg("_start")
        if not ok:
            raise ValueError("Range() start time required")
        end_str, ok = c.string_arg("_end")
        if not ok:
            raise ValueError("Range() end time required")
        start = datetime.strptime(start_str, TIME_FORMAT)
        end = datetime.strptime(end_str, TIME_FORMAT)
        q = f.time_quantum()
        views = views_by_time_range(VIEW_STANDARD, start, end, q) if q else []
        return field_name, row_id, views

    def _range_shard(self, index, c: Call, shard: int) -> Row:
        """reference executeRangeShard / executeBSIGroupRangeShard."""
        if c.has_condition_arg():
            return self._bsi_range_shard(index, c, shard)
        field_name, row_id, views = self._time_range_views(index, c)
        row = Row()
        for view in views:
            frag = self.holder.fragment(index, field_name, view, shard)
            if frag is not None:
                row = row.union(frag.row(row_id))
        return row

    def _bsi_range_args(self, index, c: Call):
        """(field name, bsi group, condition) of a BSI Range()."""
        if len(c.args) == 0:
            raise ValueError("Range(): condition required")
        if len(c.args) > 1:
            raise ValueError("Range(): too many arguments")
        ((field_name, cond),) = c.args.items()
        if not isinstance(cond, Condition):
            raise ValueError(f"Range(): expected condition argument, got {cond!r}")
        f = self.holder.field(index, field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        bsig = f.bsi_group(field_name)
        if bsig is None:
            raise NotFoundError(f"bsiGroup not found: {field_name}")
        return field_name, bsig, cond

    @staticmethod
    def _bsi_range_plan(bsig, cond):
        """What a BSI Range() reads, from the predicate alone (reference
        executeBSIGroupRangeShard): ("empty",), ("not_null",) or
        ("range", op, base, base_max). Base values are Python ints, so a
        field deeper than 32 bits keeps every predicate bit."""
        if cond.op == NEQ and cond.value is None:
            return ("not_null",)
        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise ValueError(
                    "Range(): BETWEEN condition requires exactly two integer values"
                )
            base_min, base_max, out_of_range = bsig.base_value_between(*predicates)
            if out_of_range:
                return ("empty",)
            if predicates[0] <= bsig.min and predicates[1] >= bsig.max:
                return ("not_null",)
            return ("range", "><", base_min, base_max)
        value = cond.value
        if not isinstance(value, int) or isinstance(value, bool):
            raise ValueError("Range(): conditions only support integer values")
        base_value, out_of_range = bsig.base_value(cond.op, value)
        if out_of_range and cond.op != NEQ:
            return ("empty",)
        # fully-encompassing ranges return all not-null
        if (
            (cond.op == "<" and value > bsig.max)
            or (cond.op == "<=" and value >= bsig.max)
            or (cond.op == ">" and value < bsig.min)
            or (cond.op == ">=" and value <= bsig.min)
            or (out_of_range and cond.op == NEQ)
        ):
            return ("not_null",)
        if cond.op not in ("==", "!=", "<", "<=", ">", ">="):
            raise ValueError(f"invalid range operation: {cond.op}")
        return ("range", cond.op, base_value, 0)

    def _bsi_range_shard(self, index, c: Call, shard: int) -> Row:
        field_name, bsig, cond = self._bsi_range_args(index, c)
        plan = self._bsi_range_plan(bsig, cond)
        frag = self.holder.fragment(index, field_name, VIEW_BSI_GROUP_PREFIX + field_name, shard)
        if plan[0] == "empty" or frag is None:
            return Row()
        depth = bsig.bit_depth()
        if plan[0] == "not_null":
            return frag.not_null(depth)
        _, op, base, base_max = plan
        if op == "><":
            return frag.range_between(depth, base, base_max)
        return frag.range_op(op, depth, base)

    # -- device path ---------------------------------------------------------

    def _use_device(self, index, c: Call, shard: int) -> bool:
        use = self._use_device_decide(index, c, shard)
        metrics.count(
            metrics.EXECUTOR_ROUTE_DEVICE if use else metrics.EXECUTOR_ROUTE_CPU,
            call=c.name,
        )
        sp = trace.current()
        if sp is not None:
            sp.event(
                metrics.STAGE_ROUTE,
                call=c.name,
                shard=shard,
                path="device" if use else "cpu",
            )
        return use

    def _use_device_decide(self, index, c: Call, shard: int) -> bool:
        if self.device_policy == "never" or self._cpu_forced():
            return False
        if self.device_policy == "always":
            return True
        return self._touched_containers(index, c, shard) >= self.auto_min_containers

    def _touched_containers(self, index, c: Call, shard: int) -> int:
        """Estimated container blocks this call subtree READS in this
        shard — the CPU path's cost driver, and so the auto policy's
        crossover measure."""
        total = 0
        if c.name == "Row":
            try:
                fname = c.field_arg()
            except ValueError:
                fname = None
            if fname:
                frag = self.holder.fragment(index, fname, VIEW_STANDARD, shard)
                if frag is not None:
                    row_id, _ = c.uint_arg(fname)
                    total += frag.sparse_block_count([row_id])
        elif c.name == "Range" and c.has_condition_arg():
            for fname in c.args:
                total += self._bsi_plane_containers(index, fname, shard)
        elif c.name == "Range":
            # time-range form: the row is read once per quantum view
            total += self._time_range_containers(index, c, shard)
        elif c.name in ("GroupBy", "Distinct", "Percentile", "Rows"):
            total += self._analytics_containers(index, c, shard)
        elif c.name == "TopN" and c.children:
            total += self._topn_candidates(index, c, shard)
        elif c.name in ("Sum", "Min", "Max"):
            # the aggregate reads its field's whole plane stack; the JAX
            # package counts only the filter, so under "auto" an
            # unfiltered Sum/Min/Max took one launch per shard instead of
            # the shard-batched one (58 a query on ssb; PERF.md)
            fname, _ = c.string_arg("field")
            if fname:
                total += self._bsi_plane_containers(index, fname, shard)
        for child in c.children:
            total += self._touched_containers(index, child, shard)
        return total

    def _topn_candidates(self, index, c: Call, shard: int) -> int:
        """The candidate rows a filtered TopN's CPU walk intersects with
        its source (``ids=``, else the rank cache's rows): at least one
        container each. The JAX package's estimate counts only the
        source's containers, so under "auto" a one-shard TopN whose
        source is a single row always took the CPU walk, however many
        rows it ranks: on the H100 the server's dense TopN (4096
        candidates) answered in 2777 ms p50 on the CPU leg against 32 ms
        on the card (PERF.md)."""
        ids, _ = c.uint_slice_arg("ids")
        attr_name, _ = c.string_arg("attrName")
        attr_values = c.args.get("attrValues") or []
        field, _ = c.string_arg("_field")
        frag = self.holder.fragment(index, field, VIEW_STANDARD, shard) if field else None
        if attr_name and attr_values:
            # the walk intersects only the rows the filter lets through
            return len(_topn_pairs(frag, ids, attr_name, attr_values)) if frag is not None else 0
        if ids:
            return len(ids)
        return len(frag.ensure_open().cache) if frag is not None else 0

    def _bsi_plane_containers(self, index, fname: str, shard: int) -> int:
        """Set containers of a BSI field's whole plane stack in one shard."""
        f = self.holder.field(index, fname)
        bsig = f.bsi_group(fname) if f is not None else None
        frag = self.holder.fragment(index, fname, VIEW_BSI_GROUP_PREFIX + fname, shard)
        if frag is None or bsig is None:
            return 0
        return frag.sparse_block_count(list(range(bsig.bit_depth() + 1)))

    def _time_range_containers(self, index, c: Call, shard: int) -> int:
        """The queried row's containers summed over every quantum view in
        [start, end]. Malformed args estimate 0 (execution raises the
        real error)."""
        try:
            field_name, row_id, views = self._time_range_views(index, c)
        except (ValueError, NotFoundError):
            return 0
        total = 0
        for view in views:
            frag = self.holder.fragment(index, field_name, view, shard)
            if frag is not None:
                total += frag.sparse_block_count([row_id])
        return total

    def _analytics_containers(self, index, c: Call, shard: int) -> int:
        """A Rows() dimension reads every listed (or discovered) row;
        Distinct / Percentile / a GroupBy Sum aggregate read the field's
        whole plane stack. Filter subtrees and nested Rows() are counted
        by the caller's recursion over children."""
        if c.name == "Rows":
            fname, ok = c.string_arg("_field")
            frag = self.holder.fragment(index, fname, VIEW_STANDARD, shard) if ok and fname else None
            if frag is None:
                return 0
            ids, has_ids = c.uint_slice_arg("ids")
            return frag.sparse_block_count(list(ids) if has_ids else frag.row_ids())
        fname = ""
        if c.name in ("Distinct", "Percentile"):
            fname, _ = c.string_arg("field")
        elif c.name == "GroupBy":
            for child in c.children:
                if child.name == "Sum" and not child.children:
                    fname, _ = child.string_arg("field")
                    break
        return self._bsi_plane_containers(index, fname, shard) if fname else 0

    def _cached_words(self, c: Call, shard: int) -> np.ndarray:
        """u32[W] host words of one shard of a ``__cached`` node's row,
        memoized on the node (query-local, so the memo dies with the
        query)."""
        memo = c.args.setdefault("_words", {})
        w = memo.get(shard)
        if w is None:
            seg = c.args["_row"].shard_segment(shard)
            w64 = np.zeros(SHARD_WIDTH // 64, dtype=np.uint64)
            if seg is not None:
                cols = np.asarray(seg.slice_all(), dtype=np.uint64) - np.uint64(shard * SHARD_WIDTH)
                np.bitwise_or.at(
                    w64, (cols >> np.uint64(6)).astype(np.int64), np.uint64(1) << (cols & np.uint64(63))
                )
            w = memo[shard] = w64.view("<u4")
        return w

    def _device_bitmap(self, index, c: Call, shard: int):
        """Lower a bitmap call subtree to a device i32[W] word vector."""
        name = c.name
        if name == CACHED_CALL:
            return ops.words_from_numpy(self._cached_words(c, shard), self.device)
        if name == "Row":
            field_name = c.field_arg()
            f = self.holder.field(index, field_name)
            if f is None:
                raise NotFoundError(f"field not found: {field_name}")
            row_id, ok = c.uint_arg(field_name)
            if not ok:
                raise ValueError(f"Row() must specify {field_name}")
            frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
            if frag is None:
                return self._zeros(_W32)
            return self.stager.row(frag, row_id)
        if name in ("Intersect", "Union", "Xor", "Difference"):
            if not c.children:
                if name in ("Intersect", "Difference"):
                    raise ValueError(f"empty {name} query is currently not supported")
                return self._zeros(_W32)
            acc = self._device_bitmap(index, c.children[0], shard)
            for child in c.children[1:]:
                w = self._device_bitmap(index, child, shard)
                if name == "Intersect":
                    acc = ops.and_(acc, w)
                elif name == "Union":
                    acc = ops.or_(acc, w)
                elif name == "Xor":
                    acc = ops.xor_(acc, w)
                else:
                    acc = ops.andnot(acc, w)
            return acc
        if name == "Range":
            return self._device_range(index, c, [shard], stacked=False)
        raise _NotDeviceable(name)

    def _device_range(self, index, c: Call, shards, stacked: bool):
        """A Range() leaf on the device: i32[S, W] across shards, or i32[W]
        for one shard from the per-fragment stager forms (``stacked``
        False). The time-quantum form ORs the row's staged views; the BSI
        form runs the range kernel on the staged planes."""
        single = not stacked
        shape = (_W32,) if single else (len(shards), _W32)

        def stage_rows(frags, row_id):
            return self.stager.row(frags[0], row_id) if single else self.stager.row_stack(frags, row_id)

        def stage_planes(frags, depth):
            return self.stager.planes(frags[0], depth) if single else self.stager.planes_stack(frags, depth)

        if not c.has_condition_arg():
            field_name, row_id, views = self._time_range_views(index, c)
            acc = None
            for view in views:
                frags = tuple(self.holder.fragment(index, field_name, view, s) for s in shards)
                if not any(frags):
                    continue
                w = stage_rows(frags, row_id)
                acc = w if acc is None else ops.or_(acc, w)
            return acc if acc is not None else self._zeros(*shape)

        field_name, bsig, cond = self._bsi_range_args(index, c)
        plan = self._bsi_range_plan(bsig, cond)
        frags = tuple(
            self.holder.fragment(index, field_name, VIEW_BSI_GROUP_PREFIX + field_name, s)
            for s in shards
        )
        if plan[0] == "empty" or not any(frags):
            return self._zeros(*shape)
        depth = bsig.bit_depth()
        planes = stage_planes(frags, depth)
        if plan[0] == "not_null":
            # the staged not-null plane, as a dense leaf
            return planes.select(-2, depth).contiguous()
        _, op, base, base_max = plan
        return ops.bsi_range(planes, op, depth, base, base_max)

    # -- shard-batched device path -------------------------------------------
    # The whole shard set runs as ONE kernel launch over i32[S, W] stacks
    # instead of S launches (SURVEY.md §2.2 'intra-node shard parallelism').

    def _use_device_batched(self, index, c: Call, shards) -> bool:
        use = self._use_device_batched_decide(index, c, shards)
        metrics.count(
            metrics.EXECUTOR_ROUTE_DEVICE if use else metrics.EXECUTOR_ROUTE_CPU,
            call=c.name,
        )
        sp = trace.current()
        if sp is not None:
            sp.event(
                metrics.STAGE_ROUTE,
                call=c.name,
                shards=len(shards),
                path="device" if use else "cpu",
            )
        return use

    def _use_device_batched_decide(self, index, c: Call, shards) -> bool:
        if self.device_policy == "never" or len(shards) < 2 or self._cpu_forced():
            return False
        if self.device_policy == "always":
            return True
        total = sum(self._touched_containers(index, c, s) for s in shards)
        return total >= self.auto_min_containers

    def _tree_leaves(self, index, c: Call, batch):
        """Lower a bitmap call tree to (leaf device tensors, structure):
        boolean nodes become structure tuples, anything else stages to
        a leaf tensor."""
        leaves: list = []
        return leaves, self._tree_structure(index, c, batch, leaves)

    def _tree_structure(self, index, call: Call, batch, leaves: list):
        """``_tree_leaves``' recursion, a method and not a closure that
        calls itself: such a closure is a reference cycle, and the leaves
        it holds (staged tensors) would outlive the query until a garbage
        collection, so relief would evict entries whose memory stays
        allocated."""
        if call.name in ("Intersect", "Union", "Xor", "Difference") and call.children:
            return (call.name, tuple(self._tree_structure(index, ch, batch, leaves) for ch in call.children))
        leaves.append(self._device_bitmap_stack(index, call, batch))
        return ("leaf", len(leaves) - 1)

    def _tree_program(self, tree) -> ops.TreeProgram:
        """The TreeProgram of a tree structure, cached so its code is
        uploaded once. The kernel interprets any shape, so nothing is
        compiled per tree."""
        key = repr(tree)
        with self._tree_mu:
            prog = self._tree_progs.get(key)
            if prog is None:
                prog = self._tree_progs[key] = ops.TreeProgram(tree)
        return prog

    def _chain_count_single(self, leaves, tree):
        return self._timed_tree_count([list(leaves)], self._tree_program(tree))

    def _chain_count_batch(self, srcs, tree):
        prog = self._tree_program(tree)
        return self._timed_tree_count([list(leaves) for leaves in srcs], prog)

    def _device_bitmap_stack(self, index, c: Call, shards):
        """Lower a bitmap call subtree to i32[S, W] across shards."""
        name = c.name
        if name == CACHED_CALL:
            return self._cached_stack(index, c, shards)
        if name == "Row":
            field_name = c.field_arg()
            f = self.holder.field(index, field_name)
            if f is None:
                raise NotFoundError(f"field not found: {field_name}")
            row_id, ok = c.uint_arg(field_name)
            if not ok:
                raise ValueError(f"Row() must specify {field_name}")
            frags = tuple(
                self.holder.fragment(index, field_name, VIEW_STANDARD, s)
                for s in shards
            )
            return self.stager.row_stack(frags, row_id)
        if name in ("Intersect", "Union", "Xor", "Difference"):
            if not c.children:
                if name in ("Intersect", "Difference"):
                    raise ValueError(f"empty {name} query is currently not supported")
                return self._zeros(len(shards), _W32)
            acc = self._device_bitmap_stack(index, c.children[0], shards)
            for child in c.children[1:]:
                w = self._device_bitmap_stack(index, child, shards)
                if name == "Intersect":
                    acc = ops.and_(acc, w)
                elif name == "Union":
                    acc = ops.or_(acc, w)
                elif name == "Xor":
                    acc = ops.xor_(acc, w)
                else:
                    acc = ops.andnot(acc, w)
            return acc
        if name == "Range":
            return self._device_range(index, c, shards, stacked=True)
        raise _NotDeviceable(name)

    def _cached_stack(self, index, c: Call, shards):
        """A ``__cached`` node's i32[S, W] stack on the device. With a
        device plan cache it is served from the card when the subtree's
        generation vector still matches, else packed, uploaded (a tensor
        of its own, never a stager entry's view) and stamped with the
        vector the planner froze before resolving the row, so a racing
        write can only over-invalidate. An upload failure raises."""
        dc = self.device_cache
        g0 = c.args.get("_genvec")
        gvfn = c.args.get("_gv")
        if dc is None or g0 is None or gvfn is None:
            return ops.words_from_numpy(np.stack([self._cached_words(c, s) for s in shards]), self.device)
        key = (index, c.args["_h"], tuple(shards))
        hit = dc.get(key, gvfn)
        if hit is not None:
            return hit
        epoch0 = dc.epoch
        stack = np.stack([self._cached_words(c, s) for s in shards])
        dev = ops.words_from_numpy(stack, self.device)
        dc.put(key, g0, dev, int(stack.nbytes), epoch0=epoch0)
        return dev

    # -- Count ---------------------------------------------------------------

    def _execute_count(self, index, c: Call, shards, opt) -> int:
        if len(c.children) == 0:
            raise ValueError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise ValueError("Count() only accepts a single bitmap input")
        child = c.children[0]

        if shards and self._use_device_batched(index, child, shards):
            try:
                with trace.child(metrics.STAGE_DEVICE_BATCH, call="Count"):
                    n = self._count_device_batched(index, child, shards)
                self._heat_read_legs(index, child, shards)
                return n
            except _NotDeviceable:
                pass

        def map_fn(shard):
            if self._use_device(index, child, shard):
                try:
                    words = self._device_bitmap(index, child, shard)
                    return int(ops.count_bits(words))
                except _NotDeviceable:
                    pass
            return self._bitmap_call_shard_cpu(index, child, shard).count()

        result = self._map_reduce(
            index, shards, c, opt, map_fn, lambda a, b: a + b, zero_factory=lambda: 0
        )
        return int(result or 0)

    def _count_device_batched(self, index, child, shards) -> int:
        # One fused tree-count launch: the boolean nodes are interpreted
        # inside the kernel, so inner results never reach device memory.
        # Concurrent same-shape chains coalesce into one launch (each
        # slot carries its own staged leaf snapshot, so coalescing never
        # changes which data a query counts).
        leaves, tree = self._tree_leaves(index, child, shards)
        key = ("chain", repr(tree), tuple(tuple(a.shape) for a in leaves))
        res = self.chain_scorer.score(key, tree, tuple(leaves))
        return int(_fetch(res).reshape(-1)[0])

    # -- Sum / Min / Max -----------------------------------------------------

    def _bsi_field(self, index, field_name: str):
        f = self.holder.field(index, field_name)
        return f.bsi_group(field_name) if f is not None else None

    def _bsi_frags(self, index, field_name: str, shards) -> tuple:
        view = VIEW_BSI_GROUP_PREFIX + field_name
        return tuple(self.holder.fragment(index, field_name, view, s) for s in shards)

    def _bsi_shard_parts(self, index, c: Call, shard: int):
        """(fragment, bsig) for a Sum/Min/Max shard; None if missing."""
        field_name, _ = c.string_arg("field")
        bsig = self._bsi_field(index, field_name)
        if bsig is None:
            return None
        frag = self._bsi_frags(index, field_name, [shard])[0]
        if frag is None:
            return None
        return frag, bsig

    def _bsi_filter(self, index, c: Call, shard: int) -> Optional[Row]:
        if len(c.children) == 1:
            return self._bitmap_call_shard(index, c.children[0], shard)
        return None

    def _device_filter(self, index, c: Call, shard: int):
        """(filter_words, has_filter) on the device path."""
        if len(c.children) == 1:
            return self._device_bitmap(index, c.children[0], shard), True
        return self._zeros(_W32), False

    def _device_filter_stack(self, index, c: Call, shards):
        """(filter_words i32[S, W], has_filter) for a shard batch."""
        if len(c.children) == 1:
            return self._device_bitmap_stack(index, c.children[0], shards), True
        return self._zeros(len(shards), _W32), False

    def _bsi_device_shard(self, index, c: Call, frag, depth: int) -> bool:
        """Per-shard BSI legs go to the device when the policy says so or
        the plane stack alone is past the auto threshold."""
        return self._use_device(index, c, frag.shard) or (
            self.device_policy != "never"
            and not self._cpu_forced()
            and frag.sparse_block_count(list(range(depth + 1))) >= self.auto_min_containers
        )

    def _execute_sum(self, index, c: Call, shards, opt) -> ValCount:
        if not c.args.get("field"):
            raise ValueError("Sum(): field required")
        if len(c.children) > 1:
            raise ValueError("Sum() only accepts a single bitmap input")

        # shard-batched: one launch for all shards
        if shards and self._use_device_batched(index, c, shards):
            field_name, _ = c.string_arg("field")
            bsig = self._bsi_field(index, field_name)
            frags = self._bsi_frags(index, field_name, shards) if bsig is not None else ()
            if any(frags):
                try:
                    with trace.child(metrics.STAGE_DEVICE_BATCH, call="Sum"):
                        vc = self._sum_device_batched(index, c, shards, bsig, frags)
                    self._heat_read_legs(index, c, shards)
                    return vc
                except _NotDeviceable:
                    pass

        def map_fn(shard):
            parts = self._bsi_shard_parts(index, c, shard)
            if parts is None:
                return ValCount()
            frag, bsig = parts
            depth = bsig.bit_depth()
            if self._bsi_device_shard(index, c, frag, depth):
                try:
                    filt, has_filter = self._device_filter(index, c, shard)
                    planes = self.stager.planes(frag, depth)
                    counts = _fetch(
                        _timed_plane_counts(planes, filt, bit_depth=depth, has_filter=has_filter)
                    )
                    return _sum_from_counts(counts, depth, bsig.min)
                except _NotDeviceable:
                    pass
            filt = self._bsi_filter(index, c, shard)
            vsum, vcount = frag.sum(filt, depth)
            return ValCount(vsum + vcount * bsig.min, vcount)

        result = self._map_reduce(
            index, shards, c, opt, map_fn, lambda a, b: a.add(b), zero_factory=ValCount
        )
        if result is None or result.count == 0:
            return ValCount()
        return result

    def _sum_device_batched(self, index, c: Call, shards, bsig, frags) -> ValCount:
        """Per-plane counts of the whole batch in one GroupBy-kernel
        launch (no dimension: the one group is the filter)."""
        depth = bsig.bit_depth()
        filt, has_filter = self._device_filter_stack(index, c, shards)
        planes = self.stager.planes_stack(frags, depth)
        counts = _fetch(
            _timed_plane_counts_batched(planes, filt, bit_depth=depth, has_filter=has_filter)
        )
        return _sum_from_counts(counts, depth, bsig.min)

    def _execute_minmax(self, index, c: Call, shards, opt, is_min: bool) -> ValCount:
        name = "Min" if is_min else "Max"
        if not c.args.get("field"):
            raise ValueError(f"{name}(): field required")
        if len(c.children) > 1:
            raise ValueError(f"{name}() only accepts a single bitmap input")
        recurrence = _timed_bsi_min if is_min else _timed_bsi_max
        reduce_fn = (lambda a, b: a.smaller(b)) if is_min else (lambda a, b: a.larger(b))

        # shard-batched: every shard's recurrence in one launch
        if shards and self._use_device_batched(index, c, shards):
            field_name, _ = c.string_arg("field")
            bsig = self._bsi_field(index, field_name)
            frags = self._bsi_frags(index, field_name, shards) if bsig is not None else ()
            if any(frags):
                try:
                    with trace.child(metrics.STAGE_DEVICE_BATCH, call=name):
                        vc = self._minmax_device_batched(index, c, shards, bsig, frags, is_min, reduce_fn)
                    self._heat_read_legs(index, c, shards)
                    return vc
                except _NotDeviceable:
                    pass

        def map_fn(shard):
            parts = self._bsi_shard_parts(index, c, shard)
            if parts is None:
                return ValCount()
            frag, bsig = parts
            depth = bsig.bit_depth()
            if self._bsi_device_shard(index, c, frag, depth):
                try:
                    filt, has_filter = self._device_filter(index, c, shard)
                    planes = self.stager.planes(frag, depth)
                    val, count = _fetch_bits(
                        *recurrence(planes, filt, bit_depth=depth, has_filter=has_filter)
                    )
                    return ValCount(val + bsig.min, count) if count else ValCount()
                except _NotDeviceable:
                    pass
            filt = self._bsi_filter(index, c, shard)
            val, count = (frag.min if is_min else frag.max)(filt, depth)
            return ValCount(val + bsig.min, count)

        result = self._map_reduce(index, shards, c, opt, map_fn, reduce_fn, zero_factory=ValCount)
        if result is None or result.count == 0:
            return ValCount()
        return result

    def _minmax_device_batched(self, index, c: Call, shards, bsig, frags, is_min: bool, reduce_fn) -> ValCount:
        """Every shard's Min/Max recurrence in one K8 launch and one fetch;
        the per-shard values fold on the host in shard order, as the
        per-shard leg's reduce does (a tie keeps the earlier shard)."""
        depth = bsig.bit_depth()
        filt, has_filter = self._device_filter_stack(index, c, shards)
        planes = self.stager.planes_stack(frags, depth)
        bits, counts = _timed_minmax_batched(
            planes, filt, is_min=is_min, bit_depth=depth, has_filter=has_filter
        )
        got = _fetch(torch.cat([counts.to(torch.int64).unsqueeze(1), bits.to(torch.int64)], dim=1))
        result = ValCount()
        for row in got.tolist():
            count = row[0]
            val = sum(1 << i for i, b in enumerate(row[1:]) if b)
            result = reduce_fn(result, ValCount(val + bsig.min, count) if count else ValCount())
        if result.count == 0:
            return ValCount()
        return result

    # -- analytics: GroupBy / Distinct / Percentile ----------------------------
    #
    # Shard-batched device legs (one GroupBy-kernel launch per panel; the
    # Distinct and Percentile recurrences on device, one fetch each) with
    # the per-shard CPU oracle below them. A shape the device path does not
    # take (_NotDeviceable) or a quarantined fragment met while staging
    # degrades that query to the per-shard path, counted in
    # analytics.degraded_legs; a kernel failure raises.

    def _execute_groupby(self, index, c: Call, shards, opt) -> list[dict]:
        plan = analytics.parse_groupby(c)
        metrics.count(metrics.ANALYTICS_QUERIES, call="GroupBy")
        dims = analytics.resolve_dims(self.holder, index, plan, shards, self.analytics_max_groups)
        merged = None
        if shards and all(ids for _, ids in dims) and self._use_device_batched(index, c, shards):
            try:
                with trace.child(metrics.STAGE_DEVICE_BATCH, call="GroupBy"):
                    merged = self._groupby_device_batched(index, plan, dims, shards)
                fields = [f for f, _ in dims] + ([plan.agg_field] if plan.agg_field else [])
                self._analytics_heat_legs(index, fields, shards)
            except (_NotDeviceable, FragmentQuarantinedError):
                metrics.count(metrics.ANALYTICS_DEGRADED_LEGS, call="GroupBy")
                merged = None
        if merged is None:

            def map_fn(shard):
                return analytics.groupby_shard(self, index, plan, dims, shard)

            merged = self._map_reduce(
                index, shards, c, opt, map_fn, analytics.merge_group_lists, zero_factory=list
            )
        return analytics.finalize_groups(plan, merged or [])

    def _groupby_device_batched(self, index, plan, dims, shards) -> list[dict]:
        """One GroupBy-kernel launch for the whole panel: each dimension's
        rows staged as one [R, S, W] stack, the filter as [S, W], the Sum
        field's planes as the staged [S, D+1, W] stack read in place. The
        kernel ANDs each group in registers; no [K, Wf] matrix exists."""
        dim_stacks = []
        for field, ids in dims:
            frags = tuple(self.holder.fragment(index, field, VIEW_STANDARD, s) for s in shards)
            dim_stacks.append(self.stager.rows_stack(frags, tuple(ids)))
        filt = None
        if plan.filter is not None:
            filt = self._device_bitmap_stack(index, plan.filter, shards)
        k = 1
        for _, ids in dims:
            k *= len(ids)
        metrics.count(metrics.FUSION_GROUPBY_LAUNCHES)
        metrics.observe(metrics.FUSION_GROUPBY_GROUPS, k)
        depth = 0
        planes = None
        if plan.agg_field is not None:
            bsig = self._bsi_field(index, plan.agg_field)
            if bsig is None:
                raise NotFoundError(f"bsiGroup not found: {plan.agg_field}")
            afrags = self._bsi_frags(index, plan.agg_field, shards)
            if any(afrags):
                depth = bsig.bit_depth()
                planes = self.stager.planes_stack(afrags, depth)
        if planes is None:
            planes = torch.empty((len(shards), 0, _W32), dtype=torch.int32, device=self.device)
        counts, plane_counts = _timed_groupby(dim_stacks, filt, planes)
        counts = _fetch(counts)
        if plan.agg_field is None:
            return analytics.emit_device_groups(dims, counts)
        if planes.shape[1] == 0:
            return analytics.emit_device_groups(dims, counts, sums=[0] * int(counts.shape[0]))
        sums = analytics.assemble_sums(_fetch(plane_counts), depth, bsig.min)
        return analytics.emit_device_groups(dims, counts, sums=sums)

    def _execute_distinct(self, index, c: Call, shards, opt) -> list[int]:
        field, ok = c.string_arg("field")
        if not ok or not field:
            raise ValueError("Distinct(): field required")
        if len(c.children) > 1:
            raise ValueError("Distinct() only accepts a single bitmap input")
        metrics.count(metrics.ANALYTICS_QUERIES, call="Distinct")
        bsig = self._bsi_field(index, field)
        if bsig is None:
            raise NotFoundError(f"bsiGroup not found: {field}")
        if (
            shards
            and bsig.bit_depth() <= analytics.DISTINCT_DEVICE_MAX_DEPTH
            and self._use_device_batched(index, c, shards)
        ):
            try:
                with trace.child(metrics.STAGE_DEVICE_BATCH, call="Distinct"):
                    vals = self._distinct_device_batched(index, c, shards, bsig)
                self._analytics_heat_legs(index, [field], shards)
                return vals
            except (_NotDeviceable, FragmentQuarantinedError):
                metrics.count(metrics.ANALYTICS_DEGRADED_LEGS, call="Distinct")

        def map_fn(shard):
            return analytics.distinct_shard(self, index, c, field, shard)

        result = self._map_reduce(
            index, shards, c, opt, map_fn, analytics.merge_distinct_lists, zero_factory=list
        )
        return result or []

    def _distinct_device_batched(self, index, c: Call, shards, bsig) -> list[int]:
        """OR the per-shard value presence into one 2^depth bitmap on the
        device; the host decodes its set positions to values."""
        field, _ = c.string_arg("field")
        depth = bsig.bit_depth()
        frags = self._bsi_frags(index, field, shards)
        if not any(frags):
            return []
        filt, has_filter = self._device_filter_stack(index, c, shards)
        planes = self.stager.planes_stack(frags, depth)
        words = _fetch(
            _timed_distinct(planes, filt, bit_depth=depth, has_filter=has_filter)
        ).view("<u4")
        return analytics.decode_presence_words(words, bsig.min)

    def _execute_percentile(self, index, c: Call, shards, opt) -> ValCount:
        field, nth_bp = analytics.parse_percentile(c)
        metrics.count(metrics.ANALYTICS_QUERIES, call="Percentile")
        bsig = self._bsi_field(index, field)
        if bsig is None:
            raise NotFoundError(f"bsiGroup not found: {field}")
        if shards and self._use_device_batched(index, c, shards):
            try:
                with trace.child(metrics.STAGE_DEVICE_BATCH, call="Percentile"):
                    vc = self._percentile_device_batched(index, c, shards, bsig, nth_bp)
                self._analytics_heat_legs(index, [field], shards)
                return vc
            except (_NotDeviceable, FragmentQuarantinedError):
                metrics.count(metrics.ANALYTICS_DEGRADED_LEGS, call="Percentile")
        return self._percentile_by_counting(index, c, shards, opt, field, bsig, nth_bp)

    def _percentile_device_batched(self, index, c: Call, shards, bsig, nth_bp: int) -> ValCount:
        """Bit-sliced binary search over the staged planes on the device:
        one fetch of (depth bits, count)."""
        field, _ = c.string_arg("field")
        depth = bsig.bit_depth()
        frags = self._bsi_frags(index, field, shards)
        if not any(frags):
            return ValCount()
        filt, has_filter = self._device_filter_stack(index, c, shards)
        planes = self.stager.planes_stack(frags, depth)
        val, count = _fetch_bits(
            *_timed_percentile(planes, filt, nth_bp, bit_depth=depth, has_filter=has_filter)
        )
        return ValCount(val + bsig.min, count) if count else ValCount()

    def _percentile_by_counting(self, index, c: Call, shards, opt, field, bsig, nth_bp: int) -> ValCount:
        """Per-shard leg: O(depth) counting binary search over the value
        domain, each step a synthesized Count(Range(...)) through the
        ordinary Count path — the oracle the device descent must match."""

        def count_where(cond: Condition) -> int:
            child: Call = Call("Range", {field: cond})
            if len(c.children) == 1:
                child = Call("Intersect", children=[c.children[0].clone(), child])
            return self._execute_count(index, Call("Count", children=[child]), shards, opt)

        n = count_where(Condition(NEQ, None))
        if n == 0:
            return ValCount()
        k = analytics.nearest_rank(nth_bp, n)
        lo, hi = bsig.min, bsig.max
        while lo < hi:
            mid = (lo + hi) // 2
            if count_where(Condition("<=", mid)) >= k:
                hi = mid
            else:
                lo = mid + 1
        return ValCount(lo, n)

    # -- TopN (reference executeTopN two-pass, executor.go:521-585) ----------

    def _execute_topn(self, index, c: Call, shards, opt, prescored=None) -> list[dict]:
        """``prescored`` (the fuser's): a head chunk already scored in a
        fused launch, ``(frags, pairs_by_shard, ids_by_shard, mat,
        srcs)``; the walk starts from it."""
        ids_arg, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        # (shard, row_id) -> exact intersection count, filled by pass 1's
        # scoring launches and consulted by pass 2: on skewed data the
        # winning ids sit in every shard's cache head, so pass 2 usually
        # needs no device launch at all
        carry = _ScoreCarry()
        pairs = self._execute_topn_shards(index, c, shards, opt, carry, prescored=prescored)
        if not pairs or ids_arg:
            return _pairs_result(pairs)
        # Pass 2: re-query the union of candidate ids for exact counts.
        other = c.clone()
        other.args["ids"] = sorted(p[0] for p in pairs)
        trimmed = self._execute_topn_shards(index, other, shards, opt, carry)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return _pairs_result(trimmed)

    def _execute_topn_shards(self, index, c: Call, shards, opt, carry=None, prescored=None):
        if (
            self._local_batchable(opt)
            and shards
            and len(c.children) == 1
            # a fused launch already scored the head on the card: honour
            # it whatever the auto crossover now says
            and (prescored is not None or self._use_device_batched(index, c, shards))
        ):
            try:
                with trace.child(metrics.STAGE_DEVICE_BATCH, call="TopN"):
                    pairs = self._topn_shards_batched(index, c, shards, carry, prescored=prescored)
                self._heat_read_legs(index, c, shards)
                return sort_pairs(pairs)
            except _NotDeviceable:
                pass

        def map_fn(shard):
            return self._execute_topn_shard(index, c, shard, carry)

        result = self._map_reduce(index, shards, c, opt, map_fn, pairs_add, zero_factory=list)
        return sort_pairs(result or [])

    def _topn_shards_batched(self, index, c: Call, shards, carry=None, prescored=None):
        """Single-device cross-shard TopN: every shard's candidate
        scoring lands in ONE chunked kernel launch over the merged
        block-sparse staging (sparse_intersection_counts_stacked). The
        per-shard ranked walk replays on the host for bit-identical
        pruning."""
        field, _ = c.string_arg("_field")
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        attr_name, _ = c.string_arg("attrName")
        attr_values = c.args.get("attrValues") or []
        min_threshold, _ = c.uint_arg("threshold")
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise ValueError("Tanimoto Threshold is from 1 to 100 only")
        if tanimoto > 0:
            # tanimoto pruning needs each shard's CPU source count
            raise _NotDeviceable("TopN+tanimoto")
        if min_threshold <= 0:
            min_threshold = DEFAULT_MIN_THRESHOLD

        if prescored is not None:
            # the fused launch's fragment and pairs snapshot: the head
            # matrix and the walk must agree on candidate order
            frags, pairs_by_shard, ids0, mat0, srcs0 = prescored
        else:
            frags = tuple(
                self.holder.fragment(index, field, VIEW_STANDARD, s) for s in shards
            )
            pairs_by_shard = [
                _topn_pairs(f, row_ids, attr_name, attr_values) if f is not None else [] for f in frags
            ]
        if not any(pairs_by_shard):
            return []
        # lazy: a pass 2 fully covered by the carry never resolves the
        # source stack (no device re-fold of compound sources)
        provider = _StackedLazyScores(
            self,
            frags,
            pairs_by_shard,
            srcs0 if prescored is not None else lambda: self._device_bitmap_stack(index, c.children[0], shards),
            shards=shards,
            carry=carry,
        )
        if prescored is not None:
            # the fused head is chunk 0; the walk goes on from
            # _chunk_size(FIRST_CHUNK) as the unfused schedule would, so
            # chunk boundaries (and staging keys) match
            provider._mats.append(mat0)
            provider._chunk_meta.append((0, mat0.shape[1], ids0))
            provider._pos = mat0.shape[1]
            provider._publish(ids0, mat0)
        opt_ = TopOptions(
            n=int(n),
            src=None,
            row_ids=row_ids,
            min_threshold=min_threshold,
            tanimoto_threshold=0,
        )
        fast = _vectorized_topn_walk(pairs_by_shard, provider, opt_)
        if fast is not None:
            return fast
        out: list[tuple[int, int]] = []
        for i, (frag, pairs) in enumerate(zip(frags, pairs_by_shard)):
            if frag is None or not pairs:
                continue
            out = pairs_add(out, _ranked_walk(frag, opt_, pairs, provider.view(i)))
        return out

    def _execute_topn_shard(self, index, c: Call, shard: int, carry=None):
        field, _ = c.string_arg("_field")
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        attr_name, _ = c.string_arg("attrName")
        attr_values = c.args.get("attrValues") or []
        min_threshold, _ = c.uint_arg("threshold")
        tanimoto, _ = c.uint_arg("tanimotoThreshold")

        src = None
        if len(c.children) == 1:
            src = self._bitmap_call_shard(index, c.children[0], shard)
        elif len(c.children) > 1:
            raise ValueError("TopN() can only have one input bitmap")

        frag = self.holder.fragment(index, field, VIEW_STANDARD, shard)
        if frag is None:
            return []
        if min_threshold <= 0:
            min_threshold = DEFAULT_MIN_THRESHOLD
        if tanimoto > 100:
            raise ValueError("Tanimoto Threshold is from 1 to 100 only")
        opt_ = TopOptions(
            n=int(n),
            src=src,
            row_ids=row_ids,
            min_threshold=min_threshold,
            filter_name=attr_name,
            filter_values=attr_values,
            tanimoto_threshold=tanimoto,
        )
        if src is not None and self._use_device(index, c, shard):
            return self._top_device(frag, opt_, index, c, shard, carry)
        return frag.top(opt_)

    def _top_device(self, frag, opt_: TopOptions, index, c: Call, shard: int, carry=None):
        """Device TopN: score candidate chunks in one kernel launch each,
        then replay the reference's ranked walk on the precomputed
        scores (bit-identical outputs). An attribute filter narrows the
        candidates first, so only the rows that pass are scored."""
        pairs = _topn_pairs(frag, opt_.row_ids, opt_.filter_name, opt_.filter_values)
        if not pairs:
            return []
        try:
            src_words = self._device_bitmap(index, c.children[0], shard)
        except _NotDeviceable:
            return frag.top(opt_)
        scores = _LazyScores(self, frag, pairs, src_words, shard=shard, carry=carry)
        return _ranked_walk(frag, opt_, pairs, scores)

    # -- writes (reference executor.go:998-1258) -----------------------------

    def _execute_set_bit(self, index, c: Call) -> bool:
        field_name = c.field_arg()
        f = self.holder.field(index, field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise ValueError("Set() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise ValueError("Set() col argument required")
        timestamp = None
        ts_str, ok = c.string_arg("_timestamp")
        if ok:
            timestamp = datetime.strptime(ts_str, TIME_FORMAT)
        heat.record_write(index, field_name, col_id // SHARD_WIDTH, 1)
        return f.set_bit(row_id, col_id, timestamp)

    def _execute_clear_bit(self, index, c: Call) -> bool:
        field_name = c.field_arg()
        f = self.holder.field(index, field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise ValueError("Clear() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise ValueError("Clear() col argument required")
        heat.record_write(index, field_name, col_id // SHARD_WIDTH, 1)
        return f.clear_bit(row_id, col_id)

    def _execute_set_row_attrs(self, index, c: Call) -> None:
        field_name, ok = c.string_arg("_field")
        if not ok:
            raise ValueError("SetRowAttrs() field required")
        f = self.holder.field(index, field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        row_id, ok = c.uint_arg("_row")
        if not ok:
            raise ValueError("SetRowAttrs() row required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_field", "_row")}
        if f.row_attr_store is None:
            raise ValueError("row attr store not configured")
        f.row_attr_store.set_attrs(row_id, attrs)

    def _execute_set_column_attrs(self, index, c: Call) -> None:
        idx = self.holder.index(index)
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise ValueError("SetColumnAttrs() col required")
        attrs = {k: v for k, v in c.args.items() if k != "_col"}
        if idx.column_attrs is None:
            raise ValueError("column attr store not configured")
        idx.column_attrs.set_attrs(col_id, attrs)

    def _execute_set_value(self, index, c: Call) -> None:
        col_id, ok = c.uint_arg("col")
        if not ok:
            raise ValueError("SetValue() col argument required")
        for name, value in c.args.items():
            if name == "col":
                continue
            f = self.holder.field(index, name)
            if f is None:
                raise NotFoundError(f"field not found: {name}")
            if isinstance(value, bool) or not isinstance(value, int):
                raise ValueError("invalid BSI group value type")
            f.set_value(col_id, value)

    def close(self, drain: float = 5.0) -> None:
        """Shut the read pool down (called from Server.close). Checkouts
        are refused from here on, so later multi-call reads run their
        calls serially inline; those in flight get up to ``drain``
        seconds to finish before the pool shuts down under them."""
        t0 = time.monotonic()
        with self._read_pool_cv:
            self._read_pool_closing = True
            while self._read_pool_users > 0 and time.monotonic() - t0 < drain:
                self._read_pool_cv.wait(timeout=0.05)
            pool, self._read_pool = self._read_pool, None
        if pool is not None:
            pool.shutdown(wait=False)


# Lazy-scoring chunk schedule, shared by both providers: a small head
# (the walk usually prunes inside it on skewed data) then large chunks
# for deep walks. The schedule is the JAX package's, so chunk
# boundaries — and the stager's content-derived staging keys — match.
FIRST_CHUNK = 128
SCORE_CHUNK = 4096
MAX_CHUNK = 16384


def _chunk_size(pos: int) -> int:
    """Chunk size at scored-prefix position ``pos``: a small head, then
    geometric growth SCORE_CHUNK → MAX_CHUNK. A pure function of pos, so
    chunk boundaries — and the staging keys — are identical across
    queries and the device cache keeps hitting."""
    if pos == 0:
        return FIRST_CHUNK
    boundary, size = FIRST_CHUNK, SCORE_CHUNK
    while boundary + size <= pos:
        boundary += size
        if size < MAX_CHUNK:
            size *= 2
    return size


def _chunk_ids(pairs, lo: int, hi: int) -> tuple[int, ...]:
    """Candidate ids for pairs[lo:hi] (memoized on Rankings snapshots)."""
    chunk = getattr(pairs, "chunk_ids", None)
    if chunk is not None:
        return chunk(lo, hi)
    return tuple(p[0] for p in pairs[lo:hi])


def _chunk_arrays(pairs, lo: int, hi: int):
    """(ids int64[L], counts int64[L]) for pairs[lo:hi]."""
    chunk = getattr(pairs, "chunk_arrays", None)
    if chunk is not None:
        return chunk(lo, hi)
    return cache_pairs_arrays(pairs[lo:hi])


class _ChunkedLazyScores:
    """Chunk-walk skeleton for cross-shard lazy TopN scoring: the next
    chunk of every shard's candidate list is staged and scored the first
    time any shard's ranked walk reads past the scored prefix.

    ``srcs`` may be a thunk: it resolves only when a chunk actually
    launches, so a pass 2 fully covered by the cross-pass carry pays no
    device work at all. Subclasses define _stage (host packing,
    memoized by the stager) and _score (kernel launch returning an
    i32[S, size] score matrix)."""

    def __init__(self, ex, frags, pairs_by_shard, srcs, shards=None, carry=None) -> None:
        self._ex = ex
        self._frags = frags
        self._pairs = pairs_by_shard
        self._srcs = srcs
        self._scores: list[dict[int, int]] = [{} for _ in frags]
        self._pos = 0  # scored prefix length (per shard)
        self._max_len = max((len(p) for p in pairs_by_shard), default=0)
        # per-chunk score matrices [S, size] + their candidate ids; the
        # vectorized cross-shard walk consumes these directly, and the
        # per-id dict fanout (only for the scalar walk) happens lazily
        self._mats: list[np.ndarray] = []
        self._chunk_meta: list[tuple] = []  # (lo, size, ids_by_shard)
        self._fanned = 0
        self._mat_cache = None
        self._shards = list(shards) if shards is not None else list(range(len(frags)))
        self._carry = carry
        self._prefetching = False  # one prefetch in flight at a time
        if carry:
            for i, s in enumerate(self._shards):
                seed = carry.seed(s, [rid for rid, _ in pairs_by_shard[i]])
                if seed:
                    self._scores[i].update(seed)

    def _stage(self, ids_by_shard, size: int):
        raise NotImplementedError

    def _score(self, staged, size: int):
        raise NotImplementedError

    def _resolved_srcs(self):
        if callable(self._srcs):
            self._srcs = self._srcs()
        return self._srcs

    def _score_next(self) -> None:
        lo = self._pos
        size = _chunk_size(lo)
        hi = lo + size
        self._pos = hi
        ids_by_shard = tuple(_chunk_ids(ps, lo, hi) for ps in self._pairs)
        staged = self._stage(ids_by_shard, size)
        # overlap: while this chunk's kernel runs and its scores fetch,
        # pre-stage the NEXT chunk on a side thread (the stager memoizes
        # by content key). Not from the head chunk: most walks prune
        # inside it on skewed data.
        if lo > 0 and hi < self._max_len:
            self._prefetch(hi)
        if staged is None:  # no shard contributed blocks — all score 0
            mat = np.zeros((len(self._frags), size), dtype=np.int32)
        else:
            mat = self._score(staged, size)
        self._mats.append(mat)
        self._chunk_meta.append((lo, size, ids_by_shard))
        self._publish(ids_by_shard, mat)

    def _fanout(self) -> None:
        """Populate the per-shard id->score dicts from chunk matrices
        (scalar-walk path only)."""
        while self._fanned < len(self._mats):
            _, _, ids_by_shard = self._chunk_meta[self._fanned]
            mat = self._mats[self._fanned]
            for i, ids in enumerate(ids_by_shard):
                if ids:
                    self._scores[i].update(zip(ids, mat[i].tolist()))
            self._fanned += 1

    def matrices(self):
        """(scores i32[S, P], ids i64[S, P], counts i64[S, P],
        valid bool[S, P]) over the scored prefix; memoized per chunk
        count. Padding columns carry id -1 / count 0 / score 0."""
        k = len(self._mats)
        if self._mat_cache is not None and self._mat_cache[0] == k:
            return self._mat_cache[1]
        S = len(self._frags)
        smat = np.concatenate(self._mats, axis=1) if k > 1 else self._mats[0]
        P = smat.shape[1]
        idm = np.full((S, P), -1, dtype=np.int64)
        cntm = np.zeros((S, P), dtype=np.int64)
        col = 0
        for (lo, size, ids_by_shard), m in zip(self._chunk_meta, self._mats):
            for i, ids in enumerate(ids_by_shard):
                L = len(ids)
                if L:
                    a_ids, a_cnts = _chunk_arrays(self._pairs[i], lo, lo + L)
                    idm[i, col : col + L] = a_ids
                    cntm[i, col : col + L] = a_cnts
            col += size
        out = (smat, idm, cntm, idm >= 0)
        self._mat_cache = (k, out)
        return out

    def _prefetch(self, lo: int) -> None:
        if self._prefetching:
            return
        self._prefetching = True
        size = _chunk_size(lo)
        ids_by_shard = tuple(_chunk_ids(ps, lo, lo + size) for ps in self._pairs)

        def warm():
            try:
                self._stage(ids_by_shard, size)
            except Exception:
                pass  # purely advisory; the real call surfaces errors
            finally:
                self._prefetching = False

        threading.Thread(target=warm, name="stage-prefetch", daemon=True).start()

    def _publish(self, ids_by_shard, mat) -> None:
        if self._carry is None:
            return
        self._carry.add_stacked(self._shards, ids_by_shard, mat)

    def view(self, shard_index: int) -> "_ShardScoreView":
        return _ShardScoreView(self, shard_index)


class _StackedLazyScores(_ChunkedLazyScores):
    """Each chunk is one merged block-sparse launch covering all shards
    (global segment ids), coalesced with concurrent queries through
    the BatchedScorer."""

    def _stage(self, ids_by_shard, size: int):
        return self._ex.stager.sparse_rows_stacked(self._frags, ids_by_shard, size)

    def _score(self, staged, size: int):
        blocks, brow = staged[0], staged[1]
        # key on the staged tensors' identity (same live objects ⇔ same
        # snapshot — the BatchedScorer contract), so concurrent queries
        # over this chunk share one kernel launch and one fetch
        scores = self._ex.stacked_scorer.score(
            (id(blocks), id(brow)),
            staged,
            self._resolved_srcs(),
        )
        return _fetch(scores)[: len(self._frags) * size].reshape(len(self._frags), size)


class _ShardScoreView:
    __slots__ = ("_p", "_i")

    def __init__(self, provider: _StackedLazyScores, i: int) -> None:
        self._p = provider
        self._i = i

    def __getitem__(self, row_id: int) -> int:
        p = self._p
        sc = p._scores[self._i]
        if row_id in sc:
            return sc[row_id]
        p._fanout()
        while row_id not in sc and p._pos < p._max_len:
            p._score_next()
            p._fanout()
        return sc[row_id]


class _LazyScores:
    """Chunked on-demand candidate scoring for the single-shard device
    TopN walk. The walk consumes candidates in cached-count order and
    breaks once counts fall below the running threshold (reference
    fragment.go:960-1002), so chunks are scored only when reached:

      * chunk staging keys depend only on (fragment, chunk ids), so
        repeated queries hit the stager's device cache;
      * each chunk picks block-sparse vs dense staging by container
        occupancy (sparse wins below half-full);
      * dense chunks coalesce through the BatchedScorer.
    """

    def __init__(self, ex, frag, pairs, src_words, shard=0, carry=None) -> None:
        self._ex = ex
        self._frag = frag
        self._pairs = pairs
        self._src = src_words
        self._scores: dict[int, int] = {}
        self._next = 0
        self._shard = shard
        self._carry = carry
        if carry:
            self._scores.update(carry.seed(shard, [rid for rid, _ in pairs]))

    def _score_chunk(self) -> None:
        size = _chunk_size(self._next)
        ids = _chunk_ids(self._pairs, self._next, self._next + size)
        self._next += size
        frag = self._frag
        occupied = frag.sparse_block_count(list(ids))
        if occupied * 2 < len(ids) * (SHARD_WIDTH >> 16):
            staged = self._ex.stager.sparse_rows(frag, ids)
            scores = _fetch(
                ops.sparse_intersection_counts(self._src, *staged, groups=staged.groups)
            )
        else:
            # key on the staged tensor's identity (not frag.generation,
            # which a concurrent import may bump between staging and
            # here): same live tensor ⇔ same snapshot, so coalesced
            # peers never mix matrices
            mat = self._ex.stager.rows(frag, ids, pad_pow2=True)
            scores = self._ex.scorer.score(
                (id(frag), id(mat)), mat, self._src, trim=len(ids)
            )
        self._scores.update(zip(ids, (int(s) for s in scores)))
        if self._carry is not None:
            self._carry.add(self._shard, ids, scores)

    def __getitem__(self, row_id: int) -> int:
        while row_id not in self._scores and self._next < len(self._pairs):
            self._score_chunk()
        return self._scores[row_id]


def _topn_pairs(frag, row_ids, attr_name: str, attr_values) -> list:
    """A fragment's TopN candidates (``ids=`` or its rank cache) in walk
    order, less the rows an attribute filter rejects: a row passes when
    its attribute ``attr_name`` holds one of ``attr_values`` (reference
    fragment.go:922-934). The ranked walk skips a rejected row before it
    reads a score or moves its threshold, so walking the narrowed list
    picks what the filtered walk over the whole list picks."""
    pairs = frag._top_bitmap_pairs(row_ids)
    if not (attr_name and attr_values) or not pairs:
        return pairs
    store = frag.row_attr_store
    if store is None:
        return []
    allowed = {v if not isinstance(v, list) else tuple(v) for v in attr_values}
    out = []
    for rid, cnt in pairs:
        value = (store.attrs(rid) or {}).get(attr_name)
        if value is not None and value in allowed:
            out.append((rid, cnt))
    return out


def _vectorized_topn_walk(pairs_by_shard, provider, opt_: TopOptions):
    """All shards' ranked walks in one numpy pass, or None when the
    scalar walk is required (tanimoto).

    Exactness argument (mirrors _ranked_walk below, reference
    fragment.go:870-1002): the scalar walk's heap never pops, so once
    the first n qualifying candidates are pushed the heap minimum — the
    walk's threshold T — is FIXED: later pushes require count >= T.
    The walk therefore reduces to closed form per shard:
      phase 1: the first n candidates in cache order with
               cached>=min_threshold and score>=min_threshold;
               T = min of their scores;
      break:   the first later candidate with cached<T ends the walk;
      phase 2: candidates before the break with score >= T.
    Shards with fewer than n qualifying candidates scan their whole
    pairs list. The cross-shard merge is order-insensitive, so the
    picked SETS being identical makes the result bit-identical."""
    if opt_.tanimoto_threshold > 0:
        return None
    n = 0 if opt_.row_ids else opt_.n
    mth = max(int(opt_.min_threshold), 1)
    lengths = np.array([len(p) for p in pairs_by_shard], dtype=np.int64)
    max_len = int(lengths.max()) if lengths.size else 0
    if max_len == 0:
        return []

    if n == 0:
        # exhaustive mode (pass 2 / n=0): every eligible candidate is
        # scored; usually fully covered by the cross-pass carry
        ids_out: list[int] = []
        cnts_out: list[int] = []
        for i, pairs in enumerate(pairs_by_shard):
            if not pairs:
                continue
            view = provider.view(i)
            for rid, cnt in pairs:
                if cnt < mth:
                    continue
                sc = view[rid]
                if sc >= mth:
                    ids_out.append(rid)
                    cnts_out.append(sc)
        return _merge_picked(
            np.asarray(ids_out, dtype=np.int64),
            np.asarray(cnts_out, dtype=np.int64),
        )

    big = np.int64(1) << np.int64(62)
    while True:
        if provider._pos == 0:
            provider._score_next()
        smat, idm, cntm, vmask = provider.matrices()
        P = smat.shape[1]
        elig = vmask & (cntm >= mth)
        ok = elig & (smat >= mth)
        cum = np.cumsum(ok, axis=1)
        total_ok = cum[:, -1]
        has_n = total_ok >= n
        sel = ok & (cum <= n)
        T = np.where(has_n, np.where(sel, smat, big).min(axis=1), big)
        nth_pos = np.where(has_n, np.argmax(cum >= n, axis=1), P)
        colr = np.arange(P, dtype=np.int64)[None, :]
        after = colr > nth_pos[:, None]
        brk_mask = elig & after & (cntm < T[:, None])
        has_brk = brk_mask.any(axis=1)
        exhausted = P >= lengths
        done = (has_n & has_brk) | exhausted
        if done.all():
            brk = np.where(has_brk, np.argmax(brk_mask, axis=1), P)
            phase2 = elig & after & (colr < brk[:, None]) & (smat >= T[:, None])
            picked = np.where(has_n[:, None], sel | phase2, ok)
            s_idx, c_idx = np.nonzero(picked)
            return _merge_picked(idm[s_idx, c_idx], smat[s_idx, c_idx].astype(np.int64))
        if provider._pos >= max_len:
            # unreachable (P >= every shard's length implies
            # exhausted.all()); bail to the scalar walk rather than loop
            return None
        provider._score_next()


def _merge_picked(ids: np.ndarray, counts: np.ndarray) -> list[tuple[int, int]]:
    """Cross-shard merge: sum counts per id (pairs_add semantics; final
    ordering is applied by the caller's sort_pairs)."""
    if ids.size == 0:
        return []
    uids, inv = np.unique(ids, return_inverse=True)
    sums = np.bincount(inv, weights=counts.astype(np.float64))
    return list(zip(uids.tolist(), sums.astype(np.int64).tolist()))


def _ranked_walk(frag, opt_: TopOptions, pairs, score_by_id) -> list[tuple[int, int]]:
    """Replay fragment.top's ranked walk (reference fragment.go:870-1002)
    with precomputed intersection counts — identical pruning, threshold
    and tanimoto behavior, so device scoring stays bit-identical to the
    CPU path."""
    import heapq
    import math

    n = 0 if opt_.row_ids else opt_.n
    tanimoto_threshold = 0
    min_tanimoto = max_tanimoto = 0.0
    src_count = 0
    if opt_.tanimoto_threshold > 0:
        tanimoto_threshold = opt_.tanimoto_threshold
        src_count = opt_.src.count()
        min_tanimoto = float(src_count * tanimoto_threshold) / 100
        max_tanimoto = float(src_count * 100) / float(tanimoto_threshold)

    results: list[tuple[int, int]] = []
    for row_id, cnt in pairs:
        if cnt <= 0:
            continue
        if tanimoto_threshold > 0:
            if float(cnt) <= min_tanimoto or float(cnt) >= max_tanimoto:
                continue
        elif cnt < opt_.min_threshold:
            continue
        if n == 0 or len(results) < n:
            count = score_by_id[row_id]
            if count == 0:
                continue
            if tanimoto_threshold > 0:
                t = math.ceil(float(count * 100) / float(cnt + src_count - count))
                if t <= float(tanimoto_threshold):
                    continue
            elif count < opt_.min_threshold:
                continue
            heapq.heappush(results, (count, row_id))
            continue
        threshold = results[0][0]
        if threshold < opt_.min_threshold or cnt < threshold:
            break
        count = score_by_id[row_id]
        if count < threshold:
            continue
        heapq.heappush(results, (count, row_id))

    out = []
    while results:
        count, row_id = heapq.heappop(results)
        out.append((row_id, count))
    out.reverse()
    return out


def _row_from_device(words, shard: int) -> Row:
    t0 = time.monotonic()
    w32 = ops.words_to_numpy(words)
    w64 = np.ascontiguousarray(w32).view("<u8")
    seg = Bitmap.from_words_range(w64, start=shard * SHARD_WIDTH)
    trace.attrib_add(trace.WF_TRANSFER_DECODE, time.monotonic() - t0)
    return Row.from_segment(shard, seg)


def _pairs_result(pairs: list[tuple[int, int]]) -> list[dict]:
    """JSON-shaped Pair list (reference Pair, cache.go:360)."""
    return [{"id": p[0], "count": p[1]} for p in pairs]
