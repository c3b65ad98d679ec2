"""Whole-query fusion — one launch sequence and one fetch per multi-call read.

The port of ``pilosa_tpu/executor/fusion.py``. The per-call executor pays
the host↔device boundary once per call: each Count/Sum/TopN in a
multi-call query (and every query the server's pipeline combines into
one multi-call query) launches its kernels, waits for them and fetches
its own result. The fuser lowers every fusable call of the query to a
unit — Count → the tree count (K3), Sum → the BSI plane counts (K4),
GroupBy → the segmented reduction (K4), Distinct → the presence map
(K9), Percentile → the bit-sliced search (K10), TopN → the head chunk's
block-sparse scores (K2) — and runs the units as one fused program:

  1. lowering finishes first: staging, host tables, filter stacks and
     every upload (a pageable upload waits for the host);
  2. the enqueue: every unit's kernels go onto the stream back to back,
     with no host sync; each unit writes its result into its slice of
     one packed int32 device buffer, and Count units that share a tree
     program share one K3 launch at Q = their number;
  3. the fetch: one device-to-host copy of that buffer, one stream sync,
     then the host finishers.

A program is the layout of that buffer for one signature (the units'
descriptors and input shapes), cached as the reference caches its jitted
programs; it holds no tensor, so no input outlives its launch.

Bit-identity: every unit runs the same kernels and host finishers as the
per-call device path; a TopN unit's head matrix is handed to the per-call
TopN walk as its first chunk (``Executor._execute_topn(prescored=)``).

Calls that cannot lower (Min/Max, bitmap-valued calls, tanimoto TopN)
stay on the per-call path, and so does a call whose
lowering fails on its arguments, a shape the device path does not take
or a quarantined fragment: each such call is counted in ``bypasses``,
and the per-call path produces its answer or its error. A kernel that
refuses its launch (``ops.cuda.LaunchError``) and device faults
propagate: a bare executor raises them; under the server's health gate
the guard and OOM recovery act as on the per-call path, and the
per-call path takes the reads.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.core import VIEW_STANDARD
from pilosa_tpu_torch.core.fragment import FragmentQuarantinedError
from pilosa_tpu_torch.executor import analytics
from pilosa_tpu_torch.executor.devicehealth import DeviceDown
from pilosa_tpu_torch.executor.executor import (
    FIRST_CHUNK,
    ValCount,
    _chunk_ids,
    _deadline,
    _NotDeviceable,
    _sum_from_counts,
    _topn_pairs,
    _W32,
)
from pilosa_tpu_torch.executor.hbm import DeviceOom, classify_device_error
from pilosa_tpu_torch.ops.cuda import LaunchError
from pilosa_tpu_torch.utils import chaos, metrics, trace
from pilosa_tpu_torch.utils.errors import NotFoundError

# call names the fuser can lower; everything else is residual
_ANALYTIC = analytics.ANALYTIC_CALLS
_FUSABLE = ("Count", "Sum", "TopN") + _ANALYTIC
# what a call's lowering raises on its own arguments or data: the
# per-call path produces the same answer or error
_LOWERING_ERRORS = (ValueError, TypeError, NotFoundError, NotImplementedError, _NotDeviceable)


class _Unit:
    """One lowered call: a descriptor (part of the program's signature),
    its device inputs, a host finisher mapping its slice of the fetched
    buffer to the call's result, and ``extra_bytes``, the device memory
    the launch allocates for it beyond the packed buffer (kernel outputs
    and scratch, a computed filter stack) for HBM admission."""

    __slots__ = ("call_index", "desc", "inputs", "finish", "extra_bytes")

    def __init__(self, call_index: int, desc, inputs, finish, extra_bytes: int = 0) -> None:
        self.call_index = call_index
        self.desc = desc
        self.inputs = inputs
        self.finish = finish
        self.extra_bytes = extra_bytes


def _out_words(desc) -> int:
    """int32 words a unit's result takes in the packed buffer."""
    kind = desc[0]
    if kind == "count":
        return 1
    if kind in ("sum", "percentile"):
        return desc[1] + 1
    if kind in ("groupby_count", "groupby_sum"):
        k = 1
        for r in desc[1]:
            k *= r
        return k if kind == "groupby_count" else k * (desc[3] + 2)
    if kind == "distinct":
        return max(((1 << desc[1]) + 31) // 32, 1)
    return desc[2] * desc[3]  # topn: n_shards x chunk


class _Program:
    """The launch plan of one fused signature: each unit's slice of the
    packed int32 buffer, and the Count units grouped by tree program,
    each group's slices adjacent so one K3 launch fills them. Holds no
    tensor."""

    def __init__(self, descs: tuple) -> None:
        self.descs = descs
        self.count_groups: dict = {}
        for k, d in enumerate(descs):
            if d[0] == "count":
                self.count_groups.setdefault(d[1], []).append(k)
        self.offsets = [0] * len(descs)
        off = 0
        for members in self.count_groups.values():
            for k in members:
                self.offsets[k] = off
                off += 1
        for k, d in enumerate(descs):
            if d[0] != "count":
                self.offsets[k] = off
                off += _out_words(d)
        self.words = off

    def split(self, host: np.ndarray) -> list:
        """Each unit's result from the fetched buffer, in its shape."""
        out = []
        for d, off in zip(self.descs, self.offsets):
            part = host[off : off + _out_words(d)]
            if d[0] == "groupby_sum":
                part = part.reshape(-1, d[3] + 2)
            elif d[0] == "topn":
                part = part.reshape(d[2], d[3])
            elif d[0] == "distinct":
                part = part.view("<u4")
            out.append(part)
        return out


class QueryFuser:
    """Lowers the fusable calls of one read query into a single fused
    program. Owned by an Executor; invoked from ``_execute`` after the
    CSE rewrite, before the per-call fan-out."""

    def __init__(self, ex, max_calls: int = 64) -> None:
        self.ex = ex
        self.max_calls = int(max_calls)
        # program cache: (unit descriptors, input shapes) -> _Program;
        # bounded by distinct fused query shapes
        self._programs: dict = {}
        self._mu = threading.Lock()
        self.fused_launches = 0
        self.fused_calls = 0
        self.cache_served = 0
        self.bytes_returned = 0
        self.admission_splits = 0
        self.bypasses: dict[str, int] = {}

    # -- eligibility ---------------------------------------------------------

    def _bypass(self, reason: str) -> None:
        with self._mu:
            self.bypasses[reason] = self.bypasses.get(reason, 0) + 1
        metrics.count(metrics.FUSION_BYPASSES, reason=reason)

    def try_execute(self, index: str, calls, shards, opt) -> Optional[dict[int, Any]]:
        """Results for the call positions this fuser served (a fused
        launch or a plan-cache hit), or None / {} when every call takes
        the per-call path. A kernel's refused launch raises; so does a
        device fault on an executor without a health gate. With one, the
        gate and OOM recovery have acted, and the per-call path takes the
        reads (on the CPU leg while the gate or the cooldown forces it).
        An injected poisoned lowering (utils/chaos.py) counts an
        ``"error"`` bypass and the per-call path answers, as the
        reference treats every error here."""
        ex = self.ex
        if ex.cluster is not None:
            # a cluster's calls map onto their shards' owners (and a remote
            # leg bypasses below, as "opt"), as in the reference
            self._bypass("topology")
            return None
        if opt.remote or opt.serial:
            self._bypass("opt")
            return None
        if ex.device_policy == "never" or ex._cpu_forced():
            self._bypass("cpu")
            return None
        if not shards:
            self._bypass("no_shards")
            return None
        if len(calls) > self.max_calls:
            self._bypass("too_many_calls")
            return None
        candidates = [(i, c) for i, c in enumerate(calls) if c.name in _FUSABLE]
        if len(candidates) < 2 and not any(c.name in _ANALYTIC for _, c in candidates):
            # an analytic call is itself a K-way panel, so it fuses alone
            self._bypass("too_few_calls")
            return None
        if ex.device_policy != "always":
            # the auto crossover on the aggregate: fused calls share one
            # launch sequence, so their container estimates add up
            total = sum(ex._touched_containers(index, c, s) for _, c in candidates for s in shards)
            if total < ex.auto_min_containers:
                self._bypass("auto_policy")
                return None
        try:
            return self._run(index, calls, candidates, shards, opt)
        except chaos.InjectedPoisonError:
            # an injected poisoned lowering: the reference's error
            # bypass, and the per-call path answers every call
            self._bypass("error")
            return {}
        except Exception as e:
            fault = isinstance(e, (DeviceDown, DeviceOom)) or classify_device_error(e) is not None
            if isinstance(e, LaunchError) or not fault or ex.health is None:
                raise
            self._bypass("device")
            return {}

    # -- probe + lower + launch ---------------------------------------------

    def _run(self, index, calls, candidates, shards, opt) -> dict[int, Any]:
        ex = self.ex
        pc = ex.plan_cache if opt.cache and ex._local_batchable(opt) else None
        out: dict[int, Any] = {}
        # plan-cache probe per candidate; (key, genvec, epoch) captured
        # BEFORE any build, so a fused insert keeps the
        # over-invalidation-only race direction (plan/cache.py)
        cacheinfo: dict[int, tuple] = {}
        lower = []
        for i, c in candidates:
            if pc is not None:
                from pilosa_tpu_torch.plan import planner

                keyinfo = planner.call_cache_key(ex, index, c, shards, opt)
                if keyinfo is not None:
                    key, gvfn = keyinfo
                    genvec = gvfn()
                    hit = pc.get(key, gvfn)
                    if hit is not None:
                        out[i] = hit
                        with self._mu:
                            self.cache_served += 1
                        continue
                    cacheinfo[i] = (key, genvec, pc.epoch)
            lower.append((i, c))
        if not lower:
            return out
        parent = trace.current()
        attrib = trace.attrib_current()
        dl = _deadline().current()

        def fused():
            # the guard's pool thread: hand over span, waterfall, deadline
            with trace.activate(parent), trace.attrib_activate(attrib), _deadline().activate(dl):
                return self._lower_and_launch(index, lower, shards, opt)

        served = ex.health.guard(fused) if ex.health is not None else fused()
        bycall = dict(lower)
        for i, result, cost in served:
            out[i] = result
            # the fused launch bypasses _map_reduce: its read legs land here
            if bycall[i].name in _ANALYTIC:
                ex._analytics_heat_legs(index, analytics.heat_fields(bycall[i]), shards)
            else:
                ex._heat_read_legs(index, bycall[i], shards)
            info = cacheinfo.get(i)
            if info is not None:
                key, genvec, epoch0 = info
                pc.put(key, genvec, result, cost=cost, epoch0=epoch0)
        return out

    def _lower_and_launch(self, index, lower, shards, opt) -> list[tuple]:
        units: list[_Unit] = []
        lowerers = {
            "Count": self._lower_count,
            "Sum": self._lower_sum,
            "GroupBy": self._lower_groupby,
            "Distinct": self._lower_distinct,
            "Percentile": self._lower_percentile,
            "TopN": self._lower_topn,
        }
        bycall = dict(lower)
        for i, c in lower:
            try:
                u = lowerers[c.name](index, i, c, shards, opt)
            except FragmentQuarantinedError:
                # the per-call path answers the clean 503
                if c.name in _ANALYTIC:
                    metrics.count(metrics.ANALYTICS_DEGRADED_LEGS, call=c.name)
                self._bypass("quarantined")
                continue
            except _LOWERING_ERRORS:
                # malformed arguments, missing fields, a shape the device
                # path does not take: the per-call path owns the answer
                self._bypass("lowering")
                continue
            if u is None:
                self._bypass("lowering")
            else:
                units.append(u)
        launch = [u for u in units if u.desc is not None]
        zero_only = [(u.call_index, u.finish(None), 0.0) for u in units if u.desc is None]
        if len(launch) < 2 and not any(bycall[u.call_index].name in _ANALYTIC for u in launch):
            # one device call gains nothing over the per-call path; a lone
            # analytic panel does launch (it replaces K point queries)
            self._bypass("too_few_fusable")
            return zero_only
        return self._launch_units(launch) + zero_only

    def _launch_units(self, launch: list, depth: int = 0) -> list[tuple]:
        """Launch lowered units as one fused program under HBM admission:
        the governor is asked whether the launch's allocations (the packed
        buffer, kernel outputs and scratch, computed filter stacks) fit
        before it runs. A launch that does not fit splits in half (each
        half admitted again); a unit that cannot fit alone goes to the
        per-call path (bypass "admission")."""
        ex = self.ex
        descs = tuple(u.desc for u in launch)
        words = sum(_out_words(d) for d in descs)
        est = 4 * words + sum(u.extra_bytes for u in launch)
        gov = ex.governor
        if est > 0 and not gov.admit(est):
            if len(launch) >= 2 and depth < 4:
                with self._mu:
                    self.admission_splits += 1
                metrics.count(metrics.FUSION_ADMISSION_SPLITS)
                mid = len(launch) // 2
                return self._launch_units(launch[:mid], depth + 1) + self._launch_units(launch[mid:], depth + 1)
            for _ in launch:
                self._bypass("admission")
            return []
        shapes = tuple(
            (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else ()
            for u in launch
            for a in u.inputs
        )
        program = self._program(descs, shapes)

        def attempt():
            # the chaos hook inside the retried attempt, as _timed_kernel's
            cf = chaos.FAULTS
            if cf is not None:
                cf.on_kernel("fused_query")
            return self._fetch(self._enqueue(program, launch))

        t0 = time.monotonic()
        with trace.child(metrics.STAGE_DEVICE_BATCH, call="Fused"):
            host = ex._oom.run(attempt, kind="fused_query")
        dt = time.monotonic() - t0
        metrics.observe(metrics.SPMD_EXECUTE_SECONDS, dt, kind="fused_query")
        trace.attrib_add(trace.WF_DEVICE_COMPUTE, dt)
        sp = trace.current()
        if sp is not None:
            sp.record(metrics.STAGE_SPMD_KERNEL, t0, dt, kind="fused_query")
        nbytes = 4 * program.words
        with self._mu:
            self.fused_launches += 1
            self.fused_calls += len(launch)
            self.bytes_returned += nbytes
        metrics.count(metrics.FUSION_FUSED_LAUNCHES)
        metrics.observe(metrics.FUSION_FUSED_CALLS_PER_LAUNCH, len(launch))
        metrics.count(metrics.FUSION_BYTES_RETURNED, nbytes)
        for d in descs:
            if d[0] in ("groupby_count", "groupby_sum"):
                metrics.count(metrics.FUSION_GROUPBY_LAUNCHES)
                metrics.observe(metrics.FUSION_GROUPBY_GROUPS, _out_words(("groupby_count", d[1])))
        cost = dt / len(launch)
        parts = program.split(host)
        return [(u.call_index, u.finish(parts[k]), cost) for k, u in enumerate(launch)]

    # -- the fused program -----------------------------------------------------

    def _program(self, descs: tuple, shapes: tuple) -> _Program:
        key = (descs, shapes)
        with self._mu:
            prog = self._programs.get(key)
        if prog is None:
            cf = chaos.FAULTS
            if cf is not None:
                # an injected poisoned lowering raises before the program
                # is cached: try_execute's error bypass sends the query
                # to the per-call path
                cf.on_lowering()
            with self._mu:
                prog = self._programs.setdefault(key, _Program(descs))
        return prog

    def _enqueue(self, program: _Program, units: list) -> torch.Tensor:
        """Every unit's kernels onto the stream back to back, each result
        copied into its slice of one packed int32 buffer on the device;
        returns the buffer. Nothing here waits for the device."""
        ex = self.ex
        buf = torch.empty(program.words, dtype=torch.int32, device=ex.device)
        for tree, members in program.count_groups.items():
            counts = ops.tree_count([units[k].inputs for k in members], ex._tree_program(tree))
            off = program.offsets[members[0]]
            buf[off : off + len(members)].copy_(counts)
        for k, u in enumerate(units):
            d = u.desc
            kind = d[0]
            if kind == "count":
                continue
            off = program.offsets[k]
            part = buf[off : off + _out_words(d)]
            if kind == "sum":
                planes, filt = u.inputs
                part.copy_(ops.bsi_plane_counts_batched(planes, filt, bit_depth=d[1], has_filter=filt is not None))
            elif kind == "groupby_count":
                dims, filt, planes = u.inputs
                part.copy_(ops.groupby_reduce(list(dims), filt, planes)[0])
            elif kind == "groupby_sum":
                dims, filt, planes = u.inputs
                counts, plane_counts = ops.groupby_reduce(list(dims), filt, planes)
                grid = part.view(-1, d[3] + 2)
                grid[:, 0].copy_(counts)
                grid[:, 1:].copy_(plane_counts)
            elif kind == "distinct":
                planes, filt = u.inputs
                part.copy_(ops.bsi_distinct_presence(planes, filt, bit_depth=d[1], has_filter=filt is not None))
            elif kind == "percentile":
                planes, filt, nth_bp = u.inputs
                bits, count = ops.bsi_percentile_batched(
                    planes, filt, nth_bp, bit_depth=d[1], has_filter=filt is not None
                )
                part[: d[1]].copy_(bits)
                part[d[1] :].copy_(count.reshape(1))
            else:  # topn head chunk
                _, n_shards, chunk = d[1], d[2], d[3]
                srcs, blocks, brow, bslot, bshard, groups = u.inputs
                part.view(n_shards, chunk).copy_(
                    ops.sparse_intersection_counts_stacked_mat(
                        srcs, blocks, brow, bslot, bshard, d[1], n_shards, chunk, groups=groups
                    )
                )
        return buf

    @staticmethod
    def _fetch(buf: torch.Tensor) -> np.ndarray:
        """The packed buffer on the host: one device-to-host copy, which
        waits for the stream."""
        return buf.cpu().numpy()

    # -- per-call lowering -----------------------------------------------------

    def _filter(self, index, c, shards):
        """(filter stack or None, bytes the device path computes for it)."""
        if len(c.children) == 1:
            filt = self.ex._device_bitmap_stack(index, c.children[0], shards)
            return filt, filt.numel() * 4
        return None, 0

    def _bsi(self, index, field: str, shards):
        """(bsi group, fragments) of a BSI field over the shards."""
        ex = self.ex
        bsig = ex._bsi_field(index, field)
        if bsig is None:
            return None, ()
        return bsig, ex._bsi_frags(index, field, shards)

    def _lower_count(self, index, i, c, shards, opt) -> Optional[_Unit]:
        if len(c.children) != 1:
            return None
        ex = self.ex
        leaves, tree = ex._tree_leaves(index, c.children[0], shards)
        return _Unit(i, ("count", tree, len(leaves)), tuple(leaves), lambda out: int(out[0]), extra_bytes=4)

    def _lower_sum(self, index, i, c, shards, opt) -> Optional[_Unit]:
        field, ok = c.string_arg("field")
        if not ok or not field or len(c.children) > 1:
            return None
        bsig, frags = self._bsi(index, field, shards)
        if not any(frags):
            return None
        depth = bsig.bit_depth()
        filt, fbytes = self._filter(index, c, shards)
        planes = self.ex.stager.planes_stack(frags, depth)
        return _Unit(
            i,
            ("sum", depth, filt is not None),
            (planes, filt),
            lambda counts: _sum_from_counts(counts, depth, bsig.min),
            extra_bytes=fbytes + 4 * (depth + 2),
        )

    def _lower_groupby(self, index, i, c, shards, opt) -> Optional[_Unit]:
        """A whole GroupBy panel as one K4 unit: each dimension's rows
        staged as one [R, S, W] stack, the filter as [S, W], the Sum
        field's planes read in place; the kernel ANDs each group in
        registers, so no [K, S·W] cross product exists."""
        ex = self.ex
        plan = analytics.parse_groupby(c)
        dims = analytics.resolve_dims(ex.holder, index, plan, shards, ex.analytics_max_groups)
        if not all(ids for _, ids in dims):
            return _Unit(i, None, (), lambda _res: [])
        stacks = []
        for field, ids in dims:
            frags = tuple(ex.holder.fragment(index, field, VIEW_STANDARD, s) for s in shards)
            stacks.append(ex.stager.rows_stack(frags, tuple(ids)))
        filt = None
        fbytes = 0
        if plan.filter is not None:
            filt = ex._device_bitmap_stack(index, plan.filter, shards)
            fbytes = filt.numel() * 4
        rcounts = tuple(len(ids) for _, ids in dims)
        k = 1
        for r in rcounts:
            k *= r
        if plan.agg_field is None:
            planes = torch.empty((len(shards), 0, _W32), dtype=torch.int32, device=ex.device)

            def finish(counts):
                metrics.count(metrics.ANALYTICS_QUERIES, call="GroupBy")
                return analytics.finalize_groups(plan, analytics.emit_device_groups(dims, counts))

            return _Unit(
                i, ("groupby_count", rcounts, filt is not None), (tuple(stacks), filt, planes), finish,
                extra_bytes=fbytes + 4 * k,
            )
        bsig, afrags = self._bsi(index, plan.agg_field, shards)
        if not any(afrags):
            return None  # the per-call path owns the error or the zero sums
        depth = bsig.bit_depth()
        planes = ex.stager.planes_stack(afrags, depth)

        def finish_sum(out):
            metrics.count(metrics.ANALYTICS_QUERIES, call="GroupBy")
            sums = analytics.assemble_sums(out[:, 1:], depth, bsig.min)
            return analytics.finalize_groups(plan, analytics.emit_device_groups(dims, out[:, 0], sums=sums))

        return _Unit(
            i, ("groupby_sum", rcounts, filt is not None, depth), (tuple(stacks), filt, planes), finish_sum,
            extra_bytes=fbytes + 4 * k * (depth + 2),
        )

    def _lower_distinct(self, index, i, c, shards, opt) -> Optional[_Unit]:
        field, ok = c.string_arg("field")
        if not ok or not field or len(c.children) > 1:
            return None
        bsig, frags = self._bsi(index, field, shards)
        if bsig is None or bsig.bit_depth() > analytics.DISTINCT_DEVICE_MAX_DEPTH:
            return None  # the per-call path owns the error or the CPU walk
        if not any(frags):
            return _Unit(i, None, (), lambda _res: [])
        depth = bsig.bit_depth()
        filt, fbytes = self._filter(index, c, shards)
        planes = self.ex.stager.planes_stack(frags, depth)

        def finish(words):
            metrics.count(metrics.ANALYTICS_QUERIES, call="Distinct")
            return analytics.decode_presence_words(words, bsig.min)

        return _Unit(
            i, ("distinct", depth, filt is not None), (planes, filt), finish,
            extra_bytes=fbytes + 4 * _out_words(("distinct", depth)),
        )

    def _lower_percentile(self, index, i, c, shards, opt) -> Optional[_Unit]:
        field, nth_bp = analytics.parse_percentile(c)
        bsig, frags = self._bsi(index, field, shards)
        if bsig is None:
            return None
        if not any(frags):
            return _Unit(i, None, (), lambda _res: ValCount())
        depth = bsig.bit_depth()
        filt, fbytes = self._filter(index, c, shards)
        planes = self.ex.stager.planes_stack(frags, depth)

        def finish(out):
            metrics.count(metrics.ANALYTICS_QUERIES, call="Percentile")
            count = int(out[depth])
            if count == 0:
                return ValCount()
            val = sum(1 << j for j in range(depth) if int(out[j]))
            return ValCount(val + bsig.min, count)

        # K10's step counters and outputs, and its [S, W] scratch on the global route
        work = ops.cuda.percentile_scratch_bytes(planes)
        return _Unit(
            i, ("percentile", depth, filt is not None), (planes, filt, nth_bp), finish,
            extra_bytes=fbytes + work,
        )

    def _lower_topn(self, index, i, c, shards, opt) -> Optional[_Unit]:
        ex = self.ex
        if len(c.children) != 1:
            return None
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 0:
            return None  # tanimoto pruning needs per-shard CPU counts
        field, ok = c.string_arg("_field")
        if not ok:
            return None
        row_ids, _ = c.uint_slice_arg("ids")
        attr_name, _ = c.string_arg("attrName")
        attr_values = c.args.get("attrValues") or []
        frags = tuple(ex.holder.fragment(index, field, VIEW_STANDARD, s) for s in shards)
        # an attribute filter narrows the candidates before the head is
        # scored, as on the per-call path
        pairs_by_shard = [
            _topn_pairs(f, row_ids, attr_name, attr_values) if f is not None else [] for f in frags
        ]
        if not any(pairs_by_shard):
            return None  # the per-call path answers [] with no device work
        size = FIRST_CHUNK
        ids_by_shard = tuple(_chunk_ids(ps, 0, size) for ps in pairs_by_shard)
        srcs = ex._device_bitmap_stack(index, c.children[0], shards)
        staged = ex.stager.sparse_rows_stacked(frags, ids_by_shard, size)
        n_shards = len(shards)

        def finish(mat):
            if mat is None:  # no shard contributed blocks: all score 0
                mat = np.zeros((n_shards, size), dtype=np.int32)
            # the fused head is the walk's first chunk; the ranked walk
            # then runs unchanged
            return ex._execute_topn(
                index, c, shards, opt, prescored=(frags, pairs_by_shard, ids_by_shard, mat, srcs)
            )

        if staged is None:
            return _Unit(i, None, (), finish)
        blocks, brow, bslot, bshard, num_rows = staged
        return _Unit(
            i, ("topn", num_rows, n_shards, size), (srcs, blocks, brow, bslot, bshard, staged.groups), finish,
            extra_bytes=8 * num_rows,
        )

    def stats(self) -> dict:
        ex = self.ex
        with self._mu:
            launches = self.fused_launches
            return {
                "enabled": True,
                "max_calls": self.max_calls,
                "fused_launches": launches,
                "fused_calls": self.fused_calls,
                "avg_calls_per_launch": round(self.fused_calls / launches, 2) if launches else None,
                "bytes_returned": self.bytes_returned,
                "cache_served": self.cache_served,
                "admission_splits": self.admission_splits,
                "programs": len(self._programs),
                "bypasses": dict(self.bypasses),
                "device_cache": ex.device_cache.stats() if ex.device_cache is not None else {"enabled": False},
            }

