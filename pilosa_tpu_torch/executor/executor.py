"""Query executor (L4) — lowers PQL call trees onto shard kernels.

The port of ``pilosa_tpu/executor/executor.py``, main-path legs only.
Mirrors the reference's executor (reference executor.go): top-level
dispatch by call name, per-shard leaf functions, cross-shard map/reduce.
Two execution paths per shard:

  * CPU    — roaring Row algebra (the correctness oracle, always available)
  * device — packed-word PyTorch ops and the hand-written CUDA kernels
             over staged fragment state: bitmap subtrees fold
             elementwise, Count(chain) runs the fused tree count, TopN
             scores every candidate chunk in one launch (dense or
             block-sparse) and replays the reference's ranked walk.

Both paths are bit-identical; ``device_policy`` picks ("never" | "auto"
| "always"). The device path runs on ``device`` — ``cuda`` unless the
caller asks for ``"cpu"``, where the same legs run the kernels' plain
versions (the tests do). Without CUDA and without an explicit device
the constructor raises; it never quietly runs on the CPU.

Calls this slice does not port raise ``NotImplementedError`` naming the
ROADMAP item that ports them: BSI (Sum/Min/Max/Range/SetValue, A9),
analytics (GroupBy/Distinct/Percentile, A12) and attributes (A16). The
cluster, mesh, fusion, plan cache and dispatch engine of the JAX
executor are not here (A10, A11, A14).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Optional

import numpy as np
import torch

from pilosa_tpu_torch import SHARD_WIDTH, ops
from pilosa_tpu_torch.core import Row, TopOptions, VIEW_STANDARD
from pilosa_tpu_torch.core.cache import pairs_arrays as cache_pairs_arrays
from pilosa_tpu_torch.core.cache import sort_pairs
from pilosa_tpu_torch.core.fragment import DEFAULT_MIN_THRESHOLD
from pilosa_tpu_torch.core.timequantum import TIME_FORMAT
from pilosa_tpu_torch.executor.batcher import BatchedScorer
from pilosa_tpu_torch.executor.stager import DeviceStager
from pilosa_tpu_torch.pql import Call, parse
from pilosa_tpu_torch.roaring import Bitmap
from pilosa_tpu_torch.utils import heat, metrics, trace
from pilosa_tpu_torch.utils.errors import NotFoundError

_W32 = SHARD_WIDTH // 32

# Minimum touched containers across a query's fragments before "auto"
# picks the device path (tiny fragments are faster in roaring on host).
AUTO_DEVICE_MIN_CONTAINERS = 64
# Widest coalesced launch of the stacked TopN and chain-count scorers.
MAX_BATCH = 32

# Calls outside this slice -> the ROADMAP item that ports them.
_UNPORTED = {
    "Sum": "A9 (BSI)",
    "Min": "A9 (BSI)",
    "Max": "A9 (BSI)",
    "Range": "A9 (BSI and time-quantum Range)",
    "SetValue": "A9 (BSI)",
    "GroupBy": "A12 (analytics)",
    "Distinct": "A12 (analytics)",
    "Percentile": "A12 (analytics)",
    "Rows": "A12 (analytics)",
    "SetRowAttrs": "A16 (attributes and keys)",
    "SetColumnAttrs": "A16 (attributes and keys)",
}


def _check_ported(c: Call) -> None:
    item = _UNPORTED.get(c.name)
    if item is not None:
        raise NotImplementedError(
            f"{c.name}() is not ported to pilosa_tpu_torch yet (ROADMAP {item})"
        )
    for child in c.children:
        _check_ported(child)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda`` — and an error when CUDA is absent, never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda")


def pairs_add(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge id/count pair lists, summing counts (reference Pairs.Add)."""
    m = dict(a)
    for id_, cnt in b:
        m[id_] = m.get(id_, 0) + cnt
    return list(m.items())


@dataclass
class ExecOptions:
    """reference execOptions (executor.go:1714), the fields this slice
    reads."""

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
    num_rows rides in the staged tuple."""
    return BatchedScorer(
        max_batch=MAX_BATCH,
        single_fn=lambda src, st: ops.sparse_intersection_counts_stacked(src, *st),
        batch_fn=lambda srcs, st: ops.sparse_intersection_counts_stacked_batch_list(
            srcs, *st
        ),
    )


def _fence(out) -> None:
    """Wait for the device work producing ``out`` (a tensor, or a tuple
    of them): the stream's own sync, not a whole-device one."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            return


def _timed_kernel(kind: str, fn):
    """Wrap a kernel call so every launch is observed as
    spmd.execute_seconds and lands as a spmd.kernel span when the caller
    is traced (the port compiles nothing per shape, so there is no
    first-launch compile to split off). The fence pins the measurement
    to device completion, so the time feeds the waterfall as
    device.compute."""

    def run(*args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        _fence(out)
        dt = time.monotonic() - t0
        metrics.observe(metrics.SPMD_EXECUTE_SECONDS, dt, kind=kind)
        trace.attrib_add(trace.WF_DEVICE_COMPUTE, dt)
        sp = trace.current()
        if sp is not None:
            sp.record(metrics.STAGE_SPMD_KERNEL, t0, dt, kind=kind)
        return out

    return run


_timed_tree_count = _timed_kernel("tree_count", ops.tree_count)


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
    ) -> None:
        self.holder = holder
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
        self._read_pool = None  # lazy; see _execute()
        self._read_pool_mu = threading.Lock()

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    # -- entry point (reference Execute, executor.go:83) ---------------------

    # check: disable=dispatch-bypass (the port has no dispatch engine yet: ROADMAP A11)
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
        for call in query.calls:
            _check_ported(call)
        if shards is None and self._needs_shards(query.calls):
            shards = list(range(idx.max_shard() + 1))
        calls = query.calls
        if len(calls) > 1 and query.write_call_n() == 0 and not opt.serial:
            # an all-read request has no cross-call ordering constraints;
            # running the calls concurrently lets the BatchedScorer
            # coalesce their TopN scoring into batched kernel launches
            parent = trace.current()  # contextvars don't follow pool workers
            attrib = trace.attrib_current()

            def run_call(call):
                with trace.activate(parent), trace.attrib_activate(attrib):
                    return self._execute_call(index_name, call, shards, opt)

            return list(self._pool().map(run_call, calls))
        return [self._execute_call(index_name, call, shards, opt) for call in calls]

    def _pool(self):
        with self._read_pool_mu:
            if self._read_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._read_pool = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="pql-read"
                )
            return self._read_pool

    @staticmethod
    def _needs_shards(calls: list[Call]) -> bool:
        for c in calls:
            if c.name not in ("Clear", "Set"):
                return True
        return False

    # -- dispatch (reference executeCall, executor.go:165) -------------------

    def _execute_call(self, index, c: Call, shards, opt) -> Any:
        metrics.count(metrics.EXECUTOR_CALLS, call=c.name)
        sp = trace.current()
        if sp is None:
            return self._execute_call_inner(index, c, shards, opt)
        with sp.child(metrics.STAGE_CALL, call=c.name):
            return self._execute_call_inner(index, c, shards, opt)

    def _execute_call_inner(self, index, c: Call, shards, opt) -> Any:
        name = c.name
        if name == "Clear":
            return self._execute_clear_bit(index, c)
        if name == "Count":
            return self._execute_count(index, c, shards, opt)
        if name == "Set":
            return self._execute_set_bit(index, c)
        if name == "TopN":
            return self._execute_topn(index, c, shards, opt)
        return self._execute_bitmap_call(index, c, shards, opt)

    # -- map/reduce seam -----------------------------------------------------

    def _map_reduce(self, index, shards, c, opt, map_fn, reduce_fn, zero_factory=None):
        """Single-node: loop shards in order (deterministic reduce order).

        zero_factory builds a FRESH accumulator: reduce_fn may mutate its
        first argument (Row.merge), and mapped values can be cached
        fragment rows that must never be mutated."""
        result = zero_factory() if zero_factory else None
        parent = trace.current()
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

    # -- bitmap calls ---------------------------------------------------------

    def _execute_bitmap_call(self, index, c: Call, shards, opt) -> Row:
        def map_fn(shard):
            return self._bitmap_call_shard(index, c, shard)

        def reduce_fn(prev: Row, v: Row) -> Row:
            prev.merge(v)
            return prev

        return self._map_reduce(index, shards, c, opt, map_fn, reduce_fn, zero_factory=Row)

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
        if name == "Row":
            return self._row_shard(index, c, shard)
        if name == "Difference":
            return self._nary_shard(index, c, shard, "difference", require=True)
        if name == "Intersect":
            return self._nary_shard(index, c, shard, "intersect", require=True)
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
        if self.device_policy == "never":
            return False
        if self.device_policy == "always":
            return True
        return self._touched_containers(index, c, shard) >= AUTO_DEVICE_MIN_CONTAINERS

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
        for child in c.children:
            total += self._touched_containers(index, child, shard)
        return total

    def _device_bitmap(self, index, c: Call, shard: int):
        """Lower a bitmap call subtree to a device i32[W] word vector."""
        name = c.name
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
        raise _NotDeviceable(name)

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
        if self.device_policy == "never" or len(shards) < 2:
            return False
        if self.device_policy == "always":
            return True
        total = sum(self._touched_containers(index, c, s) for s in shards)
        return total >= AUTO_DEVICE_MIN_CONTAINERS

    def _tree_leaves(self, index, c: Call, batch):
        """Lower a bitmap call tree to (leaf device tensors, structure):
        boolean nodes become structure tuples, anything else stages to
        a leaf tensor."""
        leaves: list = []

        def build(call: Call):
            if call.name in ("Intersect", "Union", "Xor", "Difference") and call.children:
                return (call.name, tuple(build(ch) for ch in call.children))
            arr = self._device_bitmap_stack(index, call, batch)
            leaves.append(arr)
            return ("leaf", len(leaves) - 1)

        return leaves, build(c)

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
        return _timed_tree_count([list(leaves)], self._tree_program(tree))

    def _chain_count_batch(self, srcs, tree):
        prog = self._tree_program(tree)
        return _timed_tree_count([list(leaves) for leaves in srcs], prog)

    def _device_bitmap_stack(self, index, c: Call, shards):
        """Lower a bitmap call subtree to i32[S, W] across shards."""
        name = c.name
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
        raise _NotDeviceable(name)

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

    # -- TopN (reference executeTopN two-pass, executor.go:521-585) ----------

    def _execute_topn(self, index, c: Call, shards, opt) -> list[dict]:
        ids_arg, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        attr_name, _ = c.string_arg("attrName")
        if attr_name:
            raise NotImplementedError(
                "TopN attribute filters are not ported to pilosa_tpu_torch yet "
                "(ROADMAP A16 (attributes and keys))"
            )
        # (shard, row_id) -> exact intersection count, filled by pass 1's
        # scoring launches and consulted by pass 2: on skewed data the
        # winning ids sit in every shard's cache head, so pass 2 usually
        # needs no device launch at all
        carry = _ScoreCarry()
        pairs = self._execute_topn_shards(index, c, shards, opt, carry)
        if not pairs or ids_arg:
            return _pairs_result(pairs)
        # Pass 2: re-query the union of candidate ids for exact counts.
        other = c.clone()
        other.args["ids"] = sorted(p[0] for p in pairs)
        trimmed = self._execute_topn_shards(index, other, shards, opt, carry)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return _pairs_result(trimmed)

    def _execute_topn_shards(self, index, c: Call, shards, opt, carry=None):
        if (
            shards
            and len(c.children) == 1
            and self._use_device_batched(index, c, shards)
        ):
            try:
                with trace.child(metrics.STAGE_DEVICE_BATCH, call="TopN"):
                    pairs = self._topn_shards_batched(index, c, shards, carry)
                self._heat_read_legs(index, c, shards)
                return sort_pairs(pairs)
            except _NotDeviceable:
                pass

        def map_fn(shard):
            return self._execute_topn_shard(index, c, shard, carry)

        result = self._map_reduce(index, shards, c, opt, map_fn, pairs_add, zero_factory=list)
        return sort_pairs(result or [])

    def _topn_shards_batched(self, index, c: Call, shards, carry=None):
        """Single-device cross-shard TopN: every shard's candidate
        scoring lands in ONE chunked kernel launch over the merged
        block-sparse staging (sparse_intersection_counts_stacked). The
        per-shard ranked walk replays on the host for bit-identical
        pruning."""
        field, _ = c.string_arg("_field")
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise ValueError("Tanimoto Threshold is from 1 to 100 only")
        if tanimoto > 0:
            # tanimoto pruning needs each shard's CPU source count
            raise _NotDeviceable("TopN+tanimoto")
        if min_threshold <= 0:
            min_threshold = DEFAULT_MIN_THRESHOLD

        frags = tuple(
            self.holder.fragment(index, field, VIEW_STANDARD, s) for s in shards
        )
        pairs_by_shard = [
            f._top_bitmap_pairs(row_ids) if f is not None else [] for f in frags
        ]
        if not any(pairs_by_shard):
            return []
        # lazy: a pass 2 fully covered by the carry never resolves the
        # source stack (no device re-fold of compound sources)
        provider = _StackedLazyScores(
            self,
            frags,
            pairs_by_shard,
            lambda: self._device_bitmap_stack(index, c.children[0], shards),
            shards=shards,
            carry=carry,
        )
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
            tanimoto_threshold=tanimoto,
        )
        if src is not None and self._use_device(index, c, shard):
            return self._top_device(frag, opt_, index, c, shard, carry)
        return frag.top(opt_)

    def _top_device(self, frag, opt_: TopOptions, index, c: Call, shard: int, carry=None):
        """Device TopN: score candidate chunks in one kernel launch each,
        then replay the reference's ranked walk on the precomputed
        scores (bit-identical outputs)."""
        pairs = frag._top_bitmap_pairs(opt_.row_ids)
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

    def close(self) -> None:
        with self._read_pool_mu:
            pool, self._read_pool = self._read_pool, None
        if pool is not None:
            pool.shutdown(wait=True)


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
        blocks, brow, bslot, bshard, num_rows = staged
        # key on the staged tensors' identity (same live objects ⇔ same
        # snapshot — the BatchedScorer contract), so concurrent queries
        # over this chunk share one kernel launch and one fetch
        scores = self._ex.stacked_scorer.score(
            (id(blocks), id(brow)),
            (blocks, brow, bslot, bshard, num_rows),
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
            blocks, brow, bslot, num_rows = self._ex.stager.sparse_rows(frag, ids)
            scores = _fetch(
                ops.sparse_intersection_counts(self._src, blocks, brow, bslot, num_rows)
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
