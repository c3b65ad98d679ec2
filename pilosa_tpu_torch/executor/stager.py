"""Device staging manager — the device-side cache of fragment state.

Fragments are the CPU source of truth (roaring + op log); queries run on
packed-word copies staged in device memory as ``int32`` tensors (the
bits of the JAX package's ``u32`` words). Entries are keyed by
(fragment identity, form) — the same staging keys as
``pilosa_tpu/executor/stager.py`` — and remember the fragment generation
their tensor was built at.

A generation change RESTAGES THE WHOLE ENTRY: the port has no word-delta
scatter yet (the JAX package patches resident arrays with
``ops/delta.py apply_word_updates``; ROADMAP A2). Answers stay exact —
a reader never accepts an entry older than the generation it observed —
and only the restaged bytes grow (``stager.restaged_bytes``).

Staged forms (the main-path ones):
  * row                 — i32[W]
  * rows(pad_pow2)      — i32[K, W]
  * row_stack           — i32[S, W] across S fragments (None → zeros)
  * sparse_rows         — block-sparse candidates of one fragment
  * sparse_rows_stacked — block-sparse candidates of all shards
  * planes              — i32[D+1, W] BSI plane stack of one fragment
  * planes_stack        — i32[S, D+1, W] BSI planes across S fragments
  * rows_stack          — i32[R, S, W] GroupBy dimension rows

Uploads go host → pinned memory → device without blocking the host
(``ops.words_from_numpy``). A cold key is staged ONCE: concurrent misses
wait on the first builder and receive the same tensor, which keeps
BatchedScorer coalescing intact (its key is the staged tensor's
identity). Eviction is LRU by byte budget.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from pilosa_tpu_torch import SHARD_WIDTH, ops
from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.executor.batcher import _next_pow2
from pilosa_tpu_torch.utils import heat, metrics, trace

_W32 = SHARD_WIDTH // 32  # words per staged row


class _InFlight:
    __slots__ = ("event", "value", "error", "gen")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.gen = None  # generation token the published value reflects


class _Entry:
    __slots__ = ("value", "nbytes", "gen")

    def __init__(self, value, nbytes: int, gen) -> None:
        self.value = value
        self.nbytes = nbytes
        self.gen = gen  # int, or tuple of per-fragment ints for stacks


def _gen_fresh(have, want) -> bool:
    """Is a staged snapshot at generation ``have`` acceptable for a
    reader that observed ``want``? Generations only grow, and a builder
    records the generation it read BEFORE packing (content is at least
    that fresh), so >= is the right comparison."""
    if isinstance(want, tuple):
        if not isinstance(have, tuple) or len(have) != len(want):
            return False
        for h, w in zip(have, want):
            if w is None or h is None:
                if h is not w:
                    return False
            elif h < w:
                return False
        return True
    return have >= want


class DeviceStager:
    """Thread-safe: concurrent executor threads share one stager."""

    def __init__(self, device, budget_bytes: int = 8 << 30) -> None:
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self._cache: OrderedDict[tuple, _Entry] = OrderedDict()
        self._bytes = 0
        self._mu = OrderedLock("stager.mu")
        self._inflight: dict[tuple, _InFlight] = {}
        self.hits = 0
        self.misses = 0

    # -- internal --

    def _key(self, frag, kind: str, extra=()) -> tuple:
        # no generation: entries persist across mutations and track
        # their snapshot generation in _Entry.gen instead
        return (id(frag), kind) + tuple(extra)

    @staticmethod
    def _heat_stage(frag, nbytes: int, hit: bool) -> None:
        """Attribute a stager hit/miss to the heat ledger. ``frag`` is a
        fragment or a list of fragments (stacked forms — the uploaded
        bytes are split evenly across live members)."""
        if frag is None or not heat.LEDGER.enabled:
            return
        frags = frag if isinstance(frag, (list, tuple)) else (frag,)
        live = [f for f in frags if f is not None]
        if not live:
            return
        per = 0 if hit else int(nbytes) // len(live)
        for f in live:
            heat.LEDGER.record_stage(f.index, f.field, f.shard, per, hit)

    def _get_or_build(self, key, gen, builder: Callable, frag=None):
        """Return the staged value for ``key``, fresh w.r.t. the
        caller-observed generation token ``gen``. builder() ->
        (value, nbytes, built_gen) runs when no fresh entry exists; it
        captures built_gen BEFORE reading fragment state, so the
        recorded generation never overstates the content."""
        while True:
            with self._mu:
                ent = self._cache.get(key)
                if ent is not None and _gen_fresh(ent.gen, gen):
                    self._cache.move_to_end(key)
                    self.hits += 1
                    metrics.count(metrics.STAGER_HITS)
                    self._heat_stage(frag, 0, True)
                    return ent.value
                fl = self._inflight.get(key)
                if fl is None:
                    fl = _InFlight()
                    self._inflight[key] = fl
                    building = True
                    stale = ent
                else:
                    building = False
            if not building:
                fl.event.wait()
                if fl.error is not None:
                    raise fl.error
                if fl.gen is None or _gen_fresh(fl.gen, gen):
                    return fl.value
                # the build we joined predates our observed generation:
                # retry (the next lap restages or hits)
                continue
            try:
                t0 = time.monotonic()
                sp = trace.current()
                if sp is None:
                    value, nbytes, built_gen = builder()
                else:
                    with sp.child(metrics.STAGE_STAGE) as ssp:
                        value, nbytes, built_gen = builder()
                        ssp.annotate(nbytes=nbytes)
                dt = time.monotonic() - t0
                metrics.observe(metrics.STAGER_STAGE_SECONDS, dt)
                trace.attrib_add(trace.WF_STAGER, dt)
                metrics.count(metrics.STAGER_MISSES)
                self._heat_stage(frag, nbytes, False)
                if stale is None:
                    metrics.count(metrics.STAGER_MISSES_COLD)
                else:
                    # generation change: the whole entry was restaged
                    metrics.count(metrics.STAGER_MISSES_INVALIDATION)
                    metrics.count(metrics.STAGER_RESTAGED_BYTES, nbytes)
            except BaseException as e:
                with self._mu:
                    if self._inflight.get(key) is fl:
                        self._inflight.pop(key, None)
                fl.error = e
                fl.event.set()
                raise
            with self._mu:
                self.misses += 1
                old = self._cache.pop(key, None)
                if old is not None:
                    self._bytes -= old.nbytes
                self._cache[key] = _Entry(value, nbytes, built_gen)
                self._bytes += nbytes
                # evict LRU past the budget, always keeping the entry
                # just built
                while self._bytes > self.budget_bytes and len(self._cache) > 1:
                    _, old_ent = self._cache.popitem(last=False)
                    self._bytes -= old_ent.nbytes
                if self._inflight.get(key) is fl:
                    self._inflight.pop(key, None)
                metrics.gauge(metrics.STAGER_BYTES, self._bytes)
            fl.gen = built_gen
            fl.value = value
            fl.event.set()
            return value

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        return ops.words_from_numpy(words, self.device)

    # -- staging entry points --

    def row(self, frag, row_id: int):
        """i32[W] for one row."""

        def build():
            gen = frag.generation
            words = frag.row_words(row_id)
            return self._to_device(words), words.nbytes, gen

        return self._get_or_build(
            self._key(frag, "row", (row_id,)), frag.generation, build, frag=frag
        )

    def rows(self, frag, row_ids: tuple[int, ...], pad_pow2: bool = False):
        """i32[K, W] stack of specific rows.

        pad_pow2=True pads the row count up to the next power of two
        with zero rows, like the JAX package (whose shapes bound its
        compile cache). Zero rows score 0 and callers index results by
        the true row_ids. Only valid for scoring-style consumers."""
        kind = "rows_p2" if pad_pow2 else "rows"

        def build():
            gen = frag.generation
            words = frag.packed_rows(list(row_ids))
            if pad_pow2 and len(row_ids):
                target = _next_pow2(words.shape[0])
                if target > words.shape[0]:
                    words = np.pad(words, ((0, target - words.shape[0]), (0, 0)))
            return self._to_device(words), words.nbytes, gen

        return self._get_or_build(
            self._key(frag, kind, (row_ids,)), frag.generation, build, frag=frag
        )

    def sparse_rows(self, frag, row_ids: tuple[int, ...]):
        """Block-sparse candidate staging for single-shard TopN scoring:
        (blocks i32[B, 2048], block_row i32[B], block_slot i32[B],
        num_rows = len(row_ids)), exactly the set containers of the
        candidates: bytes staged scale with set containers, not
        candidates × 128 KB."""

        def build():
            gen = frag.generation
            blocks, brow, bslot = frag.sparse_row_blocks(list(row_ids))
            num_rows = len(row_ids)
            dev = (
                self._to_device(blocks),
                self._to_device(brow.astype(np.int32)),
                self._to_device(bslot.astype(np.int32)),
                num_rows,
            )
            return dev, blocks.nbytes + brow.nbytes + bslot.nbytes, gen

        return self._get_or_build(
            self._key(frag, "sparse_rows", (row_ids,)), frag.generation, build, frag=frag
        )

    # -- shard-batched staging (one tensor covering many fragments) ----------

    def _stack_key(self, frags, kind: str, extra=()) -> tuple:
        return (
            tuple(id(f) if f is not None else None for f in frags),
            kind,
        ) + tuple(extra)

    def _stack_gen(self, frags) -> tuple:
        return tuple(f.generation if f is not None else None for f in frags)

    def row_stack(self, frags, row_id: int):
        """i32[S, W]: one row across S fragments (None → zeros)."""

        def build():
            gens = self._stack_gen(frags)
            words = np.zeros((len(frags), SHARD_WIDTH // 64), dtype=np.uint64)
            for i, f in enumerate(frags):
                if f is not None:
                    words[i] = f.row_words(row_id)
            return self._to_device(words), words.nbytes, gens

        return self._get_or_build(
            self._stack_key(frags, "row_stack", (row_id,)),
            self._stack_gen(frags),
            build,
            frag=frags,
        )

    def sparse_rows_stacked(
        self, frags, ids_by_shard: tuple[tuple[int, ...], ...], chunk: int
    ):
        """Merged block-sparse candidate staging for ALL shards: one
        (blocks i32[B, 2048], global_row i32[B], slot i32[B],
        shard i32[B], num_rows) bundle, where global_row = shard_index
        * chunk + local candidate index. One kernel launch then scores
        the whole index's chunk (ops.sparse_intersection_counts_stacked).
        The value is None when no shard has candidate blocks."""

        def build():
            gens = self._stack_gen(frags)
            all_blocks, rows, slots, shardix = [], [], [], []
            for i, (f, ids) in enumerate(zip(frags, ids_by_shard)):
                if f is None or not ids:
                    continue
                b, br, bs = f.sparse_row_blocks(list(ids))
                if not b.shape[0]:
                    continue
                all_blocks.append(b)
                rows.append(br.astype(np.int32) + np.int32(i * chunk))
                slots.append(bs.astype(np.int32))
                shardix.append(np.full(bs.size, i, dtype=np.int32))
            num_rows = len(frags) * chunk
            if not all_blocks:
                return None, 0, gens
            blocks = np.concatenate(all_blocks)
            brow = np.concatenate(rows)
            bslot = np.concatenate(slots)
            bshard = np.concatenate(shardix)
            dev = (
                self._to_device(blocks),
                self._to_device(brow),
                self._to_device(bslot),
                self._to_device(bshard),
                num_rows,
            )
            nbytes = blocks.nbytes + brow.nbytes + bslot.nbytes + bshard.nbytes
            return dev, nbytes, gens

        return self._get_or_build(
            self._stack_key(frags, "sparse_stack", (chunk, ids_by_shard)),
            self._stack_gen(frags),
            build,
            frag=frags,
        )

    def planes(self, frag, bit_depth: int):
        """i32[bit_depth+1, W] BSI plane stack of one fragment (plane
        bit_depth is the not-null row)."""

        def build():
            gen = frag.generation
            words = frag.bsi_planes(bit_depth)
            return self._to_device(words), words.nbytes, gen

        return self._get_or_build(
            self._key(frag, "planes", (bit_depth,)), frag.generation, build, frag=frag
        )

    def planes_stack(self, frags, bit_depth: int):
        """i32[S, bit_depth+1, W] across S fragments (None → zeros); the
        BSI kernels read it in place through its strides."""

        def build():
            gens = self._stack_gen(frags)
            words = np.zeros((len(frags), bit_depth + 1, SHARD_WIDTH // 64), dtype=np.uint64)
            for i, f in enumerate(frags):
                if f is not None:
                    words[i] = f.bsi_planes(bit_depth)
            return self._to_device(words), words.nbytes, gens

        return self._get_or_build(
            self._stack_key(frags, "planes_stack", (bit_depth,)),
            self._stack_gen(frags),
            build,
            frag=frags,
        )

    def rows_stack(self, frags, row_ids: tuple[int, ...]):
        """i32[R, S, W]: R rows across S fragments (None → zeros) — a
        GroupBy dimension, staged as one tensor so the GroupBy kernel
        reads every row in place."""

        def build():
            gens = self._stack_gen(frags)
            words = np.zeros((len(row_ids), len(frags), SHARD_WIDTH // 64), dtype=np.uint64)
            for i, f in enumerate(frags):
                if f is not None and row_ids:
                    words[:, i] = f.packed_rows(list(row_ids))
            return self._to_device(words), words.nbytes, gens

        return self._get_or_build(
            self._stack_key(frags, "rows_stack", (tuple(row_ids),)),
            self._stack_gen(frags),
            build,
            frag=frags,
        )

    def clear(self) -> None:
        with self._mu:
            self._cache.clear()
            self._bytes = 0
            # builders still publish to current waiters through their
            # _InFlight object; nothing stale survives here
            self._inflight.clear()
