"""Device staging manager — the device-side cache of fragment state.

Fragments are the CPU source of truth (roaring + op log); queries run on
packed-word copies staged in device memory as ``int32`` tensors (the
bits of the JAX package's ``u32`` words). The port of
``pilosa_tpu/executor/stager.py``: entries are keyed by (fragment
identity, form) — the same staging keys — and remember the fragment
generation their tensor was built at.

SNAPSHOT + DELTA: a generation change does not restage the entry. On the
next use the stager replays the fragment's delta log onto the resident
tensor with one word-delta scatter (ops/delta.py, kernel K7), and
restages in full only when the log cannot prove continuity (bulk
imports, truncation) or the batch touches more than ``delta_max_ratio``
of the entry's words. A reader never accepts an entry older than the
generation it observed.

IN PLACE UNLESS HELD: when no reader holds the stale snapshot (the cache
entry holds the only reference to its tensor and no view shares its
storage), the scatter patches it in place; otherwise it patches a copy
and the reader keeps its snapshot. The batcher coalesces on the staged
tensor's identity (same live object ⇔ same snapshot), and a pending
batch holds its tensor, so a patch in place never mixes generations in
one launch. Every reader enqueues on PyTorch's current stream, the
default stream of each thread (the port sets no other), so kernels it
launched before the patch read the words before it.

Staged forms and their delta paths:
  * row                 — i32[W]           scatter into the one row
  * rows(pad_pow2)      — i32[K, W]        scatter into staged rows; deltas
                                           on other rows are dropped
  * row_stack           — i32[S, W]        per-shard scatter (None → zeros)
  * planes              — i32[D+1, W]      scatter into planes 0..D
  * planes_stack        — i32[S, D+1, W]   per-shard scatter
  * rows_stack          — i32[R, S, W]     GroupBy dimension rows; row r
                                           scatters into slot ids.index(r)
  * sparse_rows / sparse_rows_stacked      documented fallback: the
                                           block-sparse layout has no
                                           stable scatter target, so a
                                           generation change restages
                                           (counted as delta_fallback
                                           with its form)

TIERED STAGING (executor/tiering.py): the ``row``, ``rows`` and
``planes`` forms build from roaring container payloads, tier 1 first
(a host cache of payloads, ``tier1_max_bytes``), then the fragment.
When the dense/payload ratio clears ``compressed_min_ratio`` the
payloads cross to the card and ``ops.expand_blocks`` (kernel K6)
expands them there; otherwise the host assembles the dense block
(``_assemble``, the same function) and uploads it. The stacked forms
walk their fragments' words, as in the JAX package. A cold miss on a
key evicted under capacity pressure is a re-entry, charged to
``stager.restaged_bytes``.

Uploads go host → pinned memory → device without blocking the host
(``ops.words_from_numpy``). A cold key is staged ONCE: concurrent misses
wait on the first builder and receive the same tensor. Eviction is LRU
by byte budget, always keeping the entry just built.

HBM GOVERNOR (executor/hbm.py): with one attached (``set_governor``),
every staged byte is reserved in the process-wide ledger under the
entry's index, the budget becomes the stager's share of it, and cold
LRU entries are the governor's relief tier (``_evict_cold``). After a
device wedge the health gate's restore calls ``reset_after_wedge``: the
entries, their snapshot generations and the stager's ledger account go,
and builds hung in dead device calls can no longer publish.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from pilosa_tpu_torch import SHARD_WIDTH, ops
from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.executor.batcher import _next_pow2
from pilosa_tpu_torch.executor.tiering import Tier1Cache
from pilosa_tpu_torch.roaring.bitmap import CONTAINER_ARRAY, CONTAINER_RUN
from pilosa_tpu_torch.utils import heat, metrics, trace

_W32 = SHARD_WIDTH // 32  # words per staged row
# Compressed-upload ceiling: global bit coordinates of one upload stay
# below 2^31 (2048 rows x 2^20 bits), so they are exact as int32 and a
# 0xFFFFFFFF position pad lands past every real word.
_MAX_COMPRESSED_ROWS = (1 << 32) // SHARD_WIDTH // 2
# Capacity-evicted keys remembered for re-entry accounting.
_MAX_EVICTED_KEYS = 65536


def _split_entries(entries):
    """Container payloads by kind, in the flat bit space of one block
    (row_index * SHARD_WIDTH + slot * 2^16 + local): array-container bit
    offsets i64[P], inclusive run endpoints i64[N, 2], and the bitmap
    containers' words u32[D, 2048] with their word offsets i64[D]."""
    arr_base, arr, run_base, runs, dense, dword = [], [], [], [], [], []
    for i, slot, typ, payload in entries:
        base = i * SHARD_WIDTH + (slot << 16)
        if typ == CONTAINER_ARRAY:
            arr_base.append(base)
            arr.append(payload)
        elif typ == CONTAINER_RUN:
            run_base.append(base)
            runs.append(payload)
        else:
            dense.append(np.ascontiguousarray(payload).view("<u4"))
            dword.append(base >> 5)

    def spread(bases, parts, shape):
        if not parts:
            return np.empty(shape, np.int64)
        b = np.repeat(np.asarray(bases, np.int64), [len(p) for p in parts])
        v = np.concatenate(parts).astype(np.int64)
        return v + (b[:, None] if v.ndim == 2 else b)

    return (
        spread(arr_base, arr, (0,)),
        spread(run_base, runs, (0, 2)),
        np.stack(dense) if dense else np.empty((0, 2048), "<u4"),
        np.asarray(dword, np.int64),
    )


def _assemble(entries, num_words: int) -> np.ndarray:
    """The host twin of ``ops.expand_blocks``: u32[num_words] from
    container payloads, one vectorised pass per kind. Containers never
    share a word, so each word is written by one container."""
    words = np.zeros(num_words, dtype="<u4")
    pos, runs, dense, dword = _split_entries(entries)
    if pos.size:
        w = pos >> 5
        first = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
        bits = np.left_shift(np.uint32(1), (pos & 31).astype(np.uint32))
        words[w[first]] = np.bitwise_or.reduceat(bits, first)
    for s, e in runs.tolist():
        ws, we = s >> 5, e >> 5
        head = (0xFFFFFFFF << (s & 31)) & 0xFFFFFFFF
        tail = 0xFFFFFFFF >> (31 - (e & 31))
        if ws == we:
            words[ws] |= head & tail
            continue
        words[ws] |= head
        words[ws + 1 : we] = 0xFFFFFFFF
        words[we] |= tail
    if dword.size:
        words[dword[:, None] + np.arange(2048)] = dense
    return words


def _slots(row_ids, rows: np.ndarray) -> np.ndarray:
    """The block slot of each delta row: its index in ``row_ids``, or -1
    where the block does not stage that row."""
    slot_of = {int(r): k for k, r in enumerate(row_ids)}
    return np.fromiter((slot_of.get(int(r), -1) for r in rows), dtype=np.int64, count=rows.size)


class _InFlight:
    __slots__ = ("event", "value", "error", "gen")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.gen = None  # generation token the published value reflects


def _storage_uses(t: torch.Tensor) -> int:
    """The tensors (views included) that hold ``t``'s storage, plus the
    one storage object this call makes."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


class _Entry:
    __slots__ = ("value", "nbytes", "gen", "uses", "tenant")

    def __init__(self, value, nbytes: int, gen, tenant: str = "") -> None:
        self.value = value
        self.nbytes = nbytes
        self.gen = gen  # int, or tuple of per-fragment ints for stacks
        # owning index: the governor's per-index accounting and its
        # quota-preferring eviction; "" for untracked entries
        self.tenant = tenant
        # the storage's holders while only the cache holds the value (a
        # view keeps its base tensor too); None for the tuple forms
        self.uses = _storage_uses(value) if isinstance(value, torch.Tensor) else None

    def unheld(self) -> bool:
        """No reader holds this snapshot: the entry holds the only
        reference to its tensor, and no other tensor shares its storage.
        A Python refcount alone would miss the views readers make."""
        v = self.value
        # references to v: the entry's slot, ``v``, getrefcount's argument
        return self.uses is not None and sys.getrefcount(v) == 3 and _storage_uses(v) == self.uses


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
    """Thread-safe: concurrent executor threads share one stager.

    ``delta_enabled`` / ``delta_max_ratio``: patch resident tensors on a
    generation change, unless the batch touches more than that share of
    the entry's words. ``tier1_max_bytes`` > 0 adds the host container
    cache; ``compressed_min_ratio`` > 0 ships container payloads when
    the dense block is at least that many times larger. The defaults
    are the JAX server's staging settings (``pilosa_tpu/server/
    config.py``: 8 GiB, delta on at 0.25, tier 1 256 MiB, ratio 4.0),
    since the port has no server to pass them; the JAX DeviceStager's
    own constructor has no tier 1 and no compressed upload
    (``tier1_max_bytes=0, compressed_min_ratio=0``)."""

    def __init__(
        self,
        device,
        budget_bytes: int = 8 << 30,
        delta_enabled: bool = True,
        delta_max_ratio: float = 0.25,
        tier1_max_bytes: int = 256 << 20,
        compressed_min_ratio: float = 4.0,
    ) -> None:
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self.delta_enabled = delta_enabled
        self.delta_max_ratio = delta_max_ratio
        self.compressed_min_ratio = float(compressed_min_ratio)
        self.tier1 = Tier1Cache(tier1_max_bytes) if tier1_max_bytes > 0 else None
        self._cache: OrderedDict[tuple, _Entry] = OrderedDict()
        self._bytes = 0
        self._mu = OrderedLock("stager.mu")
        self._inflight: dict[tuple, _InFlight] = {}
        self.hits = 0
        self.misses = 0
        self.delta_applies = 0
        # delta applies by staged form (the key's kind: row, rows_p2,
        # row_stack, ...)
        self.delta_by_form: dict[str, int] = {}
        # delta applies that patched words, by route: in place, or into
        # a copy because a reader held the snapshot
        self.delta_routes = {"in_place": 0, "copied": 0}
        # keys dropped under capacity pressure: a later cold miss on one
        # is a RE-ENTRY, bytes an earlier stage already paid to upload
        self._evicted_keys: set = set()
        # process-wide HBM ledger (executor/hbm.py); None = standalone
        self.governor = None
        # bumped by reset_after_wedge: a build that started before the
        # reset must not publish into the reset cache
        self._epoch = 0

    # -- internal --

    @staticmethod
    def _tenant_of(frag) -> str:
        """Owning index name for a fragment (or stack of fragments —
        one field, one index); "" when untracked."""
        if frag is None:
            return ""
        if isinstance(frag, (list, tuple)):
            for f in frag:
                if f is not None:
                    return getattr(f, "index", "") or ""
            return ""
        return getattr(frag, "index", "") or ""

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

    def _note_evicted_locked(self, key: tuple) -> None:
        """A cache entry left under capacity pressure: remember its key
        so a later restage is attributed to oversubscription. Caller
        holds _mu."""
        if len(self._evicted_keys) >= _MAX_EVICTED_KEYS:
            # pathological key churn: reset rather than grow without bound
            self._evicted_keys.clear()
        self._evicted_keys.add(key)

    def _get_or_build(self, key, gen, builder: Callable, delta_fn: Optional[Callable] = None, frag=None):
        """Return the staged value for ``key``, fresh w.r.t. the
        caller-observed generation token ``gen``.

        builder() -> (value, nbytes, built_gen) runs when no usable
        entry exists. delta_fn(old_value, old_gen, in_place) ->
        (value, built_gen, n_updates) or None runs when an entry exists
        at an older generation, patching ``old_value`` itself when
        ``in_place``; None falls back to builder() (full restage). Both
        capture built_gen BEFORE reading fragment state, so the recorded
        generation never overstates the content."""
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
                    epoch = self._epoch
                    stale = ent
                    in_place = (
                        stale is not None
                        and delta_fn is not None
                        and self.delta_enabled
                        and stale.unheld()
                    )
                    if in_place:
                        # Race-free: the hit path above hands out entries
                        # only under _mu, so a reference taken before this
                        # point shows in unheld(), and none can be taken
                        # after it: the entry leaves the cache until the
                        # patched one is published, and readers of the key
                        # wait on ``fl`` meanwhile.
                        del self._cache[key]
                        self._bytes -= stale.nbytes
                else:
                    building = False
            if not building:
                fl.event.wait()
                if fl.error is not None:
                    raise fl.error
                if fl.gen is None or _gen_fresh(fl.gen, gen):
                    return fl.value
                # the build we joined predates our observed generation:
                # retry (the next lap hits or applies a delta)
                continue
            try:
                value = nbytes = built_gen = None
                if stale is not None and delta_fn is not None and self.delta_enabled:
                    t0 = time.monotonic()
                    sp = trace.current()
                    if sp is None:
                        res = delta_fn(stale.value, stale.gen, in_place)
                    else:
                        with sp.child(metrics.STAGE_DELTA) as ssp:
                            res = delta_fn(stale.value, stale.gen, in_place)
                            if res is not None:
                                ssp.annotate(nupdates=res[2])
                    if res is not None:
                        value, built_gen, _n = res
                        nbytes = stale.nbytes  # a delta never changes shape
                        dt = time.monotonic() - t0
                        with self._mu:
                            self.delta_applies += 1
                            self.delta_by_form[key[1]] = self.delta_by_form.get(key[1], 0) + 1
                            if _n:
                                self.delta_routes["in_place" if in_place else "copied"] += 1
                        metrics.count(metrics.STAGER_DELTA_APPLIED)
                        metrics.observe(metrics.STAGER_DELTA_APPLY_SECONDS, dt)
                        trace.attrib_add(trace.WF_STAGER, dt)
                if value is None:
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
                        # a generation change no delta could absorb: the
                        # re-uploaded bytes are what delta staging saves
                        metrics.count(metrics.STAGER_MISSES_INVALIDATION)
                        metrics.count(metrics.STAGER_RESTAGED_BYTES, nbytes)
                    with self._mu:
                        self.misses += 1
                        reentry = stale is None and key in self._evicted_keys
                        if reentry:
                            self._evicted_keys.discard(key)
                    if reentry:
                        # capacity re-entry: an upload already paid for
                        # once — what tiering exists to cheapen
                        metrics.count(metrics.STAGER_RESTAGED_BYTES, nbytes)
            except BaseException as e:
                with self._mu:
                    # identity check: a build from before a wedge reset
                    # must not drop a later build's in-flight entry
                    if self._inflight.get(key) is fl:
                        self._inflight.pop(key, None)
                    dropped = in_place and self._epoch == epoch
                if dropped and self.governor is not None:
                    # the entry left the cache for its patch and never came back
                    self.governor.release("stager", stale.nbytes, index=stale.tenant)
                fl.error = e
                fl.event.set()
                raise
            # ledger first, insert second: reserve may run the governor's
            # relief over other tenants, whose callbacks take their own
            # locks, so it must not run under _mu. An entry patched in
            # place never left the ledger.
            tenant = self._tenant_of(frag)
            gov = self.governor
            if gov is not None and not in_place:
                gov.reserve("stager", nbytes, index=tenant)
            gov_return: dict[str, int] = {}
            with self._mu:
                if self._epoch == epoch:
                    old = self._cache.pop(key, None)
                    if old is not None:
                        self._bytes -= old.nbytes
                        gov_return[old.tenant] = gov_return.get(old.tenant, 0) + old.nbytes
                    self._cache[key] = _Entry(value, nbytes, built_gen, tenant)
                    self._bytes += nbytes
                    # evict LRU past the budget (and past the governor's
                    # global budget), always keeping the entry just built
                    returned = sum(gov_return.values())
                    while (
                        self._bytes > self.budget_bytes
                        or (gov is not None and gov.over_budget() > returned)
                    ) and len(self._cache) > 1:
                        old_key, old_ent = self._cache.popitem(last=False)
                        self._bytes -= old_ent.nbytes
                        returned += old_ent.nbytes
                        gov_return[old_ent.tenant] = gov_return.get(old_ent.tenant, 0) + old_ent.nbytes
                        self._note_evicted_locked(old_key)
                    metrics.gauge(metrics.STAGER_BYTES, self._bytes)
                elif not in_place:
                    # built before a wedge reset: the value never enters
                    # the cache, so its reservation goes straight back
                    # (an entry patched in place left the ledger with the reset)
                    gov_return[tenant] = gov_return.get(tenant, 0) + nbytes
                if self._inflight.get(key) is fl:
                    self._inflight.pop(key, None)
            if gov is not None:
                for t, n in gov_return.items():
                    gov.release("stager", n, index=t)
            fl.gen = built_gen
            fl.value = value
            fl.event.set()
            return value

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        return ops.words_from_numpy(words, self.device)

    # -- tiered dense builds (executor/tiering.py) ---------------------------

    def _container_entries(self, frag, row_ids):
        """Container payloads for ``row_ids``, tier 1 first: a hit skips
        the fragment walk; a miss walks the fragment and offers the
        result to tier 1 with the walk's measured cost."""
        t1 = self.tier1
        if t1 is not None:
            entries = t1.get(frag, row_ids)
            if entries is not None:
                return entries
        gen = frag.generation  # before the walk: content at least this fresh
        t0 = time.monotonic()
        entries, nbytes = frag.container_blocks(list(row_ids))
        cost = time.monotonic() - t0
        if t1 is not None:
            t1.put(frag, row_ids, entries, nbytes, gen, cost)
        return entries

    def _dense_from_blocks(self, frag, row_ids, rows_total: int):
        """i32[rows_total, W] for ``row_ids`` (zero rows past them) built
        from container payloads. Returns (tensor, dense bytes). When the
        dense/payload ratio clears ``compressed_min_ratio`` the payloads
        cross to the card and K6 expands them; otherwise the block is
        assembled on the host and uploaded."""
        entries = self._container_entries(frag, row_ids)
        num_words = rows_total * _W32
        dense_nbytes = num_words * 4
        cbytes = sum(p.nbytes for _, _, _, p in entries)
        if (
            self.compressed_min_ratio > 0
            and cbytes
            and rows_total <= _MAX_COMPRESSED_ROWS
            and dense_nbytes >= self.compressed_min_ratio * cbytes
        ):
            out = self._compressed_upload(entries, num_words)
            return out.view(rows_total, _W32), dense_nbytes
        return self._to_device(_assemble(entries, num_words).reshape(rows_total, _W32)), dense_nbytes

    def _compressed_upload(self, entries, num_words: int) -> torch.Tensor:
        """Ship container payloads and expand them on the device: each
        entry's bits become coordinates in the block's flat bit space
        (row_index * SHARD_WIDTH + slot * 2^16 + local), bitmap
        containers their words at their word offset. One container is
        one of K6's spans, so payloads in container order are binned by
        span; their offsets cross with them. One pinned upload carries
        every array, sliced on the device; nothing is padded (the kernel
        builds nothing per shape)."""
        span = np.fromiter((i * 16 + slot for i, slot, _, _ in entries), np.int64, len(entries))
        if np.any(span[1:] < span[:-1]):
            entries = [entries[k] for k in np.argsort(span, kind="stable")]
        pos, runs, dense_w, dword_a = _split_entries(entries)
        edges = np.arange(-(-num_words // ops.CONTAINER_WORDS) + 1)
        offsets = np.stack(
            [
                np.searchsorted(pos >> 16, edges),
                np.searchsorted(runs[:, 0] >> 16, edges),
                np.searchsorted(dword_a // ops.CONTAINER_WORDS, edges),
            ]
        )
        # dense words first: the buffer's base is aligned for the kernel
        parts = [
            dense_w.reshape(-1),
            pos.astype(np.uint32),
            runs[:, 0].astype(np.uint32),
            runs[:, 1].astype(np.uint32),
            dword_a.astype(np.uint32),
            offsets.reshape(-1).astype(np.uint32),
        ]
        buf = self._to_device(np.concatenate(parts))
        views, off = [], 0
        for p in parts:
            views.append(buf[off : off + p.size])
            off += p.size
        dense, positions, starts, ends, dword, offs = views
        out = ops.expand_blocks(
            positions,
            starts,
            ends,
            dense.view(dense_w.shape[0], 2048),
            dword,
            num_words,
            offs.view(offsets.shape),
        )
        metrics.count(metrics.TIERING_COMPRESSED_UPLOADS)
        metrics.count(metrics.TIERING_UPLOAD_BYTES_SAVED, max(0, num_words * 4 - buf.numel() * 4))
        return out

    # -- delta helpers -------------------------------------------------------

    def _fallback(self, reason: str, form: Optional[str] = None) -> None:
        if form is None:
            metrics.count(metrics.STAGER_DELTA_FALLBACK, reason=reason)
            return
        # the form rides as a second label and on the current trace
        # stage, so a tail of full restages names the layout behind it
        metrics.count(metrics.STAGER_DELTA_FALLBACK, reason=reason, form=form)
        sp = trace.current()
        if sp is not None:
            sp.annotate(fallback_form=form)

    def _deltas(self, frag, since_gen):
        """The fragment's delta stream since ``since_gen`` split into
        row / word-in-row / bit coordinates, or None (+ fallback)."""
        d = frag.deltas_since(since_gen)
        if d is None:
            self._fallback("log")
            return None
        pos, is_set, gen = d
        rows = (pos // np.uint64(SHARD_WIDTH)).astype(np.int64)
        local = (pos % np.uint64(SHARD_WIDTH)).astype(np.int64)
        return rows, local >> 5, (local & 31), is_set, gen

    def _scatter(self, dev, word_idx, bit_idx, is_set, gen, n_slots_words, in_place: bool):
        """Coalesce and run the delta scatter over a flat word space of
        ``n_slots_words`` words, into ``dev`` itself when ``in_place``
        and into a copy otherwise; returns (tensor, gen, K), or None when
        the batch is too large to beat a restage."""
        if word_idx.size == 0:
            return dev, gen, 0
        idx, om, am = ops.coalesce_bit_updates(word_idx, bit_idx, is_set)
        if idx.size > int(self.delta_max_ratio * n_slots_words):
            self._fallback("ratio")
            return None
        if in_place:
            return ops.apply_word_updates_(dev, idx, om, am), gen, int(idx.size)
        return ops.apply_word_updates(dev, idx, om, am), gen, int(idx.size)

    def _delta_for_slots(self, frag, row_ids, n_rows_staged: int):
        """delta_fn for forms staging a fixed set of rows as [K, W]:
        row_ids[k] is block row k. Deltas on other rows don't touch the
        block and are dropped."""

        def delta(old, old_gen, in_place):
            d = self._deltas(frag, old_gen)
            if d is None:
                return None
            rows, widx, bidx, is_set, gen = d
            if rows.size:
                slots = _slots(row_ids, rows)
                keep = slots >= 0
                widx = slots[keep] * _W32 + widx[keep]
                bidx = bidx[keep]
                is_set = is_set[keep]
            return self._scatter(old, widx, bidx, is_set, gen, n_rows_staged * _W32, in_place)

        return delta

    def _sparse_fallback_for(self, form: str):
        """Documented non-path: block-sparse forms restage on a
        generation change (a write can occupy a container the form did
        not stage). ``form`` names the layout in the fallback metric."""

        def fallback(old, old_gen, in_place):
            self._fallback("sparse_form", form=form)
            return None

        return fallback

    # -- staging entry points --

    def row(self, frag, row_id: int):
        """i32[W] for one row."""

        def build():
            gen = frag.generation
            dev, nbytes = self._dense_from_blocks(frag, (row_id,), 1)
            return dev.view(_W32), nbytes, gen

        return self._get_or_build(
            self._key(frag, "row", (row_id,)),
            frag.generation,
            build,
            self._delta_for_slots(frag, (row_id,), 1),
            frag=frag,
        )

    def rows(self, frag, row_ids: tuple[int, ...], pad_pow2: bool = False):
        """i32[K, W] stack of specific rows.

        pad_pow2=True pads the row count up to the next power of two
        with zero rows, like the JAX package (whose shapes bound its
        compile cache). Zero rows score 0 and callers index results by
        the true row_ids. Only valid for scoring-style consumers."""
        kind = "rows_p2" if pad_pow2 else "rows"
        nrows = len(row_ids)
        if pad_pow2 and nrows:
            nrows = _next_pow2(nrows)

        def build():
            gen = frag.generation
            dev, nbytes = self._dense_from_blocks(frag, row_ids, nrows)
            return dev, nbytes, gen

        return self._get_or_build(
            self._key(frag, kind, (row_ids,)),
            frag.generation,
            build,
            self._delta_for_slots(frag, row_ids, nrows),
            frag=frag,
        )

    def sparse_rows(self, frag, row_ids: tuple[int, ...]):
        """Block-sparse candidate staging for single-shard TopN scoring:
        (blocks i32[B, 2048], block_row i32[B], block_slot i32[B],
        num_rows = len(row_ids)), exactly the set containers of the
        candidates: bytes staged scale with set containers, not
        candidates × 128 KB. An ``ops.SparseBundle``: its ``groups`` is
        K2's grouping of the blocks. No delta path (see
        _sparse_fallback_for)."""

        def build():
            gen = frag.generation
            blocks, brow, bslot = frag.sparse_row_blocks(list(row_ids))
            num_rows = len(row_ids)
            groups = ops.sparse_groups(
                brow, bslot, None, num_rows, 1, ops.CONTAINERS_PER_ROW, device=self.device
            )
            dev = ops.SparseBundle(
                (
                    self._to_device(blocks),
                    self._to_device(brow.astype(np.int32)),
                    self._to_device(bslot.astype(np.int32)),
                    num_rows,
                ),
                groups,
            )
            return dev, blocks.nbytes + brow.nbytes + bslot.nbytes + groups.nbytes, gen

        return self._get_or_build(
            self._key(frag, "sparse_rows", (row_ids,)),
            frag.generation,
            build,
            self._sparse_fallback_for("sparse_rows"),
            frag=frag,
        )

    def planes(self, frag, bit_depth: int):
        """i32[bit_depth+1, W] BSI plane stack of one fragment (plane
        bit_depth is the not-null row)."""

        def build():
            gen = frag.generation
            dev, nbytes = self._dense_from_blocks(frag, tuple(range(bit_depth + 1)), bit_depth + 1)
            return dev, nbytes, gen

        # plane p is row p; rows above the staged depth are not in this
        # block (a deeper write keys a different planes(depth) entry)
        return self._get_or_build(
            self._key(frag, "planes", (bit_depth,)),
            frag.generation,
            build,
            self._delta_for_slots(frag, range(bit_depth + 1), bit_depth + 1),
            frag=frag,
        )

    # -- shard-batched staging (one tensor covering many fragments) ----------

    def _stack_key(self, frags, kind: str, extra=()) -> tuple:
        return (
            tuple(id(f) if f is not None else None for f in frags),
            kind,
        ) + tuple(extra)

    def _stack_gen(self, frags) -> tuple:
        return tuple(f.generation if f is not None else None for f in frags)

    def _delta_for_stack(self, frags, slots_of, shard_stride: int, slot_stride: int, total: int):
        """delta_fn for stacks over S fragments: fragment i's delta on
        row r lands at flat word i * shard_stride + slot * slot_stride +
        word, where ``slots_of(rows)`` gives each delta row's slot (-1
        drops it); one combined scatter over the ``total`` words."""

        def delta(old, old_gens, in_place):
            all_w, all_b, all_s = [], [], []
            new_gens = list(old_gens)
            for i, f in enumerate(frags):
                if f is None:
                    continue
                if old_gens[i] is None:
                    # stable keys pin which positions are None
                    self._fallback("log")
                    return None
                if f.generation == old_gens[i]:
                    continue
                d = self._deltas(f, old_gens[i])
                if d is None:
                    return None
                rows, widx, bidx, is_set, gen = d
                new_gens[i] = gen
                if rows.size == 0:
                    continue
                slots = slots_of(rows)
                keep = slots >= 0
                if not keep.any():
                    continue
                all_w.append(i * shard_stride + slots[keep] * slot_stride + widx[keep])
                all_b.append(bidx[keep])
                all_s.append(is_set[keep])
            gen_t = tuple(new_gens)
            if not all_w:
                return old, gen_t, 0
            return self._scatter(
                old,
                np.concatenate(all_w),
                np.concatenate(all_b),
                np.concatenate(all_s),
                gen_t,
                total,
                in_place,
            )

        return delta

    def row_stack(self, frags, row_id: int):
        """i32[S, W]: one row across S fragments (None → zeros)."""

        def build():
            gens = self._stack_gen(frags)
            words = np.zeros((len(frags), SHARD_WIDTH // 64), dtype=np.uint64)
            for i, f in enumerate(frags):
                if f is not None:
                    words[i] = f.row_words(row_id)
            return self._to_device(words), words.nbytes, gens

        delta = self._delta_for_stack(
            frags, lambda rows: np.where(rows == row_id, 0, -1), _W32, _W32, len(frags) * _W32
        )
        return self._get_or_build(
            self._stack_key(frags, "row_stack", (row_id,)),
            self._stack_gen(frags),
            build,
            delta,
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
        An ``ops.SparseBundle``: its ``groups`` is K2's grouping of the
        blocks by (shard, slot). The value is None when no shard has
        candidate blocks. No delta path (see _sparse_fallback_for)."""

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
            groups = ops.sparse_groups(
                brow, bslot, bshard, num_rows, len(frags), ops.CONTAINERS_PER_ROW, device=self.device
            )
            dev = ops.SparseBundle(
                (
                    self._to_device(blocks),
                    self._to_device(brow),
                    self._to_device(bslot),
                    self._to_device(bshard),
                    num_rows,
                ),
                groups,
            )
            nbytes = blocks.nbytes + brow.nbytes + bslot.nbytes + bshard.nbytes + groups.nbytes
            return dev, nbytes, gens

        return self._get_or_build(
            self._stack_key(frags, "sparse_stack", (chunk, ids_by_shard)),
            self._stack_gen(frags),
            build,
            self._sparse_fallback_for("sparse_stack"),
            frag=frags,
        )

    def planes_stack(self, frags, bit_depth: int):
        """i32[S, bit_depth+1, W] across S fragments (None → zeros); the
        BSI kernels read it in place through its strides."""
        per = (bit_depth + 1) * _W32

        def build():
            gens = self._stack_gen(frags)
            words = np.zeros((len(frags), bit_depth + 1, SHARD_WIDTH // 64), dtype=np.uint64)
            for i, f in enumerate(frags):
                if f is not None:
                    words[i] = f.bsi_planes(bit_depth)
            return self._to_device(words), words.nbytes, gens

        delta = self._delta_for_stack(
            frags, lambda rows: np.where(rows <= bit_depth, rows, -1), per, _W32, len(frags) * per
        )
        return self._get_or_build(
            self._stack_key(frags, "planes_stack", (bit_depth,)),
            self._stack_gen(frags),
            build,
            delta,
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

        # row r's words sit at [slot, shard, :]: shard stride W, slot
        # stride S * W
        delta = self._delta_for_stack(
            frags,
            lambda rows: _slots(row_ids, rows),
            _W32,
            len(frags) * _W32,
            len(row_ids) * len(frags) * _W32,
        )
        return self._get_or_build(
            self._stack_key(frags, "rows_stack", (tuple(row_ids),)),
            self._stack_gen(frags),
            build,
            delta,
            frag=frags,
        )

    def usage(self) -> tuple[int, int]:
        """(staged bytes, staged entries), read together."""
        with self._mu:
            return self._bytes, len(self._cache)

    def set_governor(self, governor) -> None:
        """Attach the process-wide HBM governor (executor/hbm.py): the
        budget becomes this stager's tenant share, cold LRU entries its
        relief tier (tier 1), and bytes already staged join the ledger.
        Tier 1's host bytes join it as a host-domain tenant."""
        self.governor = governor
        if governor is None:
            return
        governor.register(
            "stager",
            share_bytes=self.budget_bytes,
            evict_fn=self._evict_cold,
            tier=1,
        )
        with self._mu:
            by_tenant: dict[str, int] = {}
            for ent in self._cache.values():
                by_tenant[ent.tenant] = by_tenant.get(ent.tenant, 0) + ent.nbytes
        for t, n in by_tenant.items():
            governor.reserve("stager", n, index=t)
        if self.tier1 is not None:
            self.tier1.set_governor(governor)

    def _evict_cold(self, need: int, prefer=None) -> int:
        """Governor relief tier: drop cold (LRU) entries until ``need``
        bytes are freed, always keeping the hottest entry. With
        ``prefer`` (indexes over their quota) only those indexes'
        entries go, coldest first. Called by the governor without its
        lock held; the releases keep the ledger exact. A tensor a reader
        still holds lives until the reader drops it; the caching
        allocator reuses its block after that."""
        freed = 0
        freed_by: dict[str, int] = {}
        with self._mu:
            if prefer is not None:
                wanted = set(prefer)
                victims = [k for k, ent in self._cache.items() if ent.tenant in wanted]
                for k in victims:
                    if freed >= need or len(self._cache) <= 1:
                        break
                    ent = self._cache.pop(k)
                    self._bytes -= ent.nbytes
                    freed += ent.nbytes
                    freed_by[ent.tenant] = freed_by.get(ent.tenant, 0) + ent.nbytes
                    self._note_evicted_locked(k)
            else:
                while freed < need and len(self._cache) > 1:
                    k, ent = self._cache.popitem(last=False)
                    self._bytes -= ent.nbytes
                    freed += ent.nbytes
                    freed_by[ent.tenant] = freed_by.get(ent.tenant, 0) + ent.nbytes
                    self._note_evicted_locked(k)
            if freed:
                metrics.gauge(metrics.STAGER_BYTES, self._bytes)
        if freed and self.governor is not None:
            for t, n in freed_by.items():
                self.governor.release("stager", n, index=t)
        return freed

    def reset_after_wedge(self) -> None:
        """Recover from a device wedge (the health gate's restore calls
        it): drop every staged tensor, with its snapshot generation, so
        no delta ever replays onto a dead context's tensor, and fail the
        in-flight builds hung in dead device calls so new queries
        rebuild instead of waiting on them forever. Safe because ``_mu``
        is never held across a device call. Tier 1's host payloads stay
        for the restage."""
        with self._mu:
            self._cache.clear()
            self._bytes = 0
            self._epoch += 1  # builds hung across the reset must not publish
            self._evicted_keys.clear()  # a wedge is not capacity pressure
            stale, self._inflight = self._inflight, {}
        if self.governor is not None:
            self.governor.reset("stager")
        for fl in stale.values():
            if not fl.event.is_set():
                fl.error = RuntimeError("staging abandoned: device wedged")
                fl.event.set()

    def clear(self) -> None:
        with self._mu:
            self._cache.clear()
            self._bytes = 0
            # builders still publish to current waiters through their
            # _InFlight object; nothing stale survives here
            self._inflight.clear()
            # an explicit clear is not capacity pressure
            self._evicted_keys.clear()
        if self.governor is not None:
            self.governor.reset("stager")
        if self.tier1 is not None:
            # fragment identities may be recycled after a clear: host
            # payloads keyed by id() go too
            self.tier1.clear()
