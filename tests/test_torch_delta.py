"""The port's word-delta scatter and delta-refreshing stager against the
JAX package's, on the CPU (the kernel K7's plain version).

* ``ops/delta.py``: ``coalesce_*``, ``pad_updates``,
  ``apply_word_updates(_2d)`` and ``apply_position_wave`` against
  ``pilosa_tpu.ops.delta`` on seeded inputs, all-ones words and padded
  indexes included; every output ==.
* ``DeviceStager(device="cpu")`` against ``pilosa_tpu.executor.
  DeviceStager`` on copies of one data directory across a write
  sequence, for the ``row``, ``rows(pad_pow2)``, ``planes``,
  ``row_stack``, ``planes_stack`` (and the port's ``rows_stack``)
  forms: each absorbs writes as deltas, and the fallbacks ``ratio``,
  ``log`` and ``sparse_form`` restage.
* In place unless held: an unheld entry is patched in its own storage,
  one whose view a reader holds is refreshed into a copy (the row and
  the shard-stack forms), and a reader meeting an in-place refresh
  waits for it.
* An executor gauntlet: JAX ``Executor(device_policy="always")``, the
  port's device leg on the CPU and its CPU roaring leg on interleaved
  ``Set``/``Clear``/``SetValue`` and reads.
"""

import shutil

import numpy as np
import pytest
import torch

from pilosa_tpu.core import FieldOptions as JaxFieldOptions
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import DeviceStager as JaxStager
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.ops import delta as jdelta

import pilosa_tpu_torch
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import delta as tdelta
from pilosa_tpu_torch.executor import DeviceStager
from pilosa_tpu_torch.utils import metrics

SW = 1 << 20
W32 = SW // 32


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view("<i4").copy())


def _np(t) -> np.ndarray:
    return t.contiguous().numpy().view("<u4")


def _jax_like(**kw) -> DeviceStager:
    """A port stager built as the JAX DeviceStager's defaults build one:
    no tier 1, no compressed upload."""
    return DeviceStager("cpu", tier1_max_bytes=0, compressed_min_ratio=0.0, **kw)


def _words(rng, shape) -> np.ndarray:
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    a.reshape(-1)[: shape[-1]] = 0xFFFFFFFF  # all-ones words catch sign bugs
    return a


def _stream(rng, n, total_words):
    word = rng.integers(0, total_words, size=n)
    word[: n // 4] = word[0]  # repeated words: the last op per bit wins
    return word, rng.integers(0, 32, size=n), rng.random(n) < 0.6


# -- ops/delta.py ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 200, 3000])
def test_coalesce_and_pad_match_jax(n):
    rng = np.random.default_rng(n)
    word, bit, is_set = _stream(rng, n, 5 * W32)
    want = jdelta.coalesce_bit_updates(word, bit, is_set)
    got = ops.coalesce_bit_updates(word, bit, is_set)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(tdelta.pad_updates(*got, 5 * W32), jdelta.pad_updates(*want, 5 * W32)):
        assert np.array_equal(g, w)
    pos = word.astype(np.int64) * 32 + bit
    for g, w in zip(
        tdelta.coalesce_position_updates(pos, is_set), jdelta.coalesce_position_updates(pos, is_set)
    ):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("shape", [(W32,), (3, 4096), (2, 5, 2048)])
@pytest.mark.parametrize("padded", [False, True])
def test_apply_word_updates_matches_jax(shape, padded):
    rng = np.random.default_rng(sum(shape) + padded)
    words = _words(rng, shape)
    total = words.size
    idx, om, am = jdelta.coalesce_bit_updates(*_stream(rng, 300, total))
    om[0] = 0xFFFFFFFF  # a full-word set and a full-word clear
    am[-1] = 0xFFFFFFFF
    om[-1] = 0
    if padded:
        idx, om, am = jdelta.pad_updates(idx, om, am, total)
    want = np.asarray(jdelta.apply_word_updates(words, idx, om, am))
    src = _t(words).view(shape)
    got = ops.apply_word_updates(src, idx, om, am)
    assert got.shape == src.shape and np.array_equal(_np(got), want)
    # a new tensor: the staged input is never patched in place
    assert got.data_ptr() != src.data_ptr() and np.array_equal(_np(src), words)
    assert np.array_equal(_np(ops.apply_word_updates_plain(src, _t(idx), _t(om), _t(am))), want)


@pytest.mark.parametrize("s,m", [(1, 4096), (4, 2048), (7, 1000)])
def test_apply_word_updates_2d_matches_jax(s, m):
    rng = np.random.default_rng(s * m)
    words = _words(rng, (s, m))
    k = 257
    shard = rng.integers(0, s, size=k).astype(np.int32)
    word = rng.integers(0, m, size=k).astype(np.int32)
    # unique (shard, word) pairs, as coalesced updates are
    _, first = np.unique(shard.astype(np.int64) * m + word, return_index=True)
    shard, word = shard[first], word[first]
    om = rng.integers(0, 2**32, size=shard.size, dtype=np.uint32)
    am = rng.integers(0, 2**32, size=shard.size, dtype=np.uint32) & ~om
    shard[-3:] = s  # the contract's padding: shard == S, dropped
    want = np.asarray(jdelta.apply_word_updates_2d(words, shard, word, om, am))
    got = ops.apply_word_updates_2d(_t(words).view(s, m), shard, word, om, am)
    assert np.array_equal(_np(got), want)


def test_apply_position_wave_matches_jax():
    rng = np.random.default_rng(8)
    words = _words(rng, (4, W32))
    pos = rng.integers(0, 4 * SW, size=500)
    is_set = rng.random(500) < 0.7
    want = np.asarray(jdelta.apply_position_wave(words, pos, is_set))
    got = tdelta.apply_position_wave(_t(words).view(4, W32), pos, is_set)
    assert np.array_equal(_np(got), want)


# -- the stager across writes -----------------------------------------------------------


def _build(path) -> None:
    rng = np.random.default_rng(31)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index("d")
    f = idx.create_field("f")
    rids, cids = [], []
    for shard in range(2):
        for r in range(12):
            rids += [r] * 40
            cids += (shard * SW + rng.integers(0, SW, size=40)).tolist()
    f.import_bits(rids, cids)
    v = idx.create_field("v", JaxFieldOptions(type="int", min=0, max=4000))
    cols = rng.choice(2 * SW, size=300, replace=False)
    v.import_values(cols.tolist(), rng.integers(0, 4001, size=300).tolist())
    h.close()


class _Pair:
    """The same data directory opened by both packages."""

    def __init__(self, base, tmp) -> None:
        jdir, tdir = tmp / "jax", tmp / "torch"
        shutil.copytree(base, jdir)
        shutil.copytree(base, tdir)
        self.jh = JaxHolder(str(jdir))
        self.jh.open()
        self.th = pilosa_tpu_torch.holder_from_dir(str(tdir))

    def frags(self, field="f", view="standard"):
        j = [self.jh.fragment("d", field, view, s) for s in range(2)]
        t = [self.th.fragment("d", field, view, s) for s in range(2)]
        return j, t

    def fields(self, name):
        return self.jh.field("d", name), self.th.field("d", name)

    def close(self) -> None:
        self.jh.close()
        self.th.close()


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("delta_holder")
    _build(d)
    return d


@pytest.fixture
def pair(base, tmp_path):
    p = _Pair(base, tmp_path)
    yield p
    p.close()


def _fallbacks():
    return {
        k: v for k, v in metrics.snapshot().items()
        if k.startswith(metrics.STAGER_DELTA_FALLBACK) and not isinstance(v, dict)
    }


def _grew(before, after, reason, form=None) -> bool:
    def n(snap):
        return sum(
            v for k, v in snap.items()
            if f"reason:{reason}" in k and (form is None or f"form:{form}" in k)
        )

    return n(after) > n(before)


FORMS = ("row", "rows_p2", "planes", "row_stack", "planes_stack")


def _stage(stager, form, frags, vfrags, depth):
    if form == "row":
        return stager.row(frags[1], 3)
    if form == "rows_p2":
        return stager.rows(frags[0], (0, 3, 5, 11, 2), pad_pow2=True)
    if form == "planes":
        return stager.planes(vfrags[0], depth)
    if form == "row_stack":
        return stager.row_stack(frags, 3)
    return stager.planes_stack(vfrags, depth)


def _write(rng, pair, step):
    """Step 3k sets a bit, 3k+1 sets and clears two (one stays clear),
    3k+2 sets a BSI value; the column's shard alternates."""
    jf, tf = pair.fields("f")
    jv, tv = pair.fields("v")
    col = int(rng.integers(0, SW)) + (step // 3 % 2) * SW
    if step % 3 == 2:
        val = int(rng.integers(0, 4001))
        for v in (jv, tv):
            v.set_value(col, val)
        return
    row = int(rng.choice([0, 2, 3, 5, 11]))
    for f in (jf, tf):
        f.set_bit(row, col)
        if step % 3 == 1:
            f.set_bit(row, col ^ 1)
            f.clear_bit(row, col)


@pytest.mark.parametrize("form", FORMS)
def test_stager_form_delta_matches_jax(pair, form):
    """One form staged in both stagers, refreshed across writes: equal to
    the JAX stager's array at every step, and the port absorbed the
    writes as deltas, not restages."""
    jfr, tfr = pair.frags()
    jvf, tvf = pair.frags("v", "bsig_v")
    depth = pair.th.field("d", "v").bsi_group("v").bit_depth()
    js, ts = JaxStager(), _jax_like()
    rng = np.random.default_rng(len(form))
    _stage(ts, form, tfr, tvf, depth)
    for step in range(9):
        _write(rng, pair, step)
        want = np.asarray(_stage(js, form, jfr, jvf, depth))
        got = _stage(ts, form, tfr, tvf, depth)
        assert np.array_equal(_np(got).reshape(want.shape), want), (form, step)
    assert ts.delta_applies > 0 and ts.misses == 1


def test_rows_stack_delta_matches_fragments(pair):
    """The port's GroupBy dimension form: row r's writes land at slot
    ids.index(r) of every shard."""
    _, tfr = pair.frags()
    ts = DeviceStager("cpu")
    ids = (11, 3, 5)
    ts.rows_stack(tfr, ids)
    rng = np.random.default_rng(4)
    for step in range(6):
        _write(rng, pair, 3 * step)
        got = _np(ts.rows_stack(tfr, ids))
        for k, r in enumerate(ids):
            for s in range(2):
                assert np.array_equal(got.reshape(3, 2, W32)[k, s], tfr[s].row_words(r).view("<u4"))
    assert ts.delta_applies == 6 and ts.misses == 1


@pytest.mark.parametrize("reason", ["ratio", "log", "sparse_form"])
def test_stager_fallbacks_restage_exactly(pair, reason):
    jfr, tfr = pair.frags()
    ts = _jax_like(delta_max_ratio=0.0 if reason == "ratio" else 0.25)
    js = JaxStager()
    ids = (0, 3, 5)

    def stage(st, frags):
        if reason == "sparse_form":
            return st.sparse_rows(frags[0], ids)[0]
        return st.row(frags[0], 3)

    stage(ts, tfr)
    if reason == "log":
        tfr[0].delta_log_max = 4
    before = _fallbacks()
    jf, tf = pair.fields("f")
    for i in range(8 if reason == "log" else 1):
        for f in (jf, tf):
            f.set_bit(3, 1000 + 7 * i)
    got = stage(ts, tfr)
    if reason == "sparse_form":
        # the JAX form pads its blocks to a power of two; the port stages
        # exactly the set containers, so a fresh port stager is the bar
        want = _np(stage(DeviceStager("cpu"), tfr))
    else:
        want = np.asarray(stage(js, jfr))
    assert np.array_equal(_np(got), want)
    form = "sparse_rows" if reason == "sparse_form" else None
    assert _grew(before, _fallbacks(), reason, form)
    assert ts.delta_applies == 0 and ts.misses == 2


def test_delta_disabled_restages(pair):
    _, tfr = pair.frags()
    ts = DeviceStager("cpu", delta_enabled=False)
    ts.row(tfr[0], 5)
    pair.th.field("d", "f").set_bit(5, 4242)
    assert np.array_equal(_np(ts.row(tfr[0], 5)), tfr[0].row_words(5).view("<u4"))
    assert ts.delta_applies == 0 and ts.misses == 2


def test_delta_refresh_keeps_bytes_and_makes_new_tensor(pair):
    _, tfr = pair.frags()
    ts = DeviceStager("cpu")
    first = ts.row(tfr[0], 0)
    b0 = ts._bytes
    keep = first.clone()
    for i in range(4):
        pair.th.field("d", "f").set_bit(0, 2000 + i)
        again = ts.row(tfr[0], 0)
        assert again is not first
    assert ts._bytes == b0
    # the entry a reader already holds is untouched by later writes
    assert torch.equal(first, keep)


# -- in place, or a copy when a reader holds the snapshot --------------------------------


@pytest.mark.parametrize("form", ["row", "row_stack"])
@pytest.mark.parametrize("held", [False, True])
def test_refresh_in_place_unless_held(pair, form, held):
    """An entry no reader holds is patched in place (same storage); one
    whose view a reader holds across the write is refreshed into a copy,
    and the reader's view keeps the old snapshot. Either way the new
    words equal the JAX package's apply_word_updates on the old ones.
    ``row_stack`` refreshes through the stack delta (_delta_for_stack)."""
    _, tfr = pair.frags()
    ts = DeviceStager("cpu")

    def stage():
        return ts.row(tfr[1], 3) if form == "row" else ts.row_stack(tfr, 3)

    first = stage()
    ptr, old = first.data_ptr(), _np(first).copy()
    view = first.view(-1)[:64] if held else None
    del first
    rng = np.random.default_rng(held)
    cols = rng.choice(SW, size=12, replace=False)
    shards = np.arange(cols.size) % 2 if form == "row_stack" else np.ones(cols.size, np.int64)
    is_set = np.arange(cols.size) % 3 != 0
    f = pair.th.field("d", "f")
    for c, sh, st in zip(cols, shards, is_set):
        (f.set_bit if st else f.clear_bit)(3, int(sh) * SW + int(c))
    # the staged block's flat bit positions of the writes
    flat = cols if form == "row" else shards * SW + cols
    want = np.asarray(jdelta.apply_position_wave(old, flat, is_set))
    got = stage()
    assert np.array_equal(_np(got).reshape(-1), want.reshape(-1))
    assert (got.data_ptr() == ptr) is not held
    assert ts.delta_routes == {"in_place": int(not held), "copied": int(held)}
    assert ts.misses == 1 and ts.delta_applies == 1
    if held:
        assert np.array_equal(_np(view), old.reshape(-1)[:64])


def test_refresh_waits_while_entry_is_patched_in_place(pair, monkeypatch):
    """During an in-place refresh the entry is out of the cache: a reader
    of the key that arrives meanwhile waits for the patched snapshot and
    receives it, never the stale one."""
    import threading

    _, tfr = pair.frags()
    ts = DeviceStager("cpu")
    ts.row(tfr[0], 5)
    pair.th.field("d", "f").set_bit(5, 777)
    entered, release = threading.Event(), threading.Event()
    real = ops.apply_word_updates_

    def slow_patch(*args):
        entered.set()
        release.wait(10)
        return real(*args)

    got = {}
    monkeypatch.setattr(ops, "apply_word_updates_", slow_patch)
    try:
        refresher = threading.Thread(target=lambda: got.setdefault("a", ts.row(tfr[0], 5)))
        refresher.start()
        assert entered.wait(10)
        reader = threading.Thread(target=lambda: got.setdefault("b", ts.row(tfr[0], 5)))
        reader.start()
        reader.join(0.2)
        assert reader.is_alive()  # waiting on the refresh, not served the stale entry
        release.set()
        refresher.join(10)
        reader.join(10)
        assert not refresher.is_alive() and not reader.is_alive()
    finally:
        release.set()
    assert got["a"] is got["b"]
    assert np.array_equal(_np(got["b"]), tfr[0].row_words(5).view("<u4"))
    assert ts.delta_routes["in_place"] == 1


# -- the executor gauntlet ----------------------------------------------------------------


def _plain(results):
    out = []
    for r in results:
        if hasattr(r, "columns"):
            r = [int(c) for c in r.columns()]
        elif hasattr(r, "val") and hasattr(r, "count"):
            r = ("vc", r.val, r.count)
        out.append(r)
    return out


READS = [
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=0), Row(f=3)))",
    "Count(Union(Row(f=2), Row(f=5), Row(f=11)))",
    "Row(f=5)",
    "TopN(f, Row(f=3), n=4)",
    "Sum(field=v)",
    "Count(Range(v > 2000))",
    "GroupBy(Rows(f, ids=[0, 3, 5]), Sum(field=v))",
]


def test_executor_write_read_gauntlet(pair):
    jax = JaxExecutor(pair.jh, device_policy="always")
    dev = pilosa_tpu_torch.Executor(pair.th, device="cpu", device_policy="always")
    cpu = pilosa_tpu_torch.Executor(pair.th, device="cpu", device_policy="never")
    rng = np.random.default_rng(77)
    try:
        for step in range(14):
            col = int(rng.integers(0, 2 * SW))
            row = int(rng.choice([0, 2, 3, 5, 11]))
            w = [f"Set({col}, f={row})", f"Clear({col}, f={row})",
                 f"SetValue(col={col}, v={int(rng.integers(0, 4001))})"][step % 3]
            if step % 3 == 1:  # clear a bit that is set
                w = f"Set({col}, f={row})Clear({col}, f={row})Set({col + 1}, f={row})"
            for ex in (jax, dev):
                ex.execute("d", w)
            for q in READS:
                a, b, c = (_plain(ex.execute("d", q)) for ex in (jax, dev, cpu))
                assert a == b == c, (step, q)
        assert dev.stager.delta_applies > 0
    finally:
        for ex in (jax, dev, cpu):
            ex.close()
