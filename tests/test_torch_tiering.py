"""The port's tiered staging against the JAX package's, on the CPU.

* The expansion (kernel K6's plain version): ``expand_blocks_plain``
  against ``pilosa_tpu.ops.expand_blocks`` on array, run and bitmap
  payloads with the padding the contract names, and ``expand_runs_plain``
  against ``expand_runs_pallas`` in interpret mode. K6's binned form:
  ``bin_expand_inputs`` on shuffled payloads (runs across spans, bitmap
  blocks off their spans) then the plain version over the bins, against
  the JAX function; the stager's own bins from unsorted entries.
* ``Tier1Cache``: admission, eviction by value, delta-log revalidation,
  with the same operation sequence giving the same stats as the JAX
  cache.
* The compressed stager path (tier 1 + compressed upload) against an
  untiered stager and against the JAX tiered stager.
* The 3x oversubscription gauntlet: answers == the CPU leg, the stager
  inside its budget, re-entries through tier 1 and counted as restaged
  bytes.
"""

import shutil

import numpy as np
import pytest
import torch

from pilosa_tpu import ops as jops
from pilosa_tpu.core import FieldOptions as JaxFieldOptions
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import DeviceStager as JaxStager
from pilosa_tpu.executor.tiering import Tier1Cache as JaxTier1Cache
from pilosa_tpu.ops.pallas_kernels import expand_runs_pallas

import pilosa_tpu_torch
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.executor import DeviceStager
from pilosa_tpu_torch.executor.tiering import Tier1Cache
from pilosa_tpu_torch.utils import metrics

SW = 1 << 20
W32 = SW // 32
ROW_BYTES = W32 * 4


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view("<i4").copy())


def _np(t) -> np.ndarray:
    return t.contiguous().numpy().view("<u4")


# -- the expansion ---------------------------------------------------------------------


def _payloads(seed: int, rows: int, padded: bool):
    """Array positions, runs and a bitmap container over ``rows`` rows
    (same-word, word-crossing, interior-covering, width-1 and adjacent
    runs), with the contract's padding when ``padded``."""
    rng = np.random.default_rng(seed)
    num_words = rows * W32
    pos = np.concatenate(
        [
            rng.choice(65536, 37, replace=False),
            (rows - 1) * SW + 3 * 65536 + rng.choice(65536, 11, replace=False),
        ]
    ).astype(np.uint32)
    runs = [(10, 20), (21, 25), (1000, 1100), (131071, 131071), (70000, 70000 + 65535)]
    if rows > 1:
        # disjoint from every other payload: the JAX twin adds head and
        # tail masks, so only roaring-valid inputs compare
        runs += [(SW + 4 * 65536 + 5, SW + 4 * 65536 + 4000), ((rows - 1) * SW, (rows - 1) * SW + 70000)]
    starts = np.array([s for s, _ in runs], np.uint32)
    ends = np.array([e for _, e in runs], np.uint32)
    dense = rng.integers(0, 1 << 32, size=(2, 2048), dtype=np.uint32)
    dense[1, :5] = 0xFFFFFFFF
    dword = np.array([(rows - 1) * W32 + (5 << 11), 7 << 11], np.int32)
    if padded:
        pos = np.concatenate([pos, np.full(3, 0xFFFFFFFF, np.uint32)])
        starts = np.concatenate([starts, np.array([1, 1], np.uint32)])
        ends = np.concatenate([ends, np.array([0, 0], np.uint32)])
        dense = np.concatenate([dense, np.zeros((1, 2048), np.uint32)])
        dword = np.concatenate([dword, np.array([num_words], np.int32)])
    return pos, starts, ends, dense, dword, num_words


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("padded", [False, True])
def test_expand_blocks_plain_matches_jax(rows, padded):
    pos, starts, ends, dense, dword, num_words = _payloads(rows, rows, padded)
    want = np.asarray(jops.expand_blocks(pos, starts, ends, dense, dword, num_words=num_words))
    args = [_t(a) for a in (pos, starts, ends, dense, dword)]
    assert np.array_equal(_np(ops.expand_blocks_plain(*args, num_words)), want)
    # the public function routes a CPU tensor to the plain version
    assert np.array_equal(_np(ops.expand_blocks(*args, num_words)), want)


def test_expand_blocks_plain_single_kinds():
    """Each input kind alone, and no input at all."""
    pos, starts, ends, dense, dword, num_words = _payloads(9, 2, True)
    none32 = np.zeros(0, np.uint32)
    nodense = np.zeros((0, 2048), np.uint32)
    for case in (
        (pos, none32, none32, nodense, np.zeros(0, np.int32)),
        (none32, starts, ends, nodense, np.zeros(0, np.int32)),
        (none32, none32, none32, dense, dword),
        (none32, none32, none32, nodense, np.zeros(0, np.int32)),
    ):
        want = np.asarray(jops.expand_blocks(*case, num_words=num_words))
        got = ops.expand_blocks_plain(*[_t(a) for a in case], num_words)
        assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("padded", [False, True])
def test_binned_expand_matches_jax(rows, padded):
    """The contract's inputs in any order, binned by span, expand as the
    JAX function expands them unbinned."""
    pos, starts, ends, dense, dword, num_words = _payloads(rows + 10, rows, padded)
    rng = np.random.default_rng(rows)
    # a bitmap block across two spans, in slots 13-14 of the last row
    off = (rows - 1) * W32 + (13 << 11) + 777
    dense = np.concatenate([dense, rng.integers(0, 1 << 32, size=(1, 2048), dtype=np.uint32)])
    dword = np.concatenate([dword, np.array([off], np.int32)])
    p, r, d = rng.permutation(pos.size), rng.permutation(starts.size), rng.permutation(dword.size)
    pos, starts, ends, dense, dword = pos[p], starts[r], ends[r], dense[d], dword[d]
    want = np.asarray(jops.expand_blocks(pos, starts, ends, dense, dword, num_words=num_words))
    *binned, offsets = ops.bin_expand_inputs(*[_t(a) for a in (pos, starts, ends, dense, dword)], num_words)
    spans = -(-num_words // 2048)
    assert tuple(offsets.shape) == (3, spans + 1)
    assert bool((offsets[:, 1:] >= offsets[:, :-1]).all())
    assert int(offsets[1, -1]) > starts.size - 2 * padded  # the long runs split at span edges
    assert np.array_equal(_np(ops.expand_blocks_plain(*binned, num_words, offsets)), want)


def test_binned_plain_drops_elements_outside_their_span():
    """What K6 reads of a binned input: an element whose offsets put it
    in another span than its own is dropped."""
    pos, starts, ends, dense, dword, num_words = _payloads(3, 2, False)
    *binned, offsets = ops.bin_expand_inputs(*[_t(a) for a in (pos, starts, ends, dense, dword)], num_words)
    full = ops.expand_blocks_plain(*binned, num_words, offsets)
    shifted = offsets.clone()
    shifted[0, 1:-1] = offsets[0, 2:]  # each span named with the next span's positions
    got = ops.expand_blocks_plain(*binned, num_words, shifted)
    assert int(ops.count_bits(got)) < int(ops.count_bits(full))
    assert torch.equal(got & ~full, torch.zeros_like(got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_runs_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    num_words = 2 * W32
    lo = np.sort(rng.choice(2 * SW - 5000, size=40, replace=False))
    starts = lo[::2].astype(np.int32)
    ends = (starts + rng.integers(0, 4000, size=starts.size)).astype(np.int32)
    starts = np.concatenate([starts, [5, 31, SW + 7, 1]]).astype(np.int32)
    ends = np.concatenate([ends, [9, 33, SW + 7, 0]]).astype(np.int32)  # last: padding
    want = np.asarray(expand_runs_pallas(starts, ends, num_words=num_words, interpret=True))
    got = ops.expand_runs_plain(_t(starts), _t(ends), num_words)
    assert np.array_equal(_np(got), want)


# -- Tier1Cache --------------------------------------------------------------------------


class _FakeFrag:
    """A fragment's surface for the tier-1 cache: the heat cell, a
    generation and a delta log (None = continuity not provable)."""

    def __init__(self):
        self.index, self.field, self.shard = "t1", "f", 0
        self.generation = 1
        self.deltas = None

    def deltas_since(self, gen):
        return self.deltas


def _script(t1, frag):
    """One operation sequence: admissions, a cold rejection, an
    oversized one, a stale revalidation and a stale eviction. Returns
    what each step answered."""
    out = []
    out.append(t1.put(frag, (0,), ["A"], nbytes=100, gen=1, cost=1.0))
    out.append(t1.put(frag, (1,), ["B"], nbytes=100, gen=1, cost=1.0))
    out.append(t1.put(frag, (2,), ["C"], nbytes=150, gen=1, cost=2.0))  # evicts A
    out.append(t1.get(frag, (0,)))
    out.append(t1.put(frag, (3,), ["cold"], nbytes=100, gen=1, cost=0.0))  # rejected
    out.append(t1.put(frag, (4,), ["huge"], nbytes=301, gen=1, cost=9.0))  # oversized
    frag.generation = 2
    frag.deltas = (np.array([5 * SW + 10], np.uint64), np.array([True]), 2)
    out.append(t1.get(frag, (1,)))  # the delta misses row 1: still exact
    frag.deltas = None
    out.append(t1.get(frag, (1,)))  # generation refreshed: no log consulted
    frag.generation = 3
    frag.deltas = (np.array([2 * SW + 7], np.uint64), np.array([True]), 3)
    out.append(t1.get(frag, (2,)))  # a delta in row 2: evicted
    frag.generation = 4
    frag.deltas = None
    out.append(t1.get(frag, (1,)))  # truncated log: evicted
    return out


def test_tier1_cache_matches_jax():
    port, ref = Tier1Cache(300), JaxTier1Cache(300)
    got, want = _script(port, _FakeFrag()), _script(ref, _FakeFrag())
    assert got == want
    assert got == [True, True, True, None, False, False, ["B"], ["B"], None, None]
    assert port.stats() == ref.stats()
    st = port.stats()
    assert st["bytes"] == 0 and st["evicted"] == 3 and st["rejected"] == 2


def test_tier1_cache_byte_accounting_and_clear():
    t1 = Tier1Cache(1000)
    frag = _FakeFrag()
    for r in range(5):
        t1.put(frag, (r,), [r], nbytes=150, gen=1, cost=1.0 + r)
    st = t1.stats()
    assert st["entries"] == 5 and st["bytes"] == 750
    t1.put(frag, (2,), ["again"], nbytes=400, gen=1, cost=10.0)  # replaces row 2
    assert t1.stats()["bytes"] == 1000 and t1.get(frag, (2,)) == ["again"]
    t1.clear()
    assert t1.stats()["bytes"] == 0 and t1.get(frag, (0,)) is None


# -- the compressed stager path -----------------------------------------------------------


def _build(path) -> None:
    """Rows 0-5: scattered bits (array containers); row 6: one run of
    4001 columns; row 7: 5000 columns in one 2^16 slot (a bitmap
    container); a BSI field."""
    rng = np.random.default_rng(7)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index("ti")
    f = idx.create_field("f")
    rids, cids = [], []
    for r in range(6):
        rids += [r] * 300
        cids += rng.integers(0, SW, size=300).tolist()
    f.import_bits(rids, cids)
    f.import_bits([6] * 4001, list(range(5000, 9001)))
    heavy = rng.choice(65536, 5000, replace=False) + 2 * 65536
    f.import_bits([7] * 5000, heavy.tolist())
    v = idx.create_field("v", JaxFieldOptions(type="int", min=0, max=4000))
    v.import_values([5, 9, 700, 9000], [17, 2000, 3999, 1])
    h.close()


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("tier_holder")
    _build(d)
    return d


@pytest.fixture
def pair(base, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)
    jh = JaxHolder(str(jdir))
    jh.open()
    th = pilosa_tpu_torch.holder_from_dir(str(tdir))
    yield jh, th
    jh.close()
    th.close()


def _counter(name) -> float:
    return sum(
        v for k, v in metrics.snapshot().items()
        if not isinstance(v, dict) and (k == name or k.startswith(name + ";"))
    )


def test_fragment_reports_all_container_kinds(pair):
    from pilosa_tpu_torch.roaring.bitmap import CONTAINER_ARRAY, CONTAINER_BITMAP, CONTAINER_RUN

    _, th = pair
    entries, _ = th.fragment("ti", "f", "standard", 0).container_blocks(list(range(8)))
    kinds = {typ for _, _, typ, _ in entries}
    assert kinds == {CONTAINER_ARRAY, CONTAINER_RUN, CONTAINER_BITMAP}


def test_compressed_path_matches_untiered_and_jax(pair):
    jh, th = pair
    frag = th.fragment("ti", "f", "standard", 0)
    jfrag = jh.fragment("ti", "f", "standard", 0)
    tiered = DeviceStager("cpu", tier1_max_bytes=32 << 20, compressed_min_ratio=1e-9)
    plain = DeviceStager("cpu", tier1_max_bytes=0, compressed_min_ratio=0.0)
    jtiered = JaxStager(tier1_max_bytes=32 << 20, compressed_min_ratio=1e-9)
    uploads = _counter(metrics.TIERING_COMPRESSED_UPLOADS)
    for r in range(8):
        got = _np(tiered.row(frag, r))
        assert np.array_equal(got, frag.row_words(r).view("<u4"))
        assert np.array_equal(got, _np(plain.row(frag, r)))
        assert np.array_equal(got, np.asarray(jtiered.row(jfrag, r)))
    ids = tuple(range(8))
    got = _np(tiered.rows(frag, ids, pad_pow2=True))
    assert np.array_equal(got, _np(plain.rows(frag, ids, pad_pow2=True)))
    assert np.array_equal(got, np.asarray(jtiered.rows(jfrag, ids, pad_pow2=True)))
    assert tiered.tier1.stats()["admitted"] > 0
    assert _counter(metrics.TIERING_COMPRESSED_UPLOADS) >= uploads + 9
    vfrag = th.fragment("ti", "v", "bsig_v", 0)
    depth = th.field("ti", "v").bsi_group("v").bit_depth()
    assert np.array_equal(_np(tiered.planes(vfrag, depth)), _np(plain.planes(vfrag, depth)))
    # a write: the staged row takes it as a delta, tier 1 evicts the
    # row's payloads exactly, and a rebuild stays identical
    th.field("ti", "f").set_bit(3, 424242)
    assert np.array_equal(_np(tiered.row(frag, 3)), frag.row_words(3).view("<u4"))
    assert tiered.delta_applies == 1
    tiered.clear()
    assert tiered.tier1.stats()["entries"] == 0
    assert np.array_equal(_np(tiered.row(frag, 3)), frag.row_words(3).view("<u4"))


def test_compressed_upload_bins_unsorted_entries(pair):
    """Container payloads out of container order: the stager sorts them
    into K6's spans before it ships their offsets."""
    from pilosa_tpu_torch.executor.stager import _assemble

    _, th = pair
    frag = th.fragment("ti", "f", "standard", 0)
    ids = list(range(8))
    entries, _ = frag.container_blocks(ids)
    num_words = len(ids) * W32
    want = _assemble(entries, num_words)
    st = DeviceStager("cpu")
    shuffled = [entries[k] for k in np.random.default_rng(5).permutation(len(entries))]
    assert np.array_equal(_np(st._compressed_upload(shuffled, num_words)), want)
    assert np.array_equal(_np(st._compressed_upload(entries, num_words)), want)


def test_host_assembly_matches_untiered(pair):
    """Tier 1 on and no compressed upload: blocks of every container kind
    assembled on the host equal the fragment walk's."""
    _, th = pair
    frag = th.fragment("ti", "f", "standard", 0)
    tiered = DeviceStager("cpu", tier1_max_bytes=32 << 20, compressed_min_ratio=0.0)
    for ids in [tuple(range(8)), (7, 6, 0), (6,)]:
        want = frag.packed_rows(list(ids)).view("<u4")
        assert np.array_equal(_np(tiered.rows(frag, ids)), want)
    assert tiered.tier1.stats()["admitted"] == 3


def test_ratio_gate_uploads_dense_below_it(pair):
    """A dense/payload ratio under the gate assembles on the host: no
    compressed upload, the same words."""
    _, th = pair
    frag = th.fragment("ti", "f", "standard", 0)
    st = DeviceStager("cpu", tier1_max_bytes=32 << 20, compressed_min_ratio=1e9)
    uploads = _counter(metrics.TIERING_COMPRESSED_UPLOADS)
    assert np.array_equal(_np(st.row(frag, 7)), frag.row_words(7).view("<u4"))
    assert _counter(metrics.TIERING_COMPRESSED_UPLOADS) == uploads


# -- the oversubscription gauntlet --------------------------------------------------------


def test_hot_set_3x_budget_matches_cpu_leg(tmp_path):
    n_rows = 18
    h = pilosa_tpu_torch.holder_from_dir(str(tmp_path / "og"))
    try:
        f = h.create_index("og").create_field("f")
        rng = np.random.default_rng(7)
        rids, cids = [], []
        for r in range(n_rows):
            rids += [r] * 60
            cids += rng.integers(0, SW, size=60).tolist()
        f.import_bits(rids, cids)
        frag = h.fragment("og", "f", "standard", 0)
        budget = 6 * ROW_BYTES  # the hot set is 3x this
        stager = DeviceStager("cpu", budget, tier1_max_bytes=64 << 20, compressed_min_ratio=1.5)
        ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always", stager=stager)
        cpu = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="never")
        restaged = _counter(metrics.STAGER_RESTAGED_BYTES)
        try:
            queries = [f"Count(Row(f={k}))" for k in range(n_rows)] + [
                "Count(Intersect(Row(f=1), Row(f=2)))",
                "Count(Union(Row(f=3), Row(f=17)))",
            ]
            for lap in range(2):
                for q in queries:
                    assert ex.execute("og", q) == cpu.execute("og", q)
                    assert stager._bytes <= budget
                if lap == 0:
                    f.set_bit(3, 123456)  # T1 drops row 3 exactly
            for r in range(n_rows):
                assert np.array_equal(_np(stager.row(frag, r)), frag.row_words(r).view("<u4"))
            st = stager.tier1.stats()
            assert st["admitted"] > 0 and st["hits"] > 0, st
            # re-entries of capacity-evicted rows are restaged bytes
            assert _counter(metrics.STAGER_RESTAGED_BYTES) >= restaged + 12 * ROW_BYTES
        finally:
            ex.close()
            cpu.close()
    finally:
        h.close()
