"""Attributes in the port (``utils/attrstore.py`` and the executor's
attribute calls) against the JAX package's.

Every case of ``tests/test_attrstore.py`` runs on ``pilosa_tpu_torch``
(its executor on ``device="cpu"``), then the attribute and key cases of
``tests/test_executor_advanced.py`` run on the reference's executor and
the port's at ``never`` and ``always``, whose answers must be equal, and
the two packages' stores are held to each other: the same writes give
the same block checksums, and each opens the other's SQLite file.
"""

import pytest
from port_reference import exec_against_port

exec_against_port("test_attrstore", globals())

import pilosa_tpu_torch  # noqa: E402
from pilosa_tpu.core import FieldOptions as RefFieldOptions  # noqa: E402
from pilosa_tpu.core import Holder as RefHolder  # noqa: E402
from pilosa_tpu.executor import Executor as RefExecutor  # noqa: E402
from pilosa_tpu.utils.attrstore import AttrStore as RefAttrStore  # noqa: E402
from pilosa_tpu.utils.translate import TranslateStore as RefTranslateStore  # noqa: E402
from pilosa_tpu_torch.core import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.utils.translate import TranslateStore  # noqa: E402


class TestBoundedMemory(TestBoundedMemory):  # noqa: F821
    def test_memory_contract_and_identity_under_eviction(self, tmp_path):
        """The reference's case with the port's executor on the CPU:
        attrs far past the LRU keep its residency bounded, and an
        attribute-filtered TopN answers the same under eviction."""
        from pilosa_tpu_torch import SHARD_WIDTH

        n = 30_000
        payload = {i: {"cat": "hot" if i % 7 == 0 else f"c{i % 50}"} for i in range(n)}
        small = AttrStore(str(tmp_path / "small.db"), cache_size=128)  # noqa: F821
        big = AttrStore(str(tmp_path / "big.db"), cache_size=n * 2)  # noqa: F821
        small.set_bulk_attrs(payload)
        big.set_bulk_attrs(payload)
        assert small.cache_len() <= 128
        assert small.resident_bytes() < (1 << 17), small.resident_bytes()
        for probe in (0, 127, 128, 12345, n - 1):
            assert small.attrs(probe) == payload[probe]
        assert small.blocks() == big.blocks()
        h = Holder()
        h.open()
        f = h.create_index("i").create_field("f", None)
        for r in range(0, 4000):
            f.set_bit(r, (r * 131) % SHARD_WIDTH)
            f.set_bit(r, (r * 131 + 1) % SHARD_WIDTH)
        for frag in f.view("standard").fragments.values():
            frag.cache.recalculate()
        results = {}
        for policy in ("never", "always"):
            ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy=policy)
            for q in ('TopN(f, n=20, attrName="cat", attrValues=["hot"])',
                      'TopN(f, Row(f=7), n=20, attrName="cat", attrValues=["hot"])'):
                for name, store in (("small", small), ("big", big)):
                    f.row_attr_store = store
                    for frag in f.view("standard").fragments.values():
                        frag.row_attr_store = store
                    results[(policy, q, name)] = ex.execute("i", q)
            ex.close()
        assert len({repr(v) for k, v in results.items() if "Row" not in k[1]}) == 1
        assert len({repr(v) for k, v in results.items() if "Row" in k[1]}) == 1
        assert len(results[("always", 'TopN(f, n=20, attrName="cat", attrValues=["hot"])', "small")][0]) == 20
        assert small.resident_bytes() < (1 << 17)
        small.close()
        big.close()


def test_stores_checksum_alike_and_open_each_others_files(tmp_path):
    writes = [(i, {"v": i, "name": f"n{i % 13}", "tags": [i % 3, "x"]}) for i in range(0, 730, 3)]
    writes += [(6, {"v": None}), (9, {"name": None, "v": None, "tags": None})]
    stores = {}
    for side, cls in (("ref", RefAttrStore), ("port", AttrStore)):  # noqa: F821
        s = cls(str(tmp_path / f"{side}.db"))
        for id_, attrs in writes:
            s.set_attrs(id_, attrs)
        s.set_bulk_attrs({1000 + j: {"b": j} for j in range(50)})
        stores[side] = s
    assert stores["port"].blocks() == stores["ref"].blocks()
    assert stores["port"].ids() == stores["ref"].ids()
    assert RefAttrStore.diff_blocks(stores["ref"].blocks(), stores["port"].blocks()) == []
    for s in stores.values():
        s.close()
    for reader, cls in (("port", AttrStore), ("ref", RefAttrStore)):  # noqa: F821
        writer = "ref" if reader == "port" else "port"
        s = cls(str(tmp_path / f"{writer}.db"))
        assert s.attrs(3) == {"v": 3, "name": "n3", "tags": [0, "x"]}
        assert s.attrs(9) == {} and s.attrs(6) == {"name": "n6", "tags": [0, "x"]}
        assert s.block_data(10) == {1000 + j: {"b": j} for j in range(50)}
        s.close()


# -- the attribute and key cases of test_executor_advanced, three ways --------


def _three(setup, queries, translate=False):
    """Run ``setup(holder, executor, FieldOptions)`` and then each query on
    the reference (``always``) and on the port at ``never`` and
    ``always``, each over its own in-memory holder with attribute
    stores; return the answers and the three holders."""
    sides = []
    ref_h = RefHolder(new_attr_store=lambda path: RefAttrStore(None))
    ref_h.open()
    ref_ex = RefExecutor(ref_h, device_policy="always", translate_store=RefTranslateStore() if translate else None)
    sides.append((ref_h, ref_ex, RefFieldOptions))
    for policy in ("never", "always"):
        h = Holder(new_attr_store=lambda path: AttrStore(None))  # noqa: F821
        h.open()
        ex = pilosa_tpu_torch.Executor(
            h, device="cpu", device_policy=policy, translate_store=TranslateStore() if translate else None
        )
        sides.append((h, ex, FieldOptions))
    answers = []
    for h, ex, opts in sides:
        setup(h, ex, opts)
        got = []
        for q in queries:
            for r in ex.execute(q[0], q[1]):
                if hasattr(r, "columns"):
                    r = ([int(c) for c in r.columns()], list(r.keys), dict(r.attrs))
                got.append(r)
        answers.append(got)
        ex.close()
    return answers, [h for h, _, _ in sides]


def _attr_filter_data(h, ex, opts):
    f = h.create_index("i").create_field("f")
    for col in range(5):
        f.set_bit(1, col)
    for col in range(3):
        f.set_bit(2, col)
    for col in range(2):
        f.set_bit(3, col)
    for col in range(1, 4):
        f.set_bit(9, col)
    f.row_attr_store.set_attrs(1, {"category": "a"})
    f.row_attr_store.set_attrs(2, {"category": "b"})
    f.row_attr_store.set_attrs(3, {"category": "a"})
    f.view("standard").fragments[0].cache.recalculate()


def test_topn_attr_filter():
    answers, _ = _three(
        _attr_filter_data,
        [
            ("i", 'TopN(f, n=5, attrName="category", attrValues=["a"])'),
            ("i", 'TopN(f, Row(f=9), n=5, attrName="category", attrValues=["a", "b"])'),
            ("i", 'TopN(f, Row(f=9), n=1, attrName="category", attrValues=["a"])'),
            ("i", 'TopN(f, Row(f=9), ids=[1, 2, 3], attrName="category", attrValues=["b"])'),
            ("i", 'TopN(f, n=5, attrName="nothing", attrValues=["a"])'),
        ],
    )
    assert answers[1] == answers[0] and answers[2] == answers[0]
    assert answers[0][0] == [{"id": 1, "count": 5}, {"id": 3, "count": 2}]


def test_row_attrs_on_row_query():
    def setup(h, ex, opts):
        h.create_index("i").create_field("f")
        ex.execute("i", 'Set(1, f=10)SetRowAttrs(f, 10, foo="bar", n=5)')

    def more(h, ex, opts):
        setup(h, ex, opts)
        ex.execute("i", "SetRowAttrs(f, 10, foo=null)")

    queries = [("i", "Row(f=10)"), ("i", "Count(Row(f=10))Row(f=10)Row(f=11)")]
    for fn in (setup, more):
        answers, _ = _three(fn, queries)
        assert answers[1] == answers[0] and answers[2] == answers[0]
    assert answers[0][0] == ([1], [], {"n": 5})


def test_column_attrs():
    def setup(h, ex, opts):
        h.create_index("i").create_field("f")
        ex.execute("i", 'SetColumnAttrs(7, name="acme", active=true)')
        ex.execute("i", "Set(10, f=1)SetColumnAttrs(10, foo='bar')Set(20, f=10)SetColumnAttrs(20, foo='bar')")

    answers, holders = _three(setup, [("i", "Row(f=1)")])
    assert answers[1] == answers[0] and answers[2] == answers[0]
    for h in holders:
        store = h.index("i").column_attrs
        assert store.attrs(7) == {"name": "acme", "active": True}
        # exactly the given attrs: no field or column key leaks in
        assert store.attrs(10) == {"foo": "bar"} == store.attrs(20)


def test_string_col_requires_keys():
    for translate in (False, True):
        for h, ex in (
            (RefHolder(), lambda h: RefExecutor(h, device_policy="never", translate_store=RefTranslateStore())),
            (Holder(), lambda h: pilosa_tpu_torch.Executor(h, device="cpu", translate_store=TranslateStore())),
        ):
            h.open()
            h.create_index("i").create_field("f")
            with pytest.raises(ValueError):
                ex(h).execute("i", 'Set("alice", f=1)')


def test_keys_workflow():
    def setup(h, ex, opts):
        idx = h.create_index("u", keys=True)
        idx.create_field("l", opts(keys=True))
        ex.execute("u", 'Set("alice", l="pizza")')
        ex.execute("u", 'Set("bob", l="pizza")')
        ex.execute("u", 'Set("alice", l="sushi")')
        ex.execute("u", 'SetRowAttrs(l, 1, kind="food")')

    answers, _ = _three(
        setup,
        [
            ("u", 'Row(l="pizza")'),
            ("u", 'Count(Row(l="sushi"))'),
            ("u", 'TopN(l, Row(l="pizza"), n=2)TopN(l, n=2, attrName="kind", attrValues=["food"])'),
        ],
        translate=True,
    )
    assert answers[1] == answers[0] and answers[2] == answers[0]
    assert answers[0][0] == ([1, 2], ["alice", "bob"], {"kind": "food"}) and answers[0][1] == 1
