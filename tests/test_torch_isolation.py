"""The port stands alone: it imports neither JAX nor the JAX package, and
without CUDA an entry point that was not asked for the CPU raises."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

import pilosa_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pilosa_tpu_torch")

_PROBE = r"""
import os, sys, tempfile
import numpy as np
import pilosa_tpu_torch
from pilosa_tpu_torch.roaring.writer import build_fragment_file

d = tempfile.mkdtemp()
vdir = os.path.join(d, "i", "f", "views", "standard", "fragments")
os.makedirs(vdir)
SW = 1 << 20
pos = np.concatenate([np.arange(0, 5000, 3, dtype=np.uint64) + np.uint64(r * SW) for r in range(4)])
build_fragment_file(os.path.join(vdir, "0"), [pos])
h = pilosa_tpu_torch.holder_from_dir(d)
from pilosa_tpu_torch.core import FieldOptions
idx = h.create_index("b")
cols = list(range(0, 2 * SW, 4099))
idx.create_field("g").import_bits([c % 3 for c in cols], cols)
idx.create_field("v", FieldOptions(type="int", min=0, max=1000)).import_values(cols, [c % 1001 for c in cols])
ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always")
print(ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))TopN(f, Row(f=0), n=2)"))
groups, n, pct = ex.execute("b", "GroupBy(Rows(g), Sum(field=v))Count(Range(v > 10))Percentile(field=v, nth=50)")
print("ANALYTICS", len(groups), sum(g["count"] for g in groups), n, pct.count)
ex.close()
# a write, then a read, through a tiered, delta-enabled stager
from pilosa_tpu_torch.executor import DeviceStager
st = DeviceStager("cpu", tier1_max_bytes=1 << 20, compressed_min_ratio=4.0)
ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always", stager=st)
a = ex.execute("i", "Count(Row(f=1))")[0]
ex.execute("i", "Set(4, f=1)")
b = ex.execute("i", "Count(Row(f=1))")[0]
print("TIERED", a, b, st.delta_applies, st.tier1.stats()["admitted"])
ex.close()
h.close()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
print("FOREIGN", bad)
"""


def test_import_and_query_pull_in_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    count, pairs = ast.literal_eval(lines[-4])
    assert count == 1667 and len(pairs) == 2 and pairs[0]["count"] == 1667
    ncols = len(range(0, 2 * (1 << 20), 4099))
    assert lines[-3].split()[:3] == ["ANALYTICS", "3", str(ncols)]
    assert 0 < int(lines[-3].split()[3]) < ncols and int(lines[-3].split()[4]) == ncols
    # the write reached the staged row as one delta; tier 1 held its payloads
    assert lines[-2] == "TIERED 1667 1668 1 1"
    assert lines[-1] == "FOREIGN []"


_FOREIGN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+pilosa_tpu\b(?!_)|from\s+pilosa_tpu\b(?!_))")
_FOREIGN_NAME = re.compile(r"\bpilosa_tpu\.")


def _sources():
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chain_batch_probe.py")
    yield os.path.join(REPO, "ab_probe.py")


def test_sources_name_no_jax_and_no_jax_package():
    found = []
    for path in _sources():
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if _FOREIGN.search(line) or _FOREIGN_NAME.search(line):
                    found.append(f"{os.path.relpath(path, REPO)}:{no}: {line.strip()}")
    assert not found, "\n".join(found)


def test_executor_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = pilosa_tpu_torch.holder_from_dir(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pilosa_tpu_torch.Executor(h)
        # an explicit CPU request is honoured
        pilosa_tpu_torch.Executor(h, device="cpu").close()
    finally:
        h.close()


def test_kernel_wrappers_refuse_cpu_tensors():
    from pilosa_tpu_torch.ops import cuda

    w = torch.zeros((2, 2048), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.dense_scores(w, w)
    assert cuda.DENSE_SCORES.launches == 0
