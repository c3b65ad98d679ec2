#!/usr/bin/env python3
"""Time the tree count (K3) of checkouts of the port in turns on one NVIDIA card.

Run from the root of a checkout:

    python3 kernel_ab_probe.py DIR [DIR ...]

Each DIR is the root of a checkout of the repository ("." is this one),
for example a parent commit unpacked with ``git archive`` into a
git-ignored directory. The arms run one after another in the order given,
so ``A B B A`` pairs each arm's runs around the other's. Each arm runs in
a process of its own and imports that checkout's ``pilosa_tpu_torch``
(its kernels built from its sources), then times its ``ops.cuda.
tree_count`` wrapper on the same seeded inputs:

  chain  4 coalesced Count(chain) queries of the tall index's
         Union-of-Intersects shape, 5 leaves each over 12 distinct
         64 x 32768-word stacks (the tall chains' widest launch);
  one    a one-leaf count of one 32768-word row (the shape launched most).

Every result must equal a numpy evaluation of the same trees. Times are
medians of CUDA-event windows taken with this checkout's
``chip_smoke.time_ms``, both ways: as ``chip_smoke.py`` times now (L2
flushed by a read, the host's enqueue outside the window) and the
earlier way (flushed by a write, the enqueue inside).

Output: the card's name and power limit, one JSON line per arm, and as
the last line a summary of every arm's times in run order. Exits nonzero
if an arm fails or without CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LEAF_SHAPE = (64, 32768)
DISTINCT = 12
# the Union-of-Intersects chain over leaves 0-4, and each query's leaves
TREE = ("Union", (("Intersect", (("leaf", 0), ("leaf", 1))), ("Intersect", (("leaf", 2), ("leaf", 3))), ("leaf", 4)))
PICKS = ((0, 1, 2, 3, 4), (0, 5, 6, 3, 7), (8, 1, 9, 3, 10), (0, 11, 2, 3, 4))
ITERS = 30


def _smoke():
    """This checkout's chip_smoke.py, whichever port an arm imports."""
    spec = importlib.util.spec_from_file_location("smoke_here", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs():
    rng = np.random.default_rng(2024)
    pool = [rng.integers(0, 2**32, size=LEAF_SHAPE, dtype=np.uint32) for _ in range(DISTINCT)]
    chain = [
        int(np.bitwise_count((pool[a] & pool[b]) | (pool[c] & pool[d]) | pool[e]).sum())
        for a, b, c, d, e in PICKS
    ]
    return pool, chain, int(np.bitwise_count(pool[0][0]).sum())


def run_arm(checkout: str) -> int:
    """One arm: ``checkout``'s tree count. Prints {"arm", ...} last."""
    sys.path.insert(0, checkout)
    import torch

    import pilosa_tpu_torch
    from pilosa_tpu_torch import ops

    port = os.path.dirname(os.path.abspath(pilosa_tpu_torch.__file__))
    if not port.startswith(checkout + os.sep):
        raise RuntimeError(f"arm {checkout} imported the port from {port}")
    smoke = _smoke()
    ops.build_kernels()
    dev = torch.device("cuda")
    pool, chain_want, one_want = _inputs()
    leaves = [ops.words_from_numpy(a, dev) for a in pool]
    cases = {
        "chain": ([[leaves[i] for i in p] for p in PICKS], ops.TreeProgram(TREE), chain_want),
        "one": ([[leaves[0][0]]], ops.TreeProgram(("leaf", 0)), [one_want]),
    }
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    out = {"arm": checkout}
    for name, (args, prog, want) in cases.items():
        got = ops.cuda.tree_count(args, prog).tolist()
        if got != want:
            raise AssertionError(f"{checkout} {name}: {got} != {want}")
        fn = lambda: ops.cuda.tree_count(args, prog)  # noqa: E731
        out[name] = {
            "ms": smoke.time_ms(fn, ITERS, flush),
            "ms_as_before": smoke.time_ms(fn, ITERS, flush, as_before=True),
        }
    print(json.dumps(out), flush=True)
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--arm":
        return run_arm(os.path.abspath(argv[1]))
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab_probe.py: no CUDA device", file=sys.stderr)
        return 2
    print(_smoke().card_line(), flush=True)
    rows = []
    for d in argv:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--arm", os.path.abspath(d)],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"summary": [{"arm": r["arm"], **{k: r[k] for k in ("chain", "one")}} for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
