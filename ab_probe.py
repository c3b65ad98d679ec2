#!/usr/bin/env python3
"""Time checkouts of the PyTorch/CUDA port against each other on one NVIDIA card.

Run from the root of a checkout:

    python3 ab_probe.py [--dense] DIR [DIR ...]

Each DIR is the root of a checkout of the repository ("." is this one),
for example a parent commit unpacked with ``git archive`` into a
git-ignored directory. The arms run one after another in the order given,
so ``A B B A`` pairs each arm's runs around the other's.

The data is written once, with this checkout's ``chip_smoke.py``: its
``dense``, ``tall`` and ``ssb`` indexes. The answers are computed once
too: the port's CPU leg for dense and tall, the numpy oracle for ssb.
Then each arm runs in a process of its own, importing that checkout's
``pilosa_tpu_torch`` and ``chip_smoke.py``: its kernels built from its
sources, its executor staging as its ``chip_smoke.py`` stages, and its
``main_path`` (dense and tall) and ``run_ssb`` over the shared data,
every answer held against the shared one. The arms' phase numbers are
therefore those of each checkout's own ``chip_smoke.py``.

``--dense`` writes and answers the dense index alone, and each arm runs
only the dense phases: its first pass, the sequential pass
DENSE_REPEATS times, and the concurrent clients once (each checkout's
``run_sequential``, ``run_concurrent`` and ``_rate``).

Output: the card's name and power limit, one JSON line per arm, and as
the last line a summary: qps, p50 and mean device.compute of every
phase, per arm in run order. Exits nonzero if an arm fails or without
CUDA.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
DENSE_REPEATS = 4


def log(msg: str) -> None:
    print(f"[ab_probe {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def dense_phases(cs, dev, dense_qs, oracle) -> dict:
    """The dense phases alone, with ``cs`` a checkout's chip_smoke."""
    out = {}
    cold, _ = cs.run_sequential(dev, "dense", dense_qs, oracle)
    out["dense_first_pass_s"] = sum(cold)
    for i in range(DENSE_REPEATS):
        out[f"dense_sequential_{i + 1}"] = cs._rate(*cs.run_sequential(dev, "dense", dense_qs, oracle))
    lat, legs, wall = cs.run_concurrent(dev, "dense", dense_qs, oracle, cs.CLIENTS, cs.CONCURRENT_PASSES)
    out[f"dense_concurrent_c{cs.CLIENTS}"] = cs._rate(lat, legs, wall)
    return out


def run_arm(checkout: str, root: str, answers_path: str, dense_only: bool = False) -> int:
    """One arm, in its own process: ``checkout``'s port over the data in
    ``root``. Prints {"arm", "port", "phases"} as its last line."""
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    import pilosa_tpu_torch
    from pilosa_tpu_torch.ops import cuda

    port = os.path.dirname(os.path.abspath(pilosa_tpu_torch.__file__))
    if not port.startswith(checkout + os.sep):
        raise RuntimeError(f"arm {checkout} imported the port from {port}")
    with open(answers_path, "rb") as fh:
        answers = pickle.load(fh)
    t0 = time.monotonic()
    cuda.build_kernels()
    build_s = time.monotonic() - t0
    holder = pilosa_tpu_torch.holder_from_dir(root)
    for index in ("dense",) if dense_only else ("dense", "tall"):
        for frag in holder.view(index, "f", "standard").fragments.values():
            frag.ensure_open()
    device = torch.device("cuda")
    # stage as the checkout's own chip_smoke.py does
    stager = cs.server_stager(device) if hasattr(cs, "server_stager") else None
    dev = pilosa_tpu_torch.Executor(holder, device=device, device_policy="always", stager=stager)
    try:
        dense_qs = cs.dense_queries(cs.DENSE_ROWS)
        t0 = time.monotonic()
        if dense_only:
            phases = dense_phases(cs, dev, dense_qs, answers["dense_tall"])
        else:
            tall_topn, tall_chains = cs.tall_queries()
            phases = cs.main_path(dev, dense_qs, tall_topn, tall_chains, answers["dense_tall"])
            phases["ssb"] = cs.run_ssb(dev, answers["ssb"])
        phases["seconds"] = {"build": build_s, "phases": time.monotonic() - t0}
    finally:
        dev.close()
        holder.close()
    print(json.dumps({"arm": checkout, "port": port, "phases": phases}), flush=True)
    return 0


def _flat(phases: dict) -> dict:
    """phase name -> (qps, p50 ms, mean device.compute ms) for every timed
    phase."""

    def row(v):
        return v["qps"], v["p50_ms"], v.get("legs_ms", {}).get("device.compute")

    out = {}
    for name, v in phases.items():
        if isinstance(v, dict) and "qps" in v:
            out[name] = row(v)
        elif name == "ssb":
            out.update({f"ssb.{k}": row(f) for k, f in v.items() if isinstance(f, dict) and "qps" in f})
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 4 and argv[0] == "--arm":
        return run_arm(os.path.abspath(argv[1]), argv[2], argv[3], dense_only=argv[4:] == ["--dense"])
    dense_only = bool(argv) and argv[0] == "--dense"
    if dense_only:
        argv = argv[1:]
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ab_probe.py: no CUDA device; it times the port on an NVIDIA card", file=sys.stderr)
        return 2
    arms = [os.path.abspath(d) for d in argv]
    for d in arms:
        if not os.path.isfile(os.path.join(d, "chip_smoke.py")) or not os.path.isdir(os.path.join(d, "pilosa_tpu_torch")):
            print(f"ab_probe.py: {d} is not a checkout of the port", file=sys.stderr)
            return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import pilosa_tpu_torch
    from pilosa_tpu_torch.executor.executor import ValCount

    card = cs.card_line()
    print(card, flush=True)
    root = tempfile.mkdtemp(prefix="pilosa_ab_probe_")
    try:
        def make_oracle():
            o = cs.SsbOracle(ValCount)
            cs.ssb_workload(o)
            return types.SimpleNamespace(queries=o.queries, answers=o.answers)

        t0 = time.monotonic()
        if dense_only:
            _, ssb = cs.build_data(root, cs.DENSE_ROWS, 0, 0, 0)
        else:
            _, ssb = cs.build_data(
                root, cs.DENSE_ROWS, cs.TALL_SHARDS, cs.TAIL_ROWS_PER_SHARD, cs.SSB_ROWS, during=make_oracle
            )
        log(f"data written and ssb answered in {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        holder = pilosa_tpu_torch.holder_from_dir(root)
        cpu = pilosa_tpu_torch.Executor(holder, device_policy="never")
        try:
            dense_tall = cs.oracle_answers(cpu, "dense", cs.dense_queries(cs.DENSE_ROWS))
            if not dense_only:
                tall_topn, tall_chains = cs.tall_queries()
                dense_tall.update(cs.oracle_answers(cpu, "tall", tall_topn + tall_chains))
        finally:
            cpu.close()
            holder.close()
        log(f"CPU leg answered {len(dense_tall)} queries in {time.monotonic() - t0:.1f} s")
        answers_path = os.path.join(root, "answers.pickle")
        with open(answers_path, "wb") as fh:
            pickle.dump({"dense_tall": dense_tall, "ssb": ssb}, fh)

        runs = []
        for d in arms:
            log(f"arm {len(runs) + 1}/{len(arms)}: {d}")
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--arm", d, root, answers_path]
                + (["--dense"] if dense_only else []),
                cwd=d, stdout=subprocess.PIPE, text=True, timeout=1800,
            )
            if out.returncode != 0:
                print(f"ab_probe.py: arm {d} exited {out.returncode}", file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(res), flush=True)
            runs.append(res)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    summary = {"card": card, "order": [os.path.relpath(r["arm"], REPO) for r in runs], "phases": {}}
    for i, r in enumerate(runs):
        for name, (qps, p50, device_ms) in _flat(r["phases"]).items():
            summary["phases"].setdefault(name, []).append(
                {"arm": summary["order"][i], "qps": qps, "p50_ms": p50, "device_compute_ms": device_ms}
            )
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
