"""Build the hand-written CUDA kernels at first use and bind them.

Each ``ops/kernels/*.cu`` source holds one kernel behind a plain C entry
point. ``build_all`` starts one ``nvcc`` per source, all at once, each
producing a shared library under ``pilosa_tpu_torch/_build/`` (listed
in ``.gitignore``); ``ctypes`` loads them. A library's file name carries
a hash of its sources and flags, so an edited source rebuilds and an
unchanged one is reused. Each compile is noted in the profiler's compile
table (``profiler.COMPILES``, kind ``"nvcc"``); a reused library is not.

No source includes a PyTorch header: nvcc builds a plain C interface in
seconds but a file that includes ``torch/extension.h`` in minutes, and
the build counts against ``chip_smoke.py``'s time limit. Pointers and
the stream cross as integers (``ctypes.c_void_p``), and each entry point
returns ``cudaGetLastError()`` so a refused launch raises in the
wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from pilosa_tpu_torch.analysis.locks import OrderedLock

KERNEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
SOURCES = (
    "dense_scores",
    "sparse_scores",
    "tree_count",
    "groupby_reduce",
    "bsi_range",
    "expand_blocks",
    "word_delta",
    "bsi_minmax",
    "distinct_presence",
    "bsi_percentile",
)
HEADERS = ("common.cuh", "tma.cuh")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source -> its entry points, each (symbol, ctypes argument types)
_SIGNATURES = {
    "dense_scores": (
        # srcs, mat, out, q, r, w, device, stream
        ("pilosa_dense_scores", [_P, _P, _P, _I, _I, _LL, _I, _P]),
    ),
    "sparse_scores": (
        # srcs (host SparseSrcs*), blocks, block_row, order, items,
        # n_items, out, q, num_rows, device, stream
        ("pilosa_sparse_scores", [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P]),
    ),
    "tree_count": (
        # leaf_ptrs (host u64[ndistinct]), refs (host u8[q * nleaves]),
        # ndistinct, code, code_len, max_spill, nleaves, n_words, q,
        # scratch, out, device, stream
        ("pilosa_tree_count", [_P, _P, _I, _P, _I, _I, _I, _LL, _I, _P, _P, _I, _P]),
    ),
    "groupby_reduce": (
        # dims (host GbDim[]), ndims, filt, filt_shard_stride, planes,
        # plane_stride, plane_shard_stride, nplanes, s, wv, k, counts,
        # plane_counts, device, stream
        (
            "pilosa_groupby_reduce",
            [_P, _I, _P, _LL, _P, _LL, _LL, _I, _LL, _LL, _LL, _P, _P, _I, _P],
        ),
    ),
    "bsi_range": (
        # planes, plane_stride, shard_stride, s, wv, out, prog (host
        # RangeProg*), device, stream
        ("pilosa_bsi_range", [_P, _LL, _LL, _LL, _LL, _P, _P, _I, _P]),
    ),
    "expand_blocks": (
        # positions, np, starts, ends, nr, dense, dense_word, nd,
        # offsets, out, num_words, device, stream
        ("pilosa_expand_blocks", [_P, _LL, _P, _P, _LL, _P, _P, _LL, _P, _P, _LL, _I, _P]),
    ),
    "word_delta": (
        # src, out, shard_idx, word_idx, or_mask, andnot_mask, k, s, m,
        # device, stream
        ("pilosa_word_delta", [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _P]),
    ),
    "bsi_minmax": (
        # planes, plane_stride, shard_stride, filt, filt_stride, s, depth,
        # sv, is_min, bits, count, device, stream
        ("pilosa_bsi_minmax", [_P, _LL, _LL, _P, _LL, _I, _I, _LL, _I, _P, _P, _I, _P]),
    ),
    "distinct_presence": (
        # planes, plane_stride, shard_stride, filt, filt_stride, s, w,
        # depth, out, nwords, device, stream
        ("pilosa_distinct_presence", [_P, _LL, _LL, _P, _LL, _LL, _LL, _I, _P, _I, _I, _P]),
    ),
    "bsi_percentile": (
        # planes, plane_stride, shard_stride, filt, filt_stride, wv, nv,
        # depth, nth, on_chip, state, counters, bits, count, device, stream
        (
            "pilosa_bsi_percentile",
            [_P, _LL, _LL, _P, _LL, _LL, _LL, _I, _I, _I, _P, _P, _P, _P, _I, _P],
        ),
        # device, grid (host int*), on_chip_vectors (host long long*)
        ("pilosa_bsi_percentile_grid", [_I, _P, _P]),
    ),
}

_build_lock = OrderedLock("ops.build")
_LIBS: dict[str, ctypes.CDLL] = {}
# source -> {"seconds": float, "cached": bool, "ptxas": str}; read by
# chip_smoke.py to report the build
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in (name + ".cu",) + HEADERS:
        with open(os.path.join(KERNEL_DIR, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _note_build(so: str, seconds: float) -> None:
    """One compile in the profiler's compile table: kind ``"nvcc"``,
    signature the source's name and hash (the library's file name)."""
    from pilosa_tpu_torch.utils import profiler

    profiler.COMPILES.note("nvcc", os.path.basename(so)[: -len(".so")], seconds)


def build_all() -> dict:
    """Compile every source that has no current build, in parallel, and
    load all libraries. Idempotent; raises with nvcc's output if a
    source does not compile."""
    with _build_lock:
        if len(_LIBS) == len(SOURCES):
            return BUILD_LOG
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = {}
        for name in SOURCES:
            so = _lib_path(name)
            if os.path.exists(so):
                BUILD_LOG[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(KERNEL_DIR, name + ".cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            jobs[name] = (proc, tmp, so, time.monotonic())
        failed = []
        for name, (proc, tmp, so, t0) in jobs.items():
            out, err = proc.communicate()
            BUILD_LOG[name] = {
                "seconds": time.monotonic() - t0,
                "cached": False,
                "ptxas": (out + err).strip(),
            }
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}{err}")
                continue
            os.replace(tmp, so)
            _note_build(so, BUILD_LOG[name]["seconds"])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in SOURCES:
            lib = ctypes.CDLL(_lib_path(name))
            for sym, argtypes in _SIGNATURES[name]:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building every kernel on the
    first call."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib
