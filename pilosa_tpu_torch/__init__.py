"""pilosa_tpu_torch — the bitmap index on PyTorch and CUDA (NVIDIA Hopper).

A port of ``pilosa_tpu`` beside it, module for module. The layering is
the same; only the device data plane differs:

  L0 roaring/   — CPU source-of-truth bitmap engine + file format (copied)
  L0 ops/       — packed-word PyTorch ops + hand-written CUDA kernels
  L1 core/      — holder → index → field → view → fragment (copied)
  L3 pql/       — PQL parser/AST (copied); plan/ canonical signatures
  L4 executor/  — PQL call tree → staged words → kernels + map/reduce,
                  behind the device health gate and the HBM governor
  L6 server/    — API, HTTP handler, pipeline, ingest, tenancy (one node)
  L7/L8         — server/server.py and cli/ (``python -m pilosa_tpu_torch``)

Device words are ``int32`` views of the same little-endian ``u32`` bits
the JAX package stages. Entry points run on ``cuda`` unless the caller
asks for ``device="cpu"``; without CUDA and without an explicit device
they raise instead of quietly running on the CPU.
"""

__version__ = "0.1.0"

# Width of a single shard in columns (bits) — the reference's
# compile-time constant (reference fragment.go:47-48).
SHARD_WIDTH = 1 << 20


def holder_from_dir(path: str):
    """Open a data directory (as written by this package or by
    ``pilosa_tpu``: the fragment and attribute file formats are shared)
    and return the opened Holder, with its attribute stores."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.utils.attrstore import new_attr_store

    h = Holder(path, new_attr_store=new_attr_store)
    h.open()
    return h


def __getattr__(name):
    # lazy: the executor imports torch and the ops; `import
    # pilosa_tpu_torch` alone stays as light as the storage layer
    if name == "Executor":
        from pilosa_tpu_torch.executor import Executor

        return Executor
    raise AttributeError(name)
