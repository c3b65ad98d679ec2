"""Dynamic lock-order detection (``OrderedLock``), copied from the
JAX package so the port's stager keeps the same lock discipline."""

from pilosa_tpu_torch.analysis.locks import (  # noqa: F401
    GRAPH,
    LockGraph,
    LockOrderError,
    OrderedLock,
    held_locks,
    strict_mode,
)
