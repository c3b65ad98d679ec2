"""Query executor (L4): PQL call trees → shard kernels + map/reduce."""

from pilosa_tpu_torch.executor.batcher import BatchedScorer
from pilosa_tpu_torch.executor.executor import (
    ExecOptions,
    Executor,
    NotFoundError,
    ValCount,
    pairs_add,
    resolve_device,
)
from pilosa_tpu_torch.executor.stager import DeviceStager

__all__ = [
    "BatchedScorer",
    "DeviceStager",
    "ExecOptions",
    "Executor",
    "NotFoundError",
    "ValCount",
    "pairs_add",
    "resolve_device",
]
