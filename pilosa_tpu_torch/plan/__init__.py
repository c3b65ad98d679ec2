"""Query planning: PQL AST canonicalization (``canon``), the
generation-stamped result cache and its device-resident companion
(``cache``), and the planner's cache keys and common-subexpression
elimination (``planner``)."""

from pilosa_tpu_torch.plan.cache import DevicePlanCache, PlanCache
from pilosa_tpu_torch.plan.canon import call_hash, canonicalize, query_signature

__all__ = ["DevicePlanCache", "PlanCache", "call_hash", "canonicalize", "query_signature"]
