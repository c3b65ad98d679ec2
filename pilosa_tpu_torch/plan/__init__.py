"""Query planning: PQL AST canonicalization (``canon``). The result
cache and the planner's common-subexpression elimination come with
ROADMAP A5."""

from pilosa_tpu_torch.plan.canon import call_hash, canonicalize, query_signature

__all__ = ["call_hash", "canonicalize", "query_signature"]
