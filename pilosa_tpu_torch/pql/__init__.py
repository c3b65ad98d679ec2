"""PQL language layer (L3): AST + parser."""

from pilosa_tpu_torch.pql.ast import (
    BETWEEN,
    COND_OPS,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    Call,
    Condition,
    Query,
)
from pilosa_tpu_torch.pql.parser import ParseError, Parser, parse

__all__ = [
    "BETWEEN",
    "COND_OPS",
    "EQ",
    "GT",
    "GTE",
    "LT",
    "LTE",
    "NEQ",
    "Call",
    "Condition",
    "ParseError",
    "Parser",
    "Query",
    "parse",
]
