"""Storage tree (L1/L2): holder → index → field → view → fragment; Row."""

from pilosa_tpu_torch.core.fragment import Fragment, TopOptions, pos
from pilosa_tpu_torch.core.field import BSIGroup, Field, FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.iterator import (
    BufIterator,
    LimitIterator,
    RoaringIterator,
    SliceIterator,
)
from pilosa_tpu_torch.core.row import Row, union_rows
from pilosa_tpu_torch.core.view import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD, View

__all__ = [
    "BSIGroup",
    "BufIterator",
    "Field",
    "FieldOptions",
    "Fragment",
    "Holder",
    "Index",
    "LimitIterator",
    "RoaringIterator",
    "Row",
    "SliceIterator",
    "TopOptions",
    "VIEW_BSI_GROUP_PREFIX",
    "VIEW_STANDARD",
    "View",
    "pos",
    "union_rows",
]
