"""CPU roaring-bitmap engine + reference file-format compatibility (L0)."""

from .btree import BTreeContainers
from .mmapstore import MmapContainers
from .writer import build_fragment_file, write_roaring_file
from .bitmap import (
    ARRAY_MAX_SIZE,
    BITMAP_N,
    CONTAINER_ARRAY,
    CONTAINER_BITMAP,
    CONTAINER_RUN,
    Bitmap,
    Container,
    get_default_container_store,
    set_default_container_store,
    highbits,
    lowbits,
    marshal_op,
    positions_to_words,
    unmarshal_op,
    words_to_positions,
)

__all__ = [
    "ARRAY_MAX_SIZE",
    "BITMAP_N",
    "BTreeContainers",
    "MmapContainers",
    "build_fragment_file",
    "write_roaring_file",
    "get_default_container_store",
    "set_default_container_store",
    "CONTAINER_ARRAY",
    "CONTAINER_BITMAP",
    "CONTAINER_RUN",
    "Bitmap",
    "Container",
    "highbits",
    "lowbits",
    "marshal_op",
    "positions_to_words",
    "unmarshal_op",
    "words_to_positions",
]
