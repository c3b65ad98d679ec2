"""Shard placement hashing (reference cluster.go:39-40, 776-857).

A copy of ``pilosa_tpu/parallel/hashing.py``: the first module of the
port's multi-device plane, here because the key translator partitions
column keys with ``fnv64a``.

partition = FNV-64a(index name + shard big-endian) mod 256; partition →
first owning node via the Lamping-Veach jump consistent hash; replicas =
the next replicaN-1 nodes on the (id-sorted) ring. Keeping the exact
hash layout means a resize moves the same minimal fragment set the
reference would move.
"""

from __future__ import annotations

DEFAULT_PARTITION_N = 256  # reference cluster.go:39-40


def fnv64a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def partition(index: str, shard: int, partition_n: int = DEFAULT_PARTITION_N) -> int:
    data = index.encode() + shard.to_bytes(8, "big")
    return fnv64a(data) % partition_n


def jump_hash(key: int, num_buckets: int) -> int:
    """Lamping-Veach jump consistent hash (the reference's jmphasher)."""
    if num_buckets <= 0:
        return -1
    b, j = -1, 0
    key &= 0xFFFFFFFFFFFFFFFF
    while j < num_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


class Jmphasher:
    def hash(self, key: int, n: int) -> int:
        return jump_hash(key, n)


class ModHasher:
    """Deterministic key % n hasher for tests (reference test.ModHasher,
    test/cluster.go:18-20)."""

    def hash(self, key: int, n: int) -> int:
        return key % n if n else -1
