"""Wire shapes of node-to-node query results.

The reference exchanges protobuf QueryResponse messages
(internal/public.proto); here a remote leg's results travel as the HTTP
API's JSON, and ``Cluster._decode_remote`` maps them back to executor
result types. TopN's pairs cross as ``[{"id": .., "count": ..}]``.

The port of ``pilosa_tpu/parallel/wire.py``: the part a cluster uses.
The reference's tagged-JSON shard-result codec has no caller there
either, so it is not copied.
"""

from __future__ import annotations


def pairs_to_tuples(pairs: list) -> list[tuple[int, int]]:
    return [(p["id"], p["count"]) for p in pairs]
