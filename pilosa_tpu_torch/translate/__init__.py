"""Key translation subsystem — durable sharded key↔id
stores with federated id assignment and the keyed query surface.

The port of ``pilosa_tpu/translate/``, whole. Its logs are the
reference's byte for byte, so a data directory moves between the two.
On one node the translator's cluster seams (``owner_resolver``,
``forward_to``, ``forward``, ``on_assign``) stay None: every space is
owned here and minted here. The multi-device plane (ROADMAP A8) wires
them.

Sits between the PQL surface and the executor:

* ``store.SpaceStore`` — one append-only CRC-framed fsync'd log per
  key space (a column partition of an index, or the rows of one
  field), in-memory hash rebuilt at open, torn tail truncated at
  recovery. An acked key→id assignment is never lost; an id is never
  reassigned.
* ``translator.Translator`` — the server-level facade: partitions
  column keys by hash across the cluster (parallel/hashing.py jump
  hash), forwards minting to each partition's owning node over
  ``InternalClient``, adopts the owner's assignments durably, and
  replicates assignments to peers (broadcast push + per-store pull).
  Duck-type compatible with ``utils/translate.TranslateStore`` so the
  executor and API layers don't care which they hold.
* ``resolve`` — keys→ids resolution over parsed PQL calls (run by the
  planner BEFORE canonicalization, so plan-cache keys and CSE hashes
  see resolved ids only) and ids→keys translation of results.
"""

from pilosa_tpu_torch.translate.store import SpaceStore
from pilosa_tpu_torch.translate.translator import Translator

__all__ = ["SpaceStore", "Translator"]
