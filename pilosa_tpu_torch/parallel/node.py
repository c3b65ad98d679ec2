"""Cluster node identity (reference pilosa.Node); URI lives in
utils/uri.py and is re-exported here for back-compat."""

from __future__ import annotations

from dataclasses import dataclass

from pilosa_tpu_torch.utils.uri import URI

__all__ = ["Node", "URI"]


@dataclass
class Node:
    id: str
    uri: str  # http://host:port
    is_coordinator: bool = False
    state: str = "READY"
    # federation: lifecycle of the gang this node leads ("" for plain
    # nodes) — peers stop routing writes to a DEGRADED/REFORMING gang
    # and prefer gang-ACTIVE owners for reads (parallel/federation.py)
    gang_state: str = ""
    gang_epoch: int = 0

    def to_dict(self) -> dict:
        d = {
            "id": self.id,
            "uri": self.uri,
            "isCoordinator": self.is_coordinator,
            "state": self.state,
        }
        # optional-keyed: plain-cluster payloads stay byte-stable
        if self.gang_state:
            d["gangState"] = self.gang_state
            d["gangEpoch"] = self.gang_epoch
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(
            id=d["id"],
            uri=d["uri"],
            is_coordinator=d.get("isCoordinator", False),
            state=d.get("state", "READY"),
            gang_state=d.get("gangState", ""),
            gang_epoch=d.get("gangEpoch", 0),
        )
