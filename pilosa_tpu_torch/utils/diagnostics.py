"""Diagnostics collector (reference diagnostics.go) — opt-in hourly
phone-home of anonymous deployment shape (version, schema counts,
memory/OS info) plus a version check. Disabled by default; zero-egress
deployments simply never enable it."""

from __future__ import annotations

import json
import os
import platform
import threading
import time
import urllib.request
from typing import Optional

DEFAULT_INTERVAL = 3600.0


class DiagnosticsCollector:
    def __init__(self, host: str = "", version: str = "", logger=None) -> None:
        self.host = host
        self.version = version
        self.logger = logger
        self.metrics: dict = {}
        self.mu = threading.Lock()
        self.start_time = time.time()

    def set(self, name: str, value) -> None:
        with self.mu:
            self.metrics[name] = value

    def enrich_with_os_info(self) -> None:
        self.set("OSPlatform", platform.system())
        self.set("OSKernelVersion", platform.release())
        self.set("OSArch", platform.machine())
        self.set("NumCPU", os.cpu_count())
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        self.set("MemTotalKB", int(line.split()[1]))
                        break
        except OSError:
            pass

    def enrich_with_schema(self, holder) -> None:
        num_fields = 0
        num_views = 0
        for idx in holder.indexes.values():
            num_fields += len(idx.fields)
            for f in idx.fields.values():
                num_views += len(f.views)
        self.set("NumIndexes", len(holder.indexes))
        self.set("NumFields", num_fields)
        self.set("NumViews", num_views)

    def payload(self) -> dict:
        with self.mu:
            out = dict(self.metrics)
        out["Version"] = self.version
        out["UptimeSeconds"] = int(time.time() - self.start_time)
        return out

    def flush(self) -> None:
        """POST the payload to the diagnostics host (no-op when unset)."""
        if not self.host:
            return
        try:
            req = urllib.request.Request(
                self.host,
                data=json.dumps(self.payload()).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            urllib.request.urlopen(req, timeout=10).close()
        except Exception as e:
            if self.logger:
                self.logger.debugf("diagnostics flush failed: %s", e)

    def check_version(self) -> Optional[str]:
        """Query the diagnostics host for the latest released version
        (reference VersionCheck); None when disabled/unreachable."""
        if not self.host:
            return None
        try:
            with urllib.request.urlopen(
                self.host + "/version", timeout=10
            ) as resp:
                return json.loads(resp.read()).get("version")
        except Exception:
            return None
