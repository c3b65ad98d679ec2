"""Cluster address abstraction: scheme/host/port triple.

Mirrors the reference's URI semantics (reference uri.go:45-264):
every part is optional — ``http://localhost:10101``, ``localhost:10101``,
``:10101``, ``localhost`` and ``http://localhost`` all parse to the same
address. Defaults: scheme ``http``, host ``localhost``, port ``10101``.
IPv6 hosts are bracketed. ``scheme+x`` variants (the reference's
``http+gossip``) normalize to the part before ``+`` for HTTP clients
(uri.go:136-144).

This is the canonical module; ``parallel.node`` re-exports ``URI`` for
back-compat. Beyond the reference's surface it adds ``equivalent`` /
``same_endpoint``: the bind-vs-advertise bug class (equivalent
spellings — loopback aliases, default-port omission — failing string
equality) is killed by comparing through these instead of ``==`` on
strings.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

DEFAULT_SCHEME = "http"
DEFAULT_HOST = "localhost"
DEFAULT_PORT = 10101

# Validation shapes follow reference uri.go:28-30: scheme is lowercase
# letters plus '+', host is hostname chars or a bracketed IPv6 literal.
_SCHEME_RE = re.compile(r"^[+a-z]+$")
_HOST_RE = re.compile(r"^[0-9a-z.\-]+$|^\[[:0-9a-fA-F]+\]$")
_ADDRESS_RE = re.compile(
    r"^(?:(?P<scheme>[+a-z]+)://)?"
    r"(?P<host>[0-9a-z.\-]+|\[[:0-9a-fA-F]+\])?"
    r"(?::(?P<port>[0-9]+))?$"
)


class URIError(ValueError):
    """Invalid address / scheme / host / port."""


@dataclass
class URI:
    """Scheme/host/port triple (reference uri.go:45-264).

    All parts optional when parsing: ``http://localhost:10101``,
    ``localhost``, and ``:10101`` are equivalent spellings.
    """

    scheme: str = DEFAULT_SCHEME
    host: str = DEFAULT_HOST
    port: int = DEFAULT_PORT

    @classmethod
    def from_address(
        cls,
        addr: str,
        default_scheme: str = DEFAULT_SCHEME,
        default_port: int = DEFAULT_PORT,
    ) -> "URI":
        m = _ADDRESS_RE.fullmatch((addr or "").strip())
        if m is None or (
            not m.group("host") and m.group("port") is None and not m.group("scheme")
        ):
            raise URIError(f"invalid address: {addr!r}")
        port = int(m.group("port") or default_port)
        if port > 0xFFFF:
            raise URIError(f"invalid address: {addr!r} (port out of range)")
        return cls(
            scheme=m.group("scheme") or default_scheme,
            host=m.group("host") or DEFAULT_HOST,
            port=port,
        )

    @classmethod
    def from_host_port(cls, host: str, port: int) -> "URI":
        u = cls(port=port)
        u.set_host(host)
        return u

    def set_scheme(self, scheme: str) -> None:
        if not _SCHEME_RE.fullmatch(scheme):
            raise URIError(f"invalid scheme: {scheme!r}")
        self.scheme = scheme

    def set_host(self, host: str) -> None:
        if not _HOST_RE.fullmatch(host):
            raise URIError(f"invalid host: {host!r}")
        self.host = host

    def __str__(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def host_port(self) -> str:
        return f"{self.host}:{self.port}"

    def normalize(self) -> str:
        """Address usable by an HTTP client: a ``+``-qualified scheme
        (e.g. ``https+pb``) drops its qualifier (reference uri.go:135-142)."""
        scheme = self.scheme.split("+", 1)[0]
        return f"{scheme}://{self.host}:{self.port}"

    def path(self, p: str) -> str:
        return f"{self.normalize()}{p}"

    def to_dict(self) -> dict:
        return {"scheme": self.scheme, "host": self.host, "port": self.port}

    @classmethod
    def from_dict(cls, d: dict) -> "URI":
        return cls(
            scheme=d.get("scheme", DEFAULT_SCHEME),
            host=d.get("host", DEFAULT_HOST),
            port=int(d.get("port", DEFAULT_PORT)),
        )

    def equivalent(self, other: "URI") -> bool:
        """Same endpoint for client purposes: normalized scheme + a
        host comparison that treats the loopback spellings as one
        (localhost / 127.0.0.1 / [::1]) — a node advertising one and
        binding another is the same listener."""
        if other is None:
            return False
        return (
            self.scheme.split("+", 1)[0] == other.scheme.split("+", 1)[0]
            and _canon_host(self.host) == _canon_host(other.host)
            and self.port == other.port
        )


_LOOPBACK = {"localhost", "127.0.0.1", "[::1]", "::1"}


def _canon_host(h: str) -> str:
    return "localhost" if h in _LOOPBACK else h


def same_endpoint(a: str, b: str, default_scheme: str = DEFAULT_SCHEME) -> bool:
    """True when two address strings name the same listener, across
    equivalent spellings. Unparseable addresses fall back to string
    equality (never raises — this guards hot comparison seams)."""
    if a == b:
        return True
    try:
        return URI.from_address(a, default_scheme).equivalent(
            URI.from_address(b, default_scheme)
        )
    except URIError:
        return False
