"""Deterministic result cache: (graph fingerprint, canonical spec) -> result.

A copy of ``repro.service.cache``: equal requests key to the reference's
string.

Keys are SHA-256 over a canonical JSON encoding of the graph's content
fingerprint plus :meth:`DiscoveryRequest.canonical_spec`, so a repeated
query against unchanged data is served without touching the engine
(the reference's DESIGN.md §9.3).  Eviction is LRU with per-entry TTL expiry; the clock is
injectable so tests can drive expiry deterministically.
"""
from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional


def make_cache_key(graph_fingerprint: str, spec: Dict[str, Any]) -> str:
    """Deterministic cache key; `spec` must be JSON-serializable."""
    payload = json.dumps(
        {"graph": graph_fingerprint, "spec": spec},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


class ResultCache:
    """LRU + TTL cache for discovery responses."""

    def __init__(self, capacity: int = 256, ttl_s: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic):
        assert capacity >= 1
        self.capacity = capacity
        self.ttl_s = ttl_s
        self.clock = clock
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0     # capacity-driven LRU drops
        self.expirations = 0   # TTL-driven drops

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return self.peek(key) is not None

    def peek(self, key: str) -> Optional[Any]:
        """Like :meth:`get` but without touching hit/miss stats or LRU order."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        value, stored_at = entry
        if self.clock() - stored_at > self.ttl_s:
            del self._entries[key]
            self.expirations += 1
            return None
        return value

    def get(self, key: str) -> Optional[Any]:
        entry = self._entries.get(key)
        if entry is not None:
            value, stored_at = entry
            if self.clock() - stored_at > self.ttl_s:
                del self._entries[key]
                self.expirations += 1
            else:
                self._entries.move_to_end(key)   # most recently used
                self.hits += 1
                return value
        self.misses += 1
        return None

    def put(self, key: str, value: Any) -> None:
        self._entries[key] = (value, self.clock())
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)    # least recently used
            self.evictions += 1

    def stats(self) -> Dict[str, int]:
        return dict(size=len(self._entries), hits=self.hits,
                    misses=self.misses, evictions=self.evictions,
                    expirations=self.expirations)
