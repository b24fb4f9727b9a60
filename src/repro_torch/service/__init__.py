"""Multi-query discovery service on the Nuri engine (the reference's
DESIGN.md §9) — the port of ``repro.service``, on one device.

Layers, bottom-up:

* :mod:`repro_torch.service.api` — :class:`DiscoveryRequest` /
  :class:`DiscoveryResponse`, validation, the graph registry, and the
  compile step onto :class:`repro_torch.core.api.SubgraphComputation`;
* :mod:`repro_torch.service.cache` — deterministic LRU+TTL result cache keyed by
  (graph fingerprint, canonical query spec);
* :mod:`repro_torch.service.scheduler` — per-query tasks, the round-robin
  super-step scheduler, and the :class:`DiscoveryService` facade.
"""
from .api import (DiscoveryRequest, DiscoveryResponse, GraphRegistry,
                  ValidationError, WORKLOADS, compile_request)
from .cache import ResultCache, make_cache_key
from .scheduler import DiscoveryService, QueryScheduler

__all__ = [
    "DiscoveryRequest", "DiscoveryResponse", "GraphRegistry",
    "ValidationError", "WORKLOADS", "compile_request",
    "ResultCache", "make_cache_key",
    "DiscoveryService", "QueryScheduler",
]
