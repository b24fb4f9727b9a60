"""Fault-tolerance runtime for durable discovery serving (the reference's
DESIGN.md §15) — a copy of ``repro.runtime.fault_tolerance``.

* :class:`StragglerMonitor` — EMA step-time watchdog.  The service layer
  runs one per live query (``repro_torch.service.scheduler.EngineQueryTask``):
  an engine (macro-)step slower than ``threshold × EMA`` is flagged and
  the count is surfaced as ``stats["straggler_steps"]`` in the query's
  response — a per-query slow-step audit for multi-tenant serving.
* :class:`Heartbeat` — liveness file the serve loop
  (``repro_torch.launch.serve --heartbeat``) touches after every flushed batch;
  an external supervisor declares the worker dead when the heartbeat goes
  stale, kills it, and restarts with ``--resume`` — checkpointed queries
  then continue from their newest committed step with answers
  byte-identical to an uninterrupted run (tests/test_torch_fault_injection.py
  proves exactly this cycle under SIGKILL).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional


class StragglerMonitor:
    """``events`` keeps only the newest ``max_events`` straggler records
    (a long-lived serving query would otherwise grow it without bound);
    ``straggler_steps`` is the monotone total and is what response stats
    report."""

    def __init__(self, threshold: float = 2.5, ema: float = 0.9,
                 warmup_steps: int = 3, max_events: int = 256):
        self.threshold = threshold
        self.ema_factor = ema
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.seen = 0
        self.straggler_steps = 0
        self.events: deque = deque(maxlen=max_events)

    def record(self, step: int, duration: float) -> bool:
        """Returns True when this step is a straggler."""
        self.seen += 1
        if self.seen <= self.warmup:
            self.ema = duration if self.ema is None else \
                0.5 * (self.ema + duration)
            return False
        is_straggler = duration > self.threshold * self.ema
        if is_straggler:
            self.straggler_steps += 1
            self.events.append((step, duration, self.ema))
        else:
            self.ema = self.ema_factor * self.ema + \
                (1 - self.ema_factor) * duration
        return is_straggler


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int):
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}")

    @staticmethod
    def is_stale(path: str, timeout: float) -> bool:
        try:
            with open(path) as f:
                _, ts = f.read().split()
            return time.time() - float(ts) > timeout
        except (OSError, ValueError):
            return True
