"""Span tracer with an in-memory ring buffer (DESIGN.md §16).

A *span* is a named timed phase (``engine.step``, ``vpq.refill``,
``checkpoint.commit`` ...).  :meth:`SpanTracer.span` returns a context
manager; on exit the completed span is recorded as a plain tuple
``(name, start_s, dur_s, tid)`` into a fixed-capacity ring buffer —
recording is an index increment plus a tuple store under a lock, no
allocation beyond the tuple, so tracing the per-step hot path stays
inside the §16 overhead budget.  When the ring wraps, the oldest spans
are dropped and :attr:`SpanTracer.dropped` counts them.

The buffer exports the Chrome trace-event JSON format (``ph: "X"``
complete events with microsecond ``ts``/``dur``), which loads directly
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing`` — see
docs/OBSERVABILITY.md for the how-to.

:data:`NULL_TRACER` is the disabled twin: ``span()`` hands back one
shared pre-built no-op context manager, so a disabled tracer costs a
method call returning a constant.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

#: the ``tid`` of device windows (``repro_torch.obs.windows``): their own
#: track, "device", in the Chrome / Perfetto export.  A Python thread id
#: is an address and never this small.
DEVICE_TID = 1


class _Span:
    """Context manager recording one completed span on ``__exit__``.
    Spans are recorded even when the body raises — a phase that died
    mid-flight is exactly what a trace should show."""

    __slots__ = ("_tracer", "name", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str):
        self._tracer = tracer
        self.name = name
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        self._tracer._record(self.name, self._t0, t1 - self._t0)


class SpanTracer:
    """Fixed-capacity ring buffer of completed spans."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._next = 0              # monotone write index (never wraps)
        # epoch anchoring perf_counter spans to wall time for exports
        self._epoch_wall = time.time()
        self._epoch_perf = time.perf_counter()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _record(self, name: str, start: float, dur: float,
                tid: Optional[int] = None) -> None:
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            self._ring[self._next % self.capacity] = (name, start, dur,
                                                      tid)
            self._next += 1

    # ------------------------------------------------------------- reads
    @property
    def total_recorded(self) -> int:
        return self._next

    @property
    def dropped(self) -> int:
        return max(0, self._next - self.capacity)

    def spans(self) -> List[tuple]:
        """Retained spans, oldest first: ``(name, start_s, dur_s, tid)``
        with ``start_s`` on the ``time.perf_counter`` clock."""
        with self._lock:
            n = self._next
            if n <= self.capacity:
                out = self._ring[:n]
            else:
                i = n % self.capacity
                out = self._ring[i:] + self._ring[:i]
            return list(out)

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0

    # ----------------------------------------------------------- exports
    def chrome_trace(self, pid: Optional[int] = None) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``)
        with ``ph: "X"`` complete events, µs timestamps anchored to the
        epoch wall clock.  Loadable in Perfetto as-is.  Device windows
        (``tid`` :data:`DEVICE_TID`) get a track named "device", sorted
        below the host's threads."""
        if pid is None:
            pid = os.getpid()
        base = self._epoch_wall - self._epoch_perf
        events = []
        for name, start, dur, tid in self.spans():
            events.append({
                "name": name, "ph": "X", "pid": pid, "tid": tid,
                "ts": (base + start) * 1e6, "dur": dur * 1e6,
            })
        if any(e["tid"] == DEVICE_TID for e in events):
            events[:0] = [
                {"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": DEVICE_TID, "args": {"name": "device"}},
                {"name": "thread_sort_index", "ph": "M", "pid": pid,
                 "tid": DEVICE_TID, "args": {"sort_index": 1 << 30}}]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str,
                            pid: Optional[int] = None) -> str:
        """Write :meth:`chrome_trace` to ``path`` (JSON); returns the
        path for chaining."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(pid=pid), f)
        return path


# ------------------------------------------------------------------- no-op
class _NullSpan:
    """Shared do-nothing context manager — the disabled tracing path."""

    __slots__ = ()
    name = ""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


class NullTracer:
    capacity = 0
    total_recorded = 0
    dropped = 0

    def span(self, name: str) -> _NullSpan:
        return NULL_SPAN

    def spans(self) -> list:
        return []

    def clear(self) -> None:
        pass

    def chrome_trace(self, pid: Optional[int] = None) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str,
                            pid: Optional[int] = None) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(pid=pid), f)
        return path


NULL_TRACER = NullTracer()
