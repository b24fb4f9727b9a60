"""Low-overhead metrics registry (DESIGN.md §16).

Three metric kinds, Prometheus-shaped:

* :class:`Counter` — monotone accumulator (``inc``); int or float amounts.
* :class:`Gauge` — last-write-wins instantaneous value (``set``/``inc``).
* :class:`Histogram` — fixed **log-spaced** buckets chosen at construction
  (:func:`log_buckets`), cumulative-``le`` semantics like the Prometheus
  text format.  Fixed buckets keep ``observe`` O(log buckets) with no
  allocation — the per-step hot path must stay in the microseconds.

All metrics are thread-safe (one lock per metric — the checkpoint writer
thread and the serve loop record concurrently).  The registry snapshots
to a plain dict (:meth:`MetricsRegistry.snapshot`) and to the Prometheus
text exposition format (:meth:`MetricsRegistry.to_prometheus`), both pure
reads.

The **null registry** (:data:`NULL_REGISTRY`) hands every caller one
shared do-nothing metric, so instrumented code holds real attribute
references whether observability is on or off and pays only a no-op
method call when off (DESIGN.md §16 overhead budget: <3% steps/sec with
metrics on, ~0% with the no-op — asserted by ``benchmarks/bench_obs.py``).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Optional, Sequence


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple:
    """Fixed log-spaced histogram bounds from ``lo`` to ``hi`` inclusive,
    ``per_decade`` bounds per factor of 10.  ``log_buckets(1e-3, 1, 1)``
    is ``(1e-3, 1e-2, 1e-1, 1.0)``."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = round(math.log10(hi / lo) * per_decade)
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


# default bounds for duration histograms: 1µs .. 100s, 3 buckets/decade —
# covers a kernel dispatch through a full checkpoint flush
DEFAULT_TIME_BUCKETS = log_buckets(1e-6, 100.0, per_decade=3)


def _fmt(v) -> str:
    """Prometheus sample-value formatting: integral floats print as
    integers so the text round-trips through ``float()`` losslessly."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone counter; ``inc`` accepts int or float amounts (float for
    accumulated seconds, e.g. ``vpq_disk_read_seconds_total``)."""

    __slots__ = ("name", "help", "_lock", "_value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount=1) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up ({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self._value}


class Gauge:
    __slots__ = ("name", "help", "_lock", "_value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount=1) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self._value}


class Histogram:
    """Fixed-bucket histogram.  ``bounds[i]`` is the inclusive upper edge
    of bucket ``i`` (Prometheus ``le``); one implicit ``+Inf`` bucket
    catches the rest.  ``observe`` is a bisect + two adds under a lock."""

    __slots__ = ("name", "help", "bounds", "_lock", "_counts", "_sum",
                 "_count")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        bounds = tuple(buckets) if buckets is not None \
            else DEFAULT_TIME_BUCKETS
        if any(nxt <= cur for nxt, cur in zip(bounds[1:], bounds)):
            raise ValueError(f"{name}: bucket bounds must be strictly "
                             f"increasing, got {bounds}")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)      # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value) -> None:
        i = bisect_left(self.bounds, value)         # first bound >= value
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": self.kind, "sum": self._sum,
                    "count": self._count, "bounds": list(self.bounds),
                    "counts": list(self._counts)}


class MetricsRegistry:
    """Name -> metric, get-or-create.  Callers resolve their handles once
    (constructor time) and hit the metric objects directly on the hot
    path — the registry lock is never taken per step."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view of every metric (JSON-serializable)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: dict(m.snapshot(), help=m.help) for m in metrics}

    def to_prometheus(self) -> str:
        """Prometheus/OpenMetrics text exposition of the registry."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if m.kind == "histogram":
                snap = m.snapshot()
                cum = 0
                for bound, c in zip(snap["bounds"], snap["counts"]):
                    cum += c
                    lines.append(
                        f'{m.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
                lines.append(
                    f'{m.name}_bucket{{le="+Inf"}} {snap["count"]}')
                lines.append(f"{m.name}_sum {_fmt(snap['sum'])}")
                lines.append(f"{m.name}_count {snap['count']}")
            else:
                lines.append(f"{m.name} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------------------- no-op
class _NullMetric:
    """One shared instance stands in for every metric when observability
    is off: same call surface, no state, no locks."""

    __slots__ = ()
    kind = "null"
    name = ""
    help = ""
    value = 0
    count = 0
    sum = 0.0

    def inc(self, amount=1) -> None:
        pass

    def set(self, value) -> None:
        pass

    def observe(self, value) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


NULL_METRIC = _NullMetric()


class NullRegistry:
    """Registry that hands out :data:`NULL_METRIC` for everything."""

    def counter(self, name: str, help: str = ""):
        return NULL_METRIC

    def gauge(self, name: str, help: str = ""):
        return NULL_METRIC

    def histogram(self, name: str, help: str = "", buckets=None):
        return NULL_METRIC

    def get(self, name: str):
        return None

    def names(self) -> list:
        return []

    def snapshot(self) -> dict:
        return {}

    def to_prometheus(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()
