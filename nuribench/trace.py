"""Reading a ``torch.profiler`` run: device time, idle gaps and what the
host was doing in them.

``device_activity`` and the interval union behind ``DeviceTrace`` are
frozen copies of ``chip_smoke.py::device_activity`` / ``device_busy``
(the events read from the profiler's own records, with no chrome-trace
round trip).  The profiler records the device's activity alone; its
events are put on ``time.perf_counter``, the clock of the program's
``repro_torch.obs`` spans and of the benchmark's requests, by a marker
kernel (``torch.cuda._sleep``) launched at a known ``perf_counter`` time
on an idle device: the trace's first device operation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: the marker kernel's length in cycles (a few microseconds)
MARK_CYCLES = 10000

Interval = Tuple[float, float]


def device_activity(e) -> Optional[str]:
    """The chrome trace's category of one profiler event on the device
    (``kernel``, ``gpu_memcpy``, ``gpu_memset``), or None for an event on
    the host or a user annotation.  Copies and sets are told by the names
    the profiler gives them ("Memcpy HtoD (Pageable -> Device)", "Memset
    (Device)"); the events carry no category in every torch release."""
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA or \
            getattr(e, "is_user_annotation", lambda: False)():
        return None
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Disjoint, sorted intervals covering exactly the given ones."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class DeviceTrace:
    """The device's side of a profiled window, on the host's
    ``perf_counter`` clock (seconds).

    ``ops`` holds ``(name, start, end)`` of every kernel, copy and set;
    ``busy`` their union, clipped to ``[start, end]``, the window."""

    def __init__(self, ops: List[Tuple[str, float, float]], start: float,
                 end: float):
        self.ops = ops
        self.start, self.end = start, end
        self.busy = clip(union([(a, b) for _, a, b in ops]), start, end)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def seconds_by_name(self) -> Dict[str, float]:
        """Device seconds of each operation name, inside the window."""
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            a, b = max(a, self.start), min(b, self.end)
            if b > a:
                out[name] = out.get(name, 0.0) + (b - a)
        return out

    def seconds_of(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(s for name, s in self.seconds_by_name().items()
                   if part in name)

    def part(self, start: float, end: float) -> "DeviceTrace":
        """The same operations over the window ``[start, end]``."""
        return DeviceTrace(self.ops, start, end)

    def gaps(self) -> List[Interval]:
        """The idle intervals of the window."""
        out, t = [], self.start
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out


def read_profile(prof, marker_perf_s: float, start: float,
                 end: float) -> DeviceTrace:
    """The :class:`DeviceTrace` of a finished profiler whose first device
    operation, the marker kernel, was launched at ``marker_perf_s`` on
    ``perf_counter``, for the window ``[start, end]`` on that clock.  The
    marker starts a launch's latency (microseconds) after that time, so
    the device's operations read that much late."""
    ops = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if device_activity(e) is not None]
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    offset = min(a for _, a, _ in ops) / 1e9 - marker_perf_s
    return DeviceTrace([(name, a / 1e9 - offset, (a + d) / 1e9 - offset)
                        for name, a, d in ops], start, end)


def host_timeline(host: Sequence[Tuple[str, float, float]],
                  outside: str) -> List[Tuple[float, float, str]]:
    """Segments ``(start, end, name)`` that cover the host ranges ``(name,
    start, end)``, each named after the innermost (shortest) range open
    over it; stretches that no range covers are named ``outside``."""
    bounds = sorted([(a, 1, i) for i, (_, a, _b) in enumerate(host)]
                    + [(b, 0, i) for i, (_, _a, b) in enumerate(host)])
    active: Dict[int, float] = {}
    out: List[Tuple[float, float, str]] = []
    for j, (t, is_start, i) in enumerate(bounds):
        if is_start:
            active[i] = host[i][2] - host[i][1]
        else:
            active.pop(i, None)
        if j + 1 < len(bounds) and bounds[j + 1][0] > t:
            name = (host[min(active, key=active.get)][0] if active
                    else outside)
            out.append((t, bounds[j + 1][0], name))
    return out


def idle_by_host(trace: DeviceTrace,
                 host: Sequence[Tuple[str, float, float]],
                 outside: str = "client") -> Dict[str, float]:
    """Idle device seconds by what the host was doing: each gap's parts go
    to the innermost host range ``(name, start, end)`` over them
    (:func:`host_timeline`), or to ``outside``."""
    segs = host_timeline(host, outside)
    out: Dict[str, float] = {}
    i = 0
    for g0, g1 in trace.gaps():
        t = g0
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while t < g1:
            if j < len(segs) and segs[j][0] <= t:
                b, name = min(segs[j][1], g1), segs[j][2]
                j += 1
            else:
                b = min(segs[j][0], g1) if j < len(segs) else g1
                name = outside
            if b > t:
                out[name] = out.get(name, 0.0) + (b - t)
            t = max(t, b)
    return out


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its return type and namespaces, cut to
    ``width`` characters (the templates' first arguments tell kernels of
    one name apart)."""
    for noise in ("void ", "at::native::", "at_cuda_detail::", "at::",
                  "(anonymous namespace)::", "cub::", "std::"):
        name = name.replace(noise, "")
    return name[:width]


def by_short_name(seconds: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s in seconds.items():
        out[short_name(name)] = out.get(short_name(name), 0.0) + s
    return out


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries, as ``[[name, seconds], ...]``."""
    return [[k, v] for k, v in sorted(items.items(),
                                      key=lambda kv: -kv[1])[:n]]
