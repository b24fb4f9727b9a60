"""Device windows: the engine's passes timed on the device's own clock and
put on the host's (docs/OBSERVABILITY.md, "The port").

A pass's window is a pair of timing ``torch.cuda.Event`` objects recorded
on the current stream at the pass's first and last enqueue.  A window
opened right after another starts at that one's end event, so adjacent
windows share their boundary and tile a step; the anchor and each
collection end the chain, so what runs between two steps, or between a
step's passes and its host read, falls in no window.  At the start of each
engine step the device is idle: the previous step's host read and its
spill and refill copies waited on the stream.  So the step records one
*anchor* event there, beside ``time.perf_counter()``, and a window of that
step runs from ``anchor_perf + anchor.elapsed_time(start) / 1e3`` to the
same reading of its end event.  Re-anchoring every step keeps the two
clocks from drifting apart; a window's error is the anchor's launch
latency, a few microseconds.

The windows are converted by :meth:`DeviceWindows.collect`, called right
after a host read that waited on the stream behind them: nothing waits
for an event, and no synchronisation is added.  A window recorded after
the step's own read (the refill's) is converted at the next one.  Each
becomes an ordinary ``(name, start, dur, tid)`` span of the
:class:`~repro_torch.obs.trace.SpanTracer`, on the ``perf_counter``
clock, with ``tid`` :data:`~repro_torch.obs.trace.DEVICE_TID`.

A window's length is stream time from the pass's first operation to its
last; it holds the time the device waited inside the pass for the host to
enqueue the pass's next operation.

On a CPU device the operations are synchronous, so a window is an ordinary
host span around the same code (:func:`pass_windows`), and with
observability off it is the shared ``NULL_SPAN``.
"""
from __future__ import annotations

import time

from repro_torch.obs.trace import DEVICE_TID, NULL_SPAN


def _timing_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


def _current_stream():
    import torch
    return torch.cuda.current_stream()


def timed_on_device(device) -> bool:
    """Whether the windows of an engine on ``device`` (a ``torch.device``)
    are device windows: its operations run asynchronously to the host."""
    return device.type == "cuda"


class _Window:
    """Context manager recording one pass's start and end events."""

    __slots__ = ("_w", "_name", "_e0")

    def __init__(self, windows: "DeviceWindows", name: str):
        self._w = windows
        self._name = name

    def __enter__(self) -> "_Window":
        w = self._w
        e = w._edge
        if e is None:
            e = w._take()
            e.record(w._stream)
        self._e0 = e
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        w = self._w
        w._edge = e1 = w._take()
        e1.record(w._stream)
        w._pending.append((self._name, w._anchor, w._anchor_perf, self._e0,
                           e1))


class DeviceWindows:
    """The device windows of one engine, recorded into ``tracer``.

    Events come from a pool kept per engine: an event goes back to it once
    its window is converted, so the pool stops growing after the engine's
    first steps and a step makes no event after that (``made`` counts the
    events made).  The step's stream is looked up once, at the anchor
    (the lookup costs twice an event's record).  ``event`` makes one timing
    event and ``stream`` returns the current stream (stand-ins in the
    tests)."""

    def __init__(self, tracer, event=None, stream=None):
        self._tracer = tracer
        self._event = event if event is not None else _timing_event
        self._current_stream = stream if stream is not None \
            else _current_stream
        self._stream = None
        self._edge = None          # the last window's end: the next's start
        self._free: list = []
        self.made = 0
        self._anchor = None
        self._anchor_perf = 0.0
        self._retired: list = []   # replaced anchors, until collected
        self._pending: list = []   # (name, anchor, anchor_perf, e0, e1)

    def _take(self):
        if self._free:
            return self._free.pop()
        self.made += 1
        return self._event()

    def anchor(self) -> None:
        """Record the step's anchor; the device must be idle."""
        if self._anchor is not None:
            self._retired.append(self._anchor)
        self._edge = None
        ev = self._take()
        self._stream = self._current_stream()
        self._anchor_perf = time.perf_counter()
        ev.record(self._stream)
        self._anchor = ev

    def window(self, name: str):
        """The window of one pass, a context manager; none before the
        first anchor."""
        if self._anchor is None:
            return NULL_SPAN
        return _Window(self, name)

    def collect(self) -> None:
        """Convert every pending window into a span.  Call right after a
        host read that waited on the stream behind them; should the last
        one not be complete yet, all of them wait for the next call.  A
        window opened after this call starts afresh."""
        self._edge = None
        pending = self._pending
        if pending and not pending[-1][4].query():
            return
        at = {}                    # id(event) -> (event, perf_counter time)
        for name, anchor, perf, e0, e1 in pending:
            for ev in (e0, e1):
                if id(ev) not in at:
                    at[id(ev)] = ev, perf + anchor.elapsed_time(ev) / 1e3
            start = at[id(e0)][1]
            self._tracer._record(name, start, at[id(e1)][1] - start,
                                 DEVICE_TID)
        pending.clear()
        self._free.extend(ev for ev, _ in at.values())
        self._free.extend(self._retired)
        self._retired.clear()


class _NullWindows:
    """No device windows: the anchor and the collection do nothing."""

    made = 0

    def anchor(self) -> None:
        pass

    def collect(self) -> None:
        pass


NULL_WINDOWS = _NullWindows()


def pass_windows(obs, device):
    """``(window, windows)`` for an engine on ``device``: ``window(name)``
    is the context manager of one pass, ``windows`` anchors a step and
    collects its windows.  With ``obs`` off, ``window`` hands back
    ``NULL_SPAN``; on a CPU device it is a host span."""
    if obs.enabled and timed_on_device(device):
        windows = DeviceWindows(obs.tracer)
        return windows.window, windows
    return obs.tracer.span, NULL_WINDOWS
