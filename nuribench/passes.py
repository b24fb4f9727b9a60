"""The program's device windows: the engine's passes (``pass.*`` spans on
the device track of ``repro_torch.obs``), each timed on the card's own
clock and put on ``perf_counter``, the clock of the requests.

:func:`per_step_ms` is what the ``passes.*_ms`` metrics read.  :func:`split`
lines a traced run's device trace up with the windows' clock and lays the
windows over it: each pass's windows, the busy and idle time inside them,
the share of the device's busy time that they hold, what lies outside them
by operation name, and whether the windows of a step overlap or leave it
(``scripts/pass_split.py``, the card test in
``tests/test_nuribench_pass_metrics.py``).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nuribench import trace as tr

#: the ``tid`` of a device window: a frozen copy of
#: ``repro_torch.obs.trace.DEVICE_TID`` (a program without it records none)
DEVICE_TID = 1
#: the scoring kernel's name, every variant
SCORING = "masked_intersect_kernel"


def per_step_ms(run, name: str):
    """ms a step of the device windows ``name`` that start while one of the
    unprofiled requests is in flight; None where the program recorded no
    such window (a CPU run, or a program without them)."""
    sent = run.host_part()
    steps = run.steps(sent)
    found = [s for s in run.spans if s[0] == name and s[3] == DEVICE_TID]
    if not steps or not found:
        return None
    return 1e3 * dataclasses.replace(run, spans=found).span_s(name, sent) \
        / steps


def _overlap(a: Sequence[tr.Interval], b: Sequence[tr.Interval]) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _outside(ops, covered: List[tr.Interval], lo: float, hi: float
             ) -> Dict[str, float]:
    """Device seconds of each operation name in ``[lo, hi]`` that the
    sorted disjoint intervals ``covered`` leave out."""
    ends = [b for _, b in covered]
    out: Dict[str, float] = {}
    for name, a, b in ops:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        left = b - a
        i = bisect.bisect_right(ends, a)
        while i < len(covered) and covered[i][0] < b:
            left -= min(b, covered[i][1]) - max(a, covered[i][0])
            i += 1
        if left > 0:
            name = tr.short_name(name)
            out[name] = out.get(name, 0.0) + left
    return out


def _trace_shift(found, ops) -> Optional[dict]:
    """The seconds to add to the trace's times, a line over time, that put
    it on the windows' clock.  The trace is put on ``perf_counter`` by one
    marker kernel at its start (``trace.read_profile``), the windows by an
    anchor event each step, and every scoring kernel runs inside its
    super-step's ``pass.score`` window.  So the one shift that fits the
    most kernels into windows pairs each window with its kernel; a
    window's lower bound is the shift that puts its kernel at the window's
    start; in each second of the part the largest lower bound (the kernel
    that leads least) is taken, and a line fit through them is raised to
    lie on or above each.  The trace is then early by about the least lead
    before the kernel in its pass (a few small operations).  ``offset`` is
    the line at the first window's start ``t0`` (s), ``slope`` its drift
    (s/s), ``fit`` the share of windows whose kernel lies inside after the
    shift."""
    kernels = sorted((a, b) for name, a, b in ops if SCORING in name)
    wins = sorted((a, b) for a, b, name in found if name == "pass.score")
    if len(wins) < 10 or len(kernels) < 2:
        return None
    ks = np.array([a for a, _ in kernels])
    ke = np.array([b for _, b in kernels])
    ws = np.array([a for a, _ in wins])
    we = np.array([b for _, b in wins])
    # the constant shift inside the most [window - kernel] intervals, over
    # the six kernels nearest each window
    near = np.searchsorted(ks, ws)
    bounds = []
    for j in range(-3, 3):
        k = np.clip(near + j, 0, len(ks) - 1)
        ok = ws - ks[k] <= we - ke[k]
        bounds += [(x, 1) for x in (ws - ks[k])[ok]]
        bounds += [(x, -1) for x in (we - ke[k])[ok]]
    bounds.sort(key=lambda e: (e[0], -e[1]))
    depth, best, rough = 0, 0, 0.0
    for x, step in bounds:
        depth += step
        if depth > best:
            best, rough = depth, x
    # each window's kernel: the one nearest to it under that shift
    x = ws - rough
    i = np.clip(np.searchsorted(ks, x), 1, len(ks) - 1)
    k = np.where(np.abs(ks[i - 1] - x) <= np.abs(ks[i] - x), i - 1, i)
    lo = ws - ks[k]
    second = np.floor(ws - ws[0]).astype(int)
    bins = [second == b for b in np.unique(second)]
    t = np.array([ws[m].mean() for m in bins]) - ws[0]
    top = np.array([lo[m].max() for m in bins])
    slope, offset = np.polyfit(t, top, 1) if len(t) > 1 \
        else (0.0, float(top[0]))
    offset += float((top - offset - slope * t).max())   # on or above each
    c = offset + slope * (ws - ws[0])
    fit = float(np.mean((ws <= ks[k] + c + 1e-7) & (ke[k] + c <= we + 1e-7)))
    return dict(offset=float(offset), slope=float(slope), t0=float(ws[0]),
                fit=fit)


def split(run) -> dict:
    """The device windows of the profiled part of a traced run on a card
    against its device trace.  Per pass: ``window_s`` (the windows' sum),
    ``busy_s`` (device busy inside them) and ``idle_s``; ``inside_share``,
    the share of the device's busy time inside some window;
    ``outside_ops``, the busy seconds outside every window by operation;
    per step: ``overlaps`` (pairs of a step's windows that overlap) and
    ``outside_step`` (windows that start in a step and end after it),
    with ``max_past_step_s``.  The trace is first shifted onto the
    windows' clock where the scoring kernels allow it (``trace_shift``,
    :func:`_trace_shift`; ``unshifted_inside_share`` is the share before
    the shift)."""
    dev = run.device
    lo, hi = dev.start, dev.end
    found = sorted((a, a + d, n) for n, a, d, tid in run.spans
                   if tid == DEVICE_TID and n.startswith("pass.")
                   and lo <= a < hi)
    shift = _trace_shift(found, dev.ops)
    unshifted = _overlap(tr.union([(a, b) for a, b, _ in found]), dev.busy)
    if shift is not None:
        def moved(t):
            return t + shift["offset"] + shift["slope"] * (t - shift["t0"])
        dev = tr.DeviceTrace([(n, moved(a), moved(b)) for n, a, b in dev.ops],
                             lo, hi)
    passes = {}
    for name in sorted({n for _, _, n in found}):
        own = tr.union([(a, b) for a, b, n in found if n == name])
        window = sum(b - a for a, b, n in found if n == name)
        busy = _overlap(own, dev.busy)
        passes[name] = dict(count=sum(n == name for _, _, n in found),
                            window_s=window, busy_s=busy,
                            idle_s=window - busy)
    covered = tr.union([(a, b) for a, b, _ in found])
    inside = _overlap(covered, dev.busy)
    steps = sorted((a, a + d) for n, a, d, _ in run.spans
                   if n == "engine.step" and lo <= a < hi)
    overlaps = outside_step = 0
    past = 0.0
    by_step: Dict[int, List[Tuple[float, float]]] = {}
    starts = [a for a, _ in steps]
    for a, b, _ in found:
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or b > steps[i][1]:
            outside_step += 1
            past = max(past, b - (steps[i][1] if i >= 0 else a))
        by_step.setdefault(i, []).append((a, b))
    for ws in by_step.values():
        overlaps += sum(b0 > a1 for (_, b0), (a1, _) in zip(ws, ws[1:]))
    return dict(passes=passes, windows=len(found), steps=len(steps),
                trace_shift=shift,
                unshifted_inside_share=(unshifted / dev.busy_s
                                        if dev.busy_s else None),
                busy_s=dev.busy_s, window_s=dev.window_s,
                inside_s=inside,
                inside_share=inside / dev.busy_s if dev.busy_s else None,
                outside_ops=tr.top(_outside(dev.ops, covered, lo, hi), 12),
                overlaps=overlaps, outside_step=outside_step,
                max_past_step_s=past)
