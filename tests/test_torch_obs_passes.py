"""The engine's pass windows (``pass.*``, ``repro_torch.obs.windows``) on
the CPU: one window a pass and super-step, ``pass.accumulate`` only in
macro-steps, ``pass.refill`` once a refill, every window inside its
``engine.step`` and none overlapping another, and answers and counters
equal to the unobserved run's, byte for byte.

On the CPU a window is a host span.  The device path (timing events, an
anchor a step, windows converted after the host read) runs here too, with a
stand-in event that reads ``perf_counter`` at ``record``; a scripted event
checks the conversion to the host's clock.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core.clique import make_clique_computation
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.data.synthetic_graphs import densifying_graph
from repro_torch.distributed import ShardedEngine
from repro_torch.obs import DEVICE_TID, NULL_SPAN, NULL_WINDOWS, \
    Observability, SpanTracer
from repro_torch.obs import windows as win

torch.set_num_threads(2)

CFG = dict(k=3, batch=8, pool_capacity=128, max_steps=100_000)
PASSES = ("pass.dequeue", "pass.score", "pass.select", "pass.materialize",
          "pass.insert")
CASES = [(t, s) for t in (1, 16) for s in (1, 2)]   # (steps_per_sync, shards)


@pytest.fixture(scope="module")
def comp():
    """Spill, refill and late pruning all active (tests/test_torch_obs.py's
    graph)."""
    return make_clique_computation(densifying_graph(96, 900, seed=0),
                                   device="cpu")


class PerfEvent:
    """A stand-in timing event on the CPU: ``record`` reads
    ``perf_counter``, so the windows read the host's time of each pass."""
    made = 0

    def __init__(self):
        PerfEvent.made += 1
        self.t = None

    def record(self, stream):
        self.t = win.time.perf_counter()

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


@pytest.fixture
def device_path(monkeypatch):
    """Every device's windows through the device path, with PerfEvent."""
    monkeypatch.setattr(win, "timed_on_device", lambda device: True)
    monkeypatch.setattr(win, "_timing_event", PerfEvent)
    monkeypatch.setattr(win, "_current_stream", lambda: "stream")
    PerfEvent.made = 0


def _engine(comp, T, shards, observe):
    cfg = EngineConfig(**CFG, steps_per_sync=T, shards=shards,
                       observe=observe)
    return ShardedEngine(comp, cfg) if shards > 1 else Engine(comp, cfg)


def _record(res) -> dict:
    rec = {f.name: getattr(res, f.name)
           for f in dataclasses.fields(res)}
    rec["result_states"] = np.asarray(res.result_states).tobytes()
    rec["result_keys"] = np.asarray(res.result_keys).tobytes()
    rec["per_shard"] = json.dumps(res.per_shard)
    return rec


def _run(eng):
    """``Engine.run`` without checkpoints, counting the steps that
    refilled (or moved) pool entries; returns the result and that count."""
    st = eng.start()
    refills = 0
    while not st.done and st.steps < eng.cfg.max_steps:
        before = st.refilled + getattr(st, "rebalanced", 0)
        eng.step(st, max_inner=eng.cfg.max_steps - st.steps)
        refills += st.refilled + getattr(st, "rebalanced", 0) > before
    return eng.finalize(st), refills


def _check_windows(eng, res, refills, T, shards):
    """Counts, nesting and order of the windows of an observed run."""
    spans = eng.obs.tracer.spans()
    count = {}
    for name, *_ in spans:
        count[name] = count.get(name, 0) + 1
    # every step() launches T super-steps here (max_steps never binds):
    # one window a pass and shard in each, no-op steps included
    launched = res.host_syncs * T
    for name in PASSES:
        assert count.get(name) == launched * shards, name
    assert count.get("pass.accumulate", 0) == (launched if T > 1 else 0)
    assert refills > 0 and count.get("pass.refill") == refills
    steps = sorted((a, a + d) for n, a, d, _ in spans if n == "engine.step")
    assert len(steps) == res.host_syncs
    windows = sorted((a, a + d, n) for n, a, d, _ in spans
                     if n.startswith("pass."))
    starts = [a for a, _ in steps]
    per_step = {}
    for a, b, name in windows:
        i = int(np.searchsorted(starts, a, side="right")) - 1
        assert i >= 0 and b <= steps[i][1], (name, a, b, steps[i])
        per_step.setdefault(i, []).append((a, b, name))
    for ws in per_step.values():      # sorted by start: none overlaps
        assert all(w0[1] <= w1[0] for w0, w1 in zip(ws, ws[1:]))
    return spans, per_step


@pytest.mark.parametrize("T,shards", CASES)
def test_pass_windows_on_the_cpu(comp, T, shards):
    """Host spans on the CPU device: the counts, their steps, and the
    answer and counters of the unobserved run."""
    plain, _ = _run(_engine(comp, T, shards, observe=False))
    eng = _engine(comp, T, shards, observe=True)
    res, refills = _run(eng)
    assert _record(res) == _record(plain)
    spans, _ = _check_windows(eng, res, refills, T, shards)
    assert all(tid != DEVICE_TID for *_, tid in spans)


@pytest.mark.parametrize("T,shards", CASES)
def test_pass_windows_through_the_device_path(comp, device_path, T, shards):
    """The device path with stand-in events: the same windows, on the
    device track, inside their steps, the passes of a step tiling it; the
    answer unchanged; the event pool stops growing (its size is bounded
    by one step's windows, the last refill's and two anchors)."""
    plain, _ = _run(_engine(comp, T, shards, observe=False))
    assert PerfEvent.made == 0           # observe off makes no event
    eng = _engine(comp, T, shards, observe=True)
    res, refills = _run(eng)
    assert _record(res) == _record(plain)
    spans, per_step = _check_windows(eng, res, refills, T, shards)
    windows = [s for s in spans if s[0].startswith("pass.")]
    assert all(tid == DEVICE_TID for *_, tid in windows)
    for ws in per_step.values():      # a step's passes tile it
        passes = [w for w in ws if w[2] != "pass.refill"]
        assert all(w0[1] == w1[0] for w0, w1 in zip(passes, passes[1:]))
    # a step's windows share their boundaries: one event each and one
    # to start the chain, then the last refill's two and two anchors
    per_step = 5 * shards * T + (T if T > 1 else 0) + 1
    made = eng._windows.made if shards == 1 else eng._eng._windows.made
    assert made == PerfEvent.made
    assert made <= per_step + 2 + 2 + 2 < len(windows)


@pytest.mark.parametrize("T,shards", CASES)
def test_observe_off_creates_no_event(comp, device_path, T, shards):
    eng = _engine(comp, T, shards, observe=False)
    inner = eng if shards == 1 else eng._eng
    assert inner._windows is NULL_WINDOWS and inner._pass("x") is NULL_SPAN
    _run(eng)
    assert PerfEvent.made == 0


class ScriptedEvent:
    """A timing event whose device time (ms) at each ``record`` comes from
    a script shared by every event."""

    def __init__(self, script, done):
        self.script, self.done = script, done
        self.t = None

    def record(self, stream):
        assert stream == "stream"
        self.t = next(self.script)

    def query(self):
        return self.t in self.done

    def elapsed_time(self, other):
        return other.t - self.t


def test_event_to_clock_conversion(monkeypatch):
    """A window starts at the anchor's ``perf_counter`` plus the device
    time from the anchor to its first event, and lasts the device time
    between its events; the next window starts at its end event; a window
    opened after a collection starts afresh; a window whose end is not
    complete waits, with every one after it, for the next collection, and
    keeps its step's anchor."""
    script = iter([100.0, 100.5, 102.0, 104.25,             # step 1
                   110.0, 112.0,                             # its refill
                   115.0,                                    # step 2
                   200.0, 203.0])                            # step 2's pass
    done = set()
    tracer = SpanTracer()
    w = win.DeviceWindows(tracer, event=lambda: ScriptedEvent(script, done),
                          stream=lambda: "stream")
    assert w.window("pass.early") is NULL_SPAN     # no anchor yet
    clock = iter([50.0, 60.0])
    monkeypatch.setattr(win.time, "perf_counter", lambda: next(clock))
    w.anchor()
    for name in ("pass.a", "pass.b"):
        with w.window(name):
            pass
    done.update({100.0, 100.5, 102.0, 104.25})
    w.collect()
    spans = tracer.spans()
    assert [s[0] for s in spans] == ["pass.a", "pass.b"]
    assert spans[0][1:] == pytest.approx((50.0005, 0.0015, DEVICE_TID))
    assert spans[1][1:] == pytest.approx((50.002, 0.00225, DEVICE_TID))
    with w.window("pass.refill"):      # after the step's read
        pass
    w.collect()                        # its end is not complete: it waits
    assert len(tracer.spans()) == 2
    w.anchor()                         # step 2, at 60 s and 115 ms
    with w.window("pass.c"):
        pass
    done.update({110.0, 112.0, 115.0, 200.0, 203.0})
    w.collect()
    spans = tracer.spans()[2:]
    assert [s[0] for s in spans] == ["pass.refill", "pass.c"]
    # the refill reads step 1's anchor, pass.c step 2's
    assert spans[0][1:] == pytest.approx((50.010, 0.002, DEVICE_TID))
    assert spans[1][1:] == pytest.approx((60.085, 0.003, DEVICE_TID))
    # eight records from six events: each converted window's events and
    # the replaced anchor went back to the pool, which holds all but the
    # live anchor
    assert w.made == 6 and len(w._free) == 5


def test_chrome_trace_names_the_device_track():
    tracer = SpanTracer()
    tracer._record("engine.step", 1.0, 0.5)
    tracer._record("pass.score", 1.1, 0.2, DEVICE_TID)
    events = tracer.chrome_trace(pid=7)["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    assert {e["name"] for e in meta} == {"thread_name", "thread_sort_index"}
    assert all(e["tid"] == DEVICE_TID for e in meta)
    assert [e["name"] for e in events if e["ph"] == "X"] == [
        "engine.step", "pass.score"]
    plain = SpanTracer()
    plain._record("engine.step", 1.0, 0.5)
    assert all(e["ph"] == "X"
               for e in plain.chrome_trace()["traceEvents"])


def test_pass_windows_follow_the_device():
    on, off = Observability(), Observability(enabled=False)
    assert win.pass_windows(off, torch.device("cuda")) == \
        (off.tracer.span, NULL_WINDOWS)
    window, windows = win.pass_windows(on, torch.device("cpu"))
    assert windows is NULL_WINDOWS and window == on.tracer.span
    window, windows = win.pass_windows(on, torch.device("cuda", 0))
    assert isinstance(windows, win.DeviceWindows)
    assert window == windows.window and windows.made == 0
