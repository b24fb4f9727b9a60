"""The readers of the program's device windows (``passes.*_ms``) and of its
service spans (``service.own_ms``) on a hand-built run, the split of a
traced run's device time over the windows (``nuribench/passes.py``), and
on the card that split in both cells at full size."""
import json
from pathlib import Path

import pytest
import torch

from nuribench import harness, passes
from nuribench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
HOST = 140000000000001                      # a Python thread id
PASSES = ("pass.dequeue", "pass.score", "pass.select", "pass.materialize",
          "pass.insert", "pass.accumulate", "pass.refill")
READERS = ["passes.dequeue_ms", "passes.score_ms", "passes.select_ms",
           "passes.materialize_ms", "passes.insert_ms",
           "passes.accumulate_ms", "passes.refill_ms", "service.own_ms"]


def _run(tid=passes.DEVICE_TID, service=True):
    """Two requests of 100 steps, the first profiled: each has one device
    window of each pass, 0.01 s long (the refill's 0.02), and its service
    spans; the windows of a third, late, set start after the last answer
    and count nowhere."""
    sent = [harness.Sent(dict(batch=64, request_id=str(i)), 10.0 + i,
                         10.5 + i, dict(status="ok", terminated="complete",
                                        stats=dict(steps=100, spilled=7)))
            for i in range(2)]
    spans = []
    for i in range(3):
        t = 10.1 + i
        for j, name in enumerate(PASSES):
            spans.append((name, t + 0.03 * j, 0.02 if name == "pass.refill"
                          else 0.01, tid))
        spans.append(("engine.step", t - 0.01, 0.3, HOST))
    if service:
        spans += [("service.admit", 10.0 + i, 0.06, HOST) for i in range(2)]
        spans += [("engine.start", 10.01 + i, 0.05, HOST) for i in range(2)]
        spans += [("service.finalize", 10.45 + i, 0.004, HOST)
                  for i in range(2)]
    config = dict(request=dict(workload="clique"), num_vertices=46336)
    return harness.Run(config=config, setup_s=3.0, start=10.0, end=11.5,
                       sent=sent, spans=spans, device=None, profiled=1)


def test_the_readers_are_in_the_manifest():
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["moves"] == "query_s"
        assert m["better"] == "lower"
        assert (ROOT / "nuribench" / "metrics" / f"{name}.py").is_file()
    assert per_layer["passes.accumulate_ms"]["workloads"] == \
        ["clique-densify.t16"]
    assert {m["layer"] for n, m in per_layer.items()
            if n.startswith("passes.")} == {"engine device passes"}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_on_a_hand_built_run(name):
    """The unprofiled request alone: 0.01 s of each window over its 100
    steps (the refill's 0.02), and 0.06 + 0.004 - 0.05 s of service."""
    want = {"passes.refill_ms": 0.2, "service.own_ms": 14.0}.get(name, 0.1)
    assert harness.read_metric(name, _run()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_device_windows(name):
    """Host spans of the passes (a CPU run) and a program with no such
    span read nothing; so does a run whose every request was profiled."""
    host = _run(tid=HOST, service=False)
    assert harness.read_metric(name, host) is None
    run = _run()
    run.profiled = 2
    assert harness.read_metric(name, run) is None


def test_the_frozen_device_tid_is_the_programs():
    from repro_torch.obs import DEVICE_TID
    assert passes.DEVICE_TID == DEVICE_TID


def test_split_of_a_hand_built_trace():
    """Windows [1, 2) and [2, 4) of one step [0.5, 5), a window of a second
    step [6, 8) that leaves it, and device operations at [1.5, 3.5) inside
    and [4.5, 5) and [7, 7.5) outside the windows."""
    d = passes.DEVICE_TID
    spans = [("engine.step", 0.5, 4.5, HOST), ("engine.step", 6.0, 2.0, HOST),
             ("pass.dequeue", 1.0, 1.0, d), ("pass.score", 2.0, 2.0, d),
             ("pass.refill", 6.5, 2.0, d), ("pass.score", 3.0, 0.5, HOST)]
    ops = [("k", 1.5, 3.5), ("memcpy", 4.5, 5.0), ("k", 7.0, 7.5)]
    run = harness.Run(config={}, setup_s=0.0, start=0.0, end=10.0, sent=[],
                      spans=spans, device=tr.DeviceTrace(ops, 0.0, 10.0))
    s = passes.split(run)
    assert s["windows"] == 3 and s["steps"] == 2
    assert s["passes"]["pass.dequeue"] == pytest.approx(
        dict(count=1, window_s=1.0, busy_s=0.5, idle_s=0.5))
    assert s["passes"]["pass.score"]["busy_s"] == pytest.approx(1.5)
    assert s["passes"]["pass.refill"]["busy_s"] == pytest.approx(0.5)
    assert s["inside_share"] == pytest.approx(2.5 / 3.0)
    assert s["outside_ops"] == [["memcpy", pytest.approx(0.5)]]
    assert s["overlaps"] == 0 and s["outside_step"] == 1
    assert s["max_past_step_s"] == pytest.approx(0.5)
    spans.append(("pass.select", 3.5, 1.0, d))     # overlaps pass.score
    assert passes.split(run)["overlaps"] == 1


@pytest.mark.parametrize("drift", [0.0, 2e-5])
def test_split_lines_the_trace_up_with_the_windows(drift):
    """A trace 1.5 ms early, and ``drift`` s/s more over 4 s: each step's
    scoring kernel runs 0.2 ms into its 1 ms ``pass.score`` window (0.3 ms
    into it in the last step) and lasts 0.4 ms, after a 0.4 ms operation
    0.3 ms into ``pass.dequeue``.  The shift puts the kernel that leads
    least at its window's start (leaving the trace about 0.2 ms early),
    and every operation then lies inside the windows."""
    d, spans, ops = passes.DEVICE_TID, [], []
    for i in range(200):
        t, lead = 0.02 * i, (0.0003 if i == 199 else 0.0002)
        early = 0.0015 + drift * t
        spans += [("engine.step", t, 0.009, HOST),
                  ("pass.dequeue", t + 0.0002, 0.0008, d),
                  ("pass.score", t + 0.001, 0.001, d)]
        ops += [("gather", t + 0.0005 - early, t + 0.0009 - early),
                ("masked_intersect_kernel_mma<true>",
                 t + 0.001 + lead - early, t + 0.0014 + lead - early)]
    run = harness.Run(config={}, setup_s=0.0, start=-0.01, end=4.0, sent=[],
                      spans=spans, device=tr.DeviceTrace(ops, -0.01, 4.0))
    s = passes.split(run)
    shift = s["trace_shift"]
    assert shift["slope"] == pytest.approx(drift, abs=1e-6)
    assert 0.0013 <= shift["offset"] <= 0.0013 + drift + 1e-9
    assert shift["fit"] == 1.0
    assert s["unshifted_inside_share"] == pytest.approx(0.0)
    assert s["inside_share"] == pytest.approx(1.0)
    assert s["passes"]["pass.score"]["busy_s"] == pytest.approx(
        200 * 0.0004, rel=1e-4)          # the drift stretches the trace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["clique-densify.t1", "clique-densify.t16"])
def test_pass_windows_hold_the_profiled_device_time(card, cell, monkeypatch):
    """A traced run of the cell at full size whose window profiles its
    first query: at least 90% of the device's busy time there lies inside
    the ``pass.*`` windows, and the windows of a step neither overlap nor
    leave it; every pass metric of the cell is reported."""
    runs = []
    read = harness.read_metric

    def spy(name, run):
        runs.append(run)
        return read(name, run)

    monkeypatch.setattr(harness, "read_metric", spy)
    result = harness.run_cell(ROOT, MANIFEST, cell, 2 ** 31 + 11, 1.0, True,
                              log=lambda line: None)
    assert result["correct"] and runs[0].device is not None
    s = passes.split(runs[0])
    assert s["inside_share"] >= 0.9, s
    assert s["overlaps"] == 0 and s["outside_step"] == 0, s
    want = {m["name"] for m in harness.metrics_of(MANIFEST, cell, True)
            if m["name"].startswith("passes.") and m["source"] ==
            "program_span"} | {"service.own_ms"}
    assert want <= set(result["metrics"])
