"""The metric arithmetic on synthetic records: the device trace's union,
gaps and idle attribution, the roofline's bytes, and every metric reader
on a synthetic run."""
import json
from pathlib import Path

import pytest

from nuribench import harness, roofline
from nuribench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_union_gaps_and_clip():
    d = tr.DeviceTrace([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0),
                        ("a", 9.0, 12.0)], 0.0, 10.0)
    assert d.busy == [(1.0, 3.0), (5.0, 6.0), (9.0, 10.0)]
    assert d.busy_s == pytest.approx(4.0)
    assert d.gaps() == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.0)]
    assert d.seconds_by_name() == pytest.approx(dict(a=2.0, b=1.5, c=1.0))
    assert d.seconds_of("a") == pytest.approx(2.0)


def test_idle_goes_to_the_innermost_host_range():
    d = tr.DeviceTrace([("k", 1.0, 2.0), ("k", 4.0, 5.0)], 0.0, 10.0)
    host = [("serve", 0.5, 9.0), ("drive", 1.5, 8.0), ("spill", 2.5, 3.0)]
    idle = tr.idle_by_host(d, host)
    assert idle == pytest.approx(dict(client=1.5, serve=1.5, drive=4.5,
                                      spill=0.5))
    assert sum(idle.values()) == pytest.approx(d.window_s - d.busy_s)
    assert tr.top(idle, 1) == [["drive", 4.5]]


def test_scoring_bound_at_the_clique_shape():
    # 64 rows and 46,336 columns of 1,448 words, 64 x 46,336 counts
    assert roofline.scoring_bytes(64, 46336, False) == \
        4 * (64 * 1448 + 46336 * 1448 + 64 * 46336)
    assert 1e3 * roofline.scoring_bound_s(64, 46336, False) == \
        pytest.approx(0.083764, rel=1e-4)
    assert roofline.scoring_bytes(64, 32768, True) > \
        roofline.scoring_bytes(64, 32768, False)


def _run(workload="clique", device=True):
    """Two requests of 100 steps each, 1 s apart, the first profiled;
    spans, and a device trace of the profiled part with a scoring kernel
    and another pass."""
    sent = [harness.Sent(dict(batch=64, request_id=str(i)), 10.0 + i,
                         10.5 + i, dict(status="ok", terminated="complete",
                                        stats=dict(steps=100, spilled=7)))
            for i in range(2)]
    spans = [("service.drive", 10.1 + i, 0.3, 0) for i in range(2)]
    spans += [("engine.start", 10.05 + i, 0.05, 0) for i in range(2)]
    spans += [("engine.device_compute", 10.2 + i, 0.1 * (1 + i), 0)
              for i in range(2)]
    spans += [("engine.host_sync", 10.3 + i, 0.05, 0) for i in range(2)]
    spans += [("engine.spill", 10.35 + i, 0.02, 0) for i in range(2)]
    spans += [("engine.refill", 10.37 + i, 0.01, 0) for i in range(2)]
    spans += [("engine.host_sync", 20.0, 5.0, 0)]   # outside every request
    ops = [("masked_intersect_kernel_mma<true>", 10.2, 10.21),
           ("elementwise", 10.22, 10.3),
           ("elementwise", 11.22, 11.3)]             # after the profiler
    config = dict(request=dict(workload=workload), num_vertices=46336)
    return harness.Run(config=config, setup_s=3.0,
                       start=10.0, end=11.5, sent=sent, spans=spans,
                       device=tr.DeviceTrace(ops, 10.0, 10.6)
                       if device else None, profiled=1)


def test_each_reader_on_a_synthetic_run():
    run = _run()
    read = {m["name"]: harness.read_metric(m["name"], run)
            for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]}
    assert read["setup_s"] == 3.0
    assert read["query_s"] == pytest.approx(0.75)
    # the host's readers read the unprofiled request alone
    assert read["service.host_ms"] == pytest.approx(150.0)
    assert read["engine.start_ms"] == pytest.approx(50.0)
    assert read["engine.enqueue_ms"] == pytest.approx(2.0)
    assert read["engine.host_sync_ms"] == pytest.approx(0.5)
    assert read["vpq.spill_refill_ms"] == pytest.approx(0.3)
    # the device's readers read the profiled part
    assert read["passes.device_ms"] == pytest.approx(0.8)
    bound = 100 * roofline.scoring_bound_s(64, 46336, False)
    assert read["kernel.scoring_roofline"] == pytest.approx(
        100 * bound / 0.01)
    assert read["device.idle_share"] == pytest.approx(
        100 * (1 - 0.09 / 0.6))


def test_readers_find_nothing_where_there_is_nothing():
    run = _run(workload="weighted-clique", device=False)
    assert harness.read_metric("kernel.scoring_roofline", run) is None
    assert harness.read_metric("passes.device_ms", run) is None
    assert harness.read_metric("device.idle_share", run) is None
    for s in run.sent:
        s.response["stats"]["spilled"] = 0
    assert harness.read_metric("vpq.spill_refill_ms", run) is None
    run.profiled = 2                # every request profiled: no host part
    assert harness.read_metric("service.host_ms", run) is None
    assert harness.read_metric("engine.enqueue_ms", run) is None


def test_a_part_of_a_trace_reads_its_own_window():
    d = tr.DeviceTrace([("a", 1.0, 2.0), ("b", 5.0, 6.0)], 0.0, 10.0)
    part = d.part(1.5, 5.5)
    assert part.window_s == pytest.approx(4.0)
    assert part.busy_s == pytest.approx(1.0)
    assert part.seconds_of("b") == pytest.approx(0.5)


def test_metrics_of_a_cell_follow_their_workloads():
    names = [m["name"] for m in harness.metrics_of(
        MANIFEST, "clique-densify.t16", trace=True)]
    assert "kernel.scoring_roofline" in names and \
        "device.idle_share" in names
    e2e = [m["name"] for m in harness.metrics_of(
        MANIFEST, "clique-densify.t1", trace=False)]
    assert e2e == ["setup_s", "query_s"]
