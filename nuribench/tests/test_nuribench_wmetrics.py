"""The weighted cell's two roofline readers on hand-built runs: each reads
its kernel's device time in the profiled part against its bound
(``nuribench/wroofline.py``), and nothing outside the weighted workload or
without a trace."""
import pytest

from nuribench import harness, wroofline
from nuribench import trace as tr

N = 46336


def _run(workload="weighted-clique", device=True):
    """One profiled request of 100 steps and 200,000 children (candidates
    less the N seeds), with 0.01 s of the scoring kernel and 0.02 s of the
    child rows' kernel in its trace."""
    sent = [harness.Sent(dict(batch=64, request_id="0"), 10.0, 11.0,
                         dict(status="ok", terminated="complete",
                              stats=dict(steps=100, candidates=N + 200000)))]
    ops = [("masked_intersect_kernel_mma<true>", 10.1, 10.105),
           ("masked_intersect_kernel_mma<true>", 10.2, 10.205),
           ("void (anonymous namespace)::clique_children_kernel<true>(x)",
            10.3, 10.32),
           ("elementwise_kernel", 10.4, 10.5)]
    config = dict(request=dict(workload=workload), num_vertices=N)
    return harness.Run(config=config, setup_s=1.0, start=10.0, end=11.0,
                       sent=sent, spans=[],
                       device=tr.DeviceTrace(ops, 10.0, 11.0)
                       if device else None, profiled=1)


def test_the_bounds_at_the_cells_shape():
    w = 1448
    assert wroofline.wscoring_bound_s(64, N) == pytest.approx(
        (4 * (64 * w + N * w + 64 * N) + 4 * N) / 3.35e12)
    assert 1e3 * wroofline.wscoring_bound_s(64, N) == pytest.approx(
        0.0838, abs=5e-4)
    # the [N, S] block alone: 537 MB, 0.160 ms
    assert 1e3 * wroofline.wchildren_bound_s(1, N, N, 0) == pytest.approx(
        0.1603, abs=5e-4)


def test_each_reader_on_a_synthetic_run():
    run = _run()
    got = harness.read_metric("kernel.wscoring_roofline", run)
    assert got == pytest.approx(
        100 * 100 * wroofline.wscoring_bound_s(64, N) / 0.01)
    got = harness.read_metric("kernel.wchildren_roofline", run)
    assert got == pytest.approx(
        100 * wroofline.wchildren_bound_s(100, N, N, 200000) / 0.02)


@pytest.mark.parametrize("name", ["kernel.wscoring_roofline",
                                  "kernel.wchildren_roofline"])
def test_readers_find_nothing_where_there_is_nothing(name):
    assert harness.read_metric(name, _run(workload="clique")) is None
    assert harness.read_metric(name, _run(device=False)) is None
