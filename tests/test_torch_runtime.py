"""The port's copy of the fault-tolerance runtime
(``repro_torch.runtime.fault_tolerance``): tests/test_runtime.py's cases
(StragglerMonitor bounded memory, Heartbeat staleness), and the monitor
flagging the same steps as the reference's on one random trace."""
import time

import numpy as np
import pytest

from repro.runtime import fault_tolerance as ref_ft
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerMonitor


# ------------------------------------------------------------ StragglerMonitor
def test_straggler_warmup_never_flags():
    m = StragglerMonitor(threshold=2.0, warmup_steps=3)
    # wildly varying warmup durations must not flag
    assert not m.record(0, 1.0)
    assert not m.record(1, 100.0)
    assert not m.record(2, 0.01)
    assert m.straggler_steps == 0


def test_straggler_flags_slow_step_and_counts():
    m = StragglerMonitor(threshold=2.0, warmup_steps=1)
    m.record(0, 1.0)              # warmup: ema = 1.0
    assert not m.record(1, 1.5)   # below 2x
    assert m.record(2, 10.0)      # straggler
    assert m.straggler_steps == 1
    assert len(m.events) == 1
    step, duration, ema = m.events[0]
    assert step == 2 and duration == 10.0


def test_straggler_ema_not_polluted_by_stragglers():
    # a straggler must not drag the EMA up, else one slow step masks the
    # next: after flagging a 10x step the baseline should be unchanged
    m = StragglerMonitor(threshold=2.0, ema=0.9, warmup_steps=1)
    m.record(0, 1.0)
    ema_before = m.ema
    assert m.record(1, 10.0)
    assert m.ema == ema_before


def test_straggler_events_bounded_total_monotone():
    # events once grew without bound on long serving runs.  The deque keeps only the newest max_events; straggler_steps keeps
    # the monotone total that response stats report.
    m = StragglerMonitor(threshold=2.0, warmup_steps=1, max_events=8)
    m.record(0, 1.0)
    n = 100
    for i in range(1, n + 1):
        assert m.record(i, 50.0)   # every step a straggler (EMA frozen)
    assert m.straggler_steps == n
    assert len(m.events) == 8
    # the retained window is the newest 8
    assert [e[0] for e in m.events] == list(range(n - 7, n + 1))


def test_straggler_default_cap():
    m = StragglerMonitor()
    assert m.events.maxlen == 256


# ------------------------------------------------------------------- Heartbeat
def test_heartbeat_fresh(tmp_path):
    p = str(tmp_path / "hb")
    Heartbeat(p).beat(step=3)
    assert not Heartbeat.is_stale(p, timeout=60.0)


def test_heartbeat_stale(tmp_path):
    p = str(tmp_path / "hb")
    with open(p, "w") as f:
        f.write(f"5 {time.time() - 100.0}")
    assert Heartbeat.is_stale(p, timeout=60.0)
    assert not Heartbeat.is_stale(p, timeout=1000.0)


def test_heartbeat_missing_is_stale(tmp_path):
    assert Heartbeat.is_stale(str(tmp_path / "never-written"), timeout=60.0)


@pytest.mark.parametrize("content", ["", "garbage", "1 2 3", "x y"])
def test_heartbeat_malformed_is_stale(tmp_path, content):
    p = str(tmp_path / "hb")
    with open(p, "w") as f:
        f.write(content)
    assert Heartbeat.is_stale(p, timeout=60.0)


def test_heartbeat_creates_parent_dir(tmp_path):
    p = str(tmp_path / "nested" / "dir" / "hb")
    hb = Heartbeat(p)
    hb.beat(step=1)
    assert not Heartbeat.is_stale(p, timeout=60.0)


@pytest.mark.parametrize("seed", range(3))
def test_straggler_flags_what_the_reference_flags(seed):
    durations = np.random.default_rng(seed).lognormal(0.0, 0.8, 400)
    port, ref = StragglerMonitor(max_events=16), ref_ft.StragglerMonitor(
        max_events=16)
    flags = [(port.record(i, d), ref.record(i, d))
             for i, d in enumerate(durations.tolist())]
    assert all(a == b for a, b in flags)
    assert port.straggler_steps == ref.straggler_steps > 0
    assert list(port.events) == list(ref.events)
    assert port.ema == ref.ema
