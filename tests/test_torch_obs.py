"""Observability in the port (``repro_torch.obs`` through the engine, the
sharded engine, the checkpoint manager and the service): tests/test_obs.py's
engine and service cases, each run held to the reference's.

* ``observe=True`` is a pure observer: answers and every counter equal the
  reference's unobserved run at 1, 2 and 8 shards and ``steps_per_sync``
  1 and 16, and the metrics count what the run did;
* observe off records nothing; the top-level spans cover the run's wall;
* the checkpoint spans and metrics, at one shard and under shards; the
  service metrics; ``observe`` out of the result-cache key; the service's
  default no-op.

The reference's ``ShardedEngine`` needs one JAX device a shard, so its
runs take one subprocess of this file under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core.clique import make_clique_computation as ref_make_clique
from repro.core.engine import Engine as RefEngine
from repro.core.engine import EngineConfig as RefEngineConfig
from repro.data import synthetic_graphs as ref_gen
from repro_torch.core.clique import make_clique_computation
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.data.synthetic_graphs import densifying_graph
from repro_torch.distributed import ShardedEngine
from repro_torch.obs import NOOP, Observability, coverage, format_table
from repro_torch.service import DiscoveryRequest, DiscoveryService

torch.set_num_threads(2)

COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "syncs")
CFG = dict(k=3, batch=8, pool_capacity=128, max_steps=100_000)
SHARDED = [(2, 1), (2, 16), (8, 1), (8, 16)]     # (shards, steps_per_sync)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _record(res) -> dict:
    """A result as JSON values: keys, states, counters, per_shard."""
    rec = {name: int(getattr(res, name))
           for name in COUNTERS + ("host_syncs", "rebalanced")}
    rec.update(result_keys=np.asarray(res.result_keys).tolist(),
               result_states=np.asarray(res.result_states).tolist(),
               per_shard=json.loads(json.dumps(res.per_shard)))
    return rec


def _reference_child(out: pathlib.Path) -> None:
    """The reference's unobserved ShardedEngine runs of :data:`SHARDED`
    (this file as a script, 8 forced host devices), as one JSON file."""
    from repro.distributed import ShardedEngine as RefShardedEngine
    comp = ref_make_clique(ref_gen.densifying_graph(96, 900, seed=0))
    out.write_text(json.dumps({f"{s}x{t}": _record(RefShardedEngine(
        comp, RefEngineConfig(**CFG, shards=s, steps_per_sync=t)).run())
        for s, t in SHARDED}))


@pytest.fixture(scope="module")
def sharded_refs(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_reference") / "sharded.json"
    env = dict(os.environ,            # a stripped env can stall JAX start-up
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def clique_setup():
    """Spill, refill and late pruning all active (the instrumented paths);
    the reference's unobserved runs at T = 1 and 16."""
    comp = make_clique_computation(densifying_graph(96, 900, seed=0),
                                   device="cpu")
    ref_comp = ref_make_clique(ref_gen.densifying_graph(96, 900, seed=0))
    refs = {t: RefEngine(ref_comp, RefEngineConfig(
        **CFG, steps_per_sync=t)).run() for t in (1, 16)}
    assert refs[1].spilled > 0 and refs[1].refilled > 0
    return comp, EngineConfig(**CFG), refs


def _assert_parity(ref, res):
    assert res.result_keys.tobytes() == np.asarray(ref.result_keys).tobytes()
    assert res.result_states.tobytes() == \
        np.asarray(ref.result_states).tobytes()
    for name in COUNTERS + ("host_syncs",):
        assert getattr(res, name) == getattr(ref, name), name


@pytest.mark.parametrize("T", [1, 16])
def test_observe_parity(clique_setup, T):
    comp, cfg, refs = clique_setup
    eng = Engine(comp, dataclasses.replace(cfg, steps_per_sync=T,
                                           observe=True))
    res = eng.run()
    _assert_parity(refs[T], res)
    m = eng.obs.metrics
    assert m.get("engine_steps_total").value == res.steps
    assert m.get("engine_host_syncs_total").value == res.host_syncs
    assert m.get("engine_candidates_total").value > 0
    assert m.get("vpq_spilled_entries_total").value == res.spilled
    assert m.get("engine_refilled_total").value == res.refilled
    assert eng.obs.tracer.total_recorded > 0
    names = {s[0] for s in eng.obs.tracer.spans()}
    assert {"engine.start", "engine.step", "engine.device_compute",
            "engine.host_sync", "engine.finalize"} <= names


@pytest.mark.parametrize("shards,T", SHARDED)
def test_observe_parity_sharded(clique_setup, sharded_refs, shards, T):
    """tests/test_obs.py's 2- and 8-shard cases: the observed sharded run
    equals the reference's unobserved one in answer, counters and
    per-shard lists, and its metrics count the steps, host reads, bound
    exchanges, moved entries and spill."""
    comp, cfg, _ = clique_setup
    eng = ShardedEngine(comp, dataclasses.replace(
        cfg, shards=shards, steps_per_sync=T, observe=True))
    res = eng.run()
    assert _record(res) == sharded_refs[f"{shards}x{T}"]
    m = eng.obs.metrics
    for metric, name in (("engine_steps_total", "steps"),
                         ("engine_host_syncs_total", "host_syncs"),
                         ("engine_syncs_total", "syncs"),
                         ("engine_rebalanced_total", "rebalanced"),
                         ("engine_refilled_total", "refilled"),
                         ("vpq_spilled_entries_total", "spilled")):
        assert m.get(metric).value == getattr(res, name), metric
    assert m.get("engine_candidates_total").value > 0
    names = {s[0] for s in eng.obs.tracer.spans()}
    assert {"engine.start", "engine.step", "engine.device_compute",
            "engine.host_sync", "engine.finalize"} <= names


def test_observe_off_records_nothing(clique_setup):
    comp, cfg, refs = clique_setup
    eng = Engine(comp, cfg)
    _assert_parity(refs[1], eng.run())
    assert eng.obs is NOOP
    assert eng.obs.tracer.total_recorded == 0


def test_observe_coverage(clique_setup):
    """The top-level spans account for nearly all of an observed run's
    wall time."""
    comp, cfg, _ = clique_setup
    eng = Engine(comp, dataclasses.replace(cfg, observe=True))
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    spans = eng.obs.tracer.spans()
    cov = coverage(spans, wall)
    assert cov >= 0.85, format_table(spans, wall)
    assert cov <= 1.5


def test_shared_observability_across_engines(clique_setup):
    comp, cfg, _ = clique_setup
    shared = Observability()
    for _ in range(2):
        Engine(comp, dataclasses.replace(
            cfg, observe=True, observability=shared)).run()
    single = Engine(comp, dataclasses.replace(cfg, observe=True))
    single.run()
    assert shared.metrics.get("engine_steps_total").value == \
        2 * single.obs.metrics.get("engine_steps_total").value


@pytest.mark.parametrize("T", [1, 16])
def test_checkpoint_spans_and_metrics(clique_setup, tmp_path, T):
    comp, cfg, refs = clique_setup
    eng = Engine(comp, dataclasses.replace(
        cfg, steps_per_sync=T, observe=True, checkpoint_every=20,
        checkpoint_dir=str(tmp_path)))
    res = eng.run()
    _assert_parity(refs[T], res)
    m = eng.obs.metrics
    assert m.get("checkpoint_saves_total").value > 0
    assert m.get("checkpoint_bytes_written_total").value > 0
    assert m.get("checkpoint_commit_seconds").count == \
        m.get("checkpoint_saves_total").value
    assert m.get("checkpoint_capture_seconds").count == \
        m.get("checkpoint_saves_total").value
    names = {s[0] for s in eng.obs.tracer.spans()}
    assert {"checkpoint.save", "checkpoint.capture",
            "checkpoint.commit"} <= names


@pytest.mark.parametrize("shards,T", [(2, 1), (8, 16)])
def test_checkpoint_spans_and_metrics_sharded(clique_setup, sharded_refs,
                                              tmp_path, shards, T):
    """The checkpoint spans and metrics under shards: one save of every
    shard's queue a ``checkpoint.save``, one commit a save, and the answer
    the reference's unobserved run gives."""
    comp, cfg, _ = clique_setup
    eng = ShardedEngine(comp, dataclasses.replace(
        cfg, shards=shards, steps_per_sync=T, observe=True,
        checkpoint_every=4, checkpoint_dir=str(tmp_path)))
    assert _record(eng.run()) == sharded_refs[f"{shards}x{T}"]
    m = eng.obs.metrics
    saves = m.get("checkpoint_saves_total").value
    assert saves > 1
    assert m.get("checkpoint_bytes_written_total").value > 0
    assert m.get("checkpoint_commit_seconds").count == saves
    assert m.get("checkpoint_capture_seconds").count == saves
    spans = eng.obs.tracer.spans()
    assert sum(s[0] == "checkpoint.save" for s in spans) == saves
    assert {"checkpoint.save", "checkpoint.capture",
            "checkpoint.commit"} <= {s[0] for s in spans}
    step_dir = sorted(p for p in tmp_path.iterdir())[-1]
    assert sorted(os.listdir(step_dir / "vpq")) == [
        f"shard{i}" for i in range(shards)]


# ------------------------------------------------------------ service layer
@pytest.fixture(scope="module")
def social():
    return densifying_graph(80, 400, seed=3)


def _service(social, **kw):
    svc = DiscoveryService(device="cpu", **kw)
    svc.register_graph("social", social)
    return svc


def test_observe_excluded_from_cache_key(social):
    base = dict(graph="social", workload="clique", k=3, step_budget=50)
    req_off = DiscoveryRequest(**base)
    req_on = DiscoveryRequest(**base, observe=True)
    assert req_off.canonical_spec() == req_on.canonical_spec()
    assert "observe" not in req_on.canonical_spec()
    svc = _service(social, observability=Observability())
    r1 = svc.query(req_on)
    r2 = svc.query(req_off)
    assert r1.status == r2.status == "ok"
    assert not r1.cached and r2.cached
    assert r1.results == r2.results
    assert svc.obs.metrics.get("service_cache_hits_total").value == 1
    assert svc.obs.metrics.get("service_cache_misses_total").value == 1


def test_service_metrics_accumulate(social):
    svc = _service(social, observability=Observability())
    ok = svc.query(DiscoveryRequest(graph="social", workload="clique",
                                    k=3, step_budget=40, observe=True))
    assert ok.status == "ok"
    bad = svc.query(DiscoveryRequest(graph="nope", workload="clique", k=3))
    assert bad.status == "error"
    m = svc.obs.metrics
    assert m.get("service_requests_total").value == 2
    assert m.get("service_validation_errors_total").value == 1
    assert m.get("service_request_seconds").count >= 1
    assert m.get("service_queue_wait_seconds").count >= 1
    assert m.get("service_engine_steps_total").value == \
        m.get("engine_steps_total").value == ok.stats["steps"] > 0
    assert isinstance(ok.stats["straggler_steps"], int)


def test_service_default_is_noop(social):
    svc = _service(social)
    assert svc.obs is NOOP
    resp = svc.query(DiscoveryRequest(graph="social", workload="clique",
                                      k=3, step_budget=40))
    assert resp.status == "ok"
    assert NOOP.tracer.total_recorded == 0


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
