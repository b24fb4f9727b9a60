"""Durable runs in the port (``repro_torch.checkpoint``, ``Engine.resume``,
the service's checkpoint knobs) on the CPU against the reference.

* the manager: layout, ``.tmp`` sweep, ``keep_last``, leaf names and leaf
  order equal to ``jax.tree``'s, manifests equal to the reference
  manager's, checkpoints that each package's manager restores from the
  other's, and host copies taken before ``save`` returns;
* the VPQ's snapshot and restore (the cases of tests/test_vpq_lifecycle.py)
  within the port and across the two packages;
* tests/test_checkpoint_resume.py's single-device cases, each port result
  held to the reference's uninterrupted run;
* both cross-package directions: a checkpoint taken mid-run with a
  non-empty disk queue by one package's engine, resumed by the other's,
  finishes byte-identical to the uninterrupted reference run.
"""
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro.core import engine as ref_engine
from repro.core import vpq as ref_vpq
from repro.core.clique import make_clique_computation as ref_make_clique
from repro.data import synthetic_graphs as ref_gen
from repro.launch.serve import serve_discovery as ref_serve
from repro.service import DiscoveryRequest as RefRequest
from repro.service import DiscoveryService as RefService
from repro_torch import carry
from repro_torch.checkpoint import manager
from repro_torch.core import engine, vpq
from repro_torch.core.clique import make_clique_computation
from repro_torch.data import synthetic_graphs as gen
from repro_torch.launch.serve import serve_discovery
from repro_torch.runtime.fault_tolerance import Heartbeat
from repro_torch.service import (DiscoveryRequest, DiscoveryService,
                                 ValidationError)

torch.set_num_threads(2)

COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "rebalanced", "syncs", "host_syncs")


def _assert_same_result(got, want, ctx=""):
    assert np.asarray(got.result_keys).tobytes() == \
        np.asarray(want.result_keys).tobytes(), ctx
    assert np.asarray(got.result_states).tobytes() == \
        np.asarray(want.result_states).tobytes(), ctx
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), (ctx, name)


# ------------------------------------------------------------ the manager
TREES = {
    "engine": lambda: {n: np.arange(6, dtype=np.int32).reshape(2, 3) + i
                       for i, n in enumerate(carry.STATE_ARRAYS)},
    "nested": lambda: {"b": [np.zeros(2, np.int32), (np.ones(3), None)],
                       "a": {"z": np.int64(7), "y": np.arange(4.0)},
                       "c": ()},
    "lists": lambda: [[np.arange(2)], (np.ones((2, 2)), [np.zeros(1)]),
                      {"k": np.float32(1.5)}],
    "leaf": lambda: np.arange(5),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_leaf_names_and_order_match_reference(tree):
    t = TREES[tree]()
    assert manager._leaf_names(t) == ref_manager._leaf_names(t)
    leaves = [leaf for _, leaf in manager._flatten(t)]
    want = jax.tree.leaves(t)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = manager._unflatten(t, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(t)


def _manifest_files(path):
    return sorted(os.listdir(path))


@pytest.mark.parametrize("tree", sorted(TREES))
def test_manifest_and_files_equal_the_reference_managers(tree, tmp_path):
    t = TREES[tree]()
    ref_manager.CheckpointManager(str(tmp_path / "ref")).save(
        3, t, blocking=True, capture=lambda d: {"x": 1})
    manager.CheckpointManager(str(tmp_path / "port")).save(
        3, t, blocking=True, capture=lambda d: {"x": 1})
    ref_dir = tmp_path / "ref" / "step_00000003"
    port_dir = tmp_path / "port" / "step_00000003"
    assert _manifest_files(port_dir) == _manifest_files(ref_dir)
    for name in _manifest_files(ref_dir):
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_checkpoint_restores_across_packages(writer, reader, tmp_path):
    mods = {"ref": ref_manager, "port": manager}
    t = TREES["nested"]()
    mods[writer].CheckpointManager(str(tmp_path)).save(5, t, blocking=True)
    got = mods[reader].CheckpointManager(str(tmp_path)).restore(t)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(t)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_layout_keep_last_and_tmp_sweep(tmp_path):
    d = str(tmp_path)
    mgr = manager.CheckpointManager(d, keep_last=2)
    t = {"a": torch.arange(4, dtype=torch.int32)}
    for step in (4, 8, 12):
        mgr.save(step, t, capture=lambda tmp: {"step": "x"})
    mgr.wait()
    assert mgr.committed_steps() == [8, 12]
    assert mgr.latest_step() == 12
    assert sorted(os.listdir(mgr.path(12))) == [
        "COMMITTED", "a.npy", "manifest.json"]
    m = mgr.read_manifest()
    assert m == {"step": 12, "extra": {"step": "x"}, "leaves": [
        {"name": "a", "shape": [4], "dtype": "int32"}]}
    # a crash between tmp-write and rename strands a .tmp dir: invisible,
    # then swept when a manager attaches
    os.makedirs(os.path.join(d, "step_00000016.tmp"))
    assert mgr.committed_steps() == [8, 12]
    manager.CheckpointManager(d)
    assert not [x for x in os.listdir(d) if x.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        manager.CheckpointManager(str(tmp_path / "empty")).read_manifest()


def test_save_copies_cpu_tensors_before_returning(tmp_path):
    """On the CPU ``.numpy()`` is a view: an in-place update right after
    ``save`` returns must not reach the checkpoint."""
    mgr = manager.CheckpointManager(str(tmp_path))
    pool = torch.arange(1 << 16, dtype=torch.int32)
    want = pool.clone().numpy()
    mgr.save(1, {"pool": pool})
    pool.index_copy_(0, torch.arange(1 << 16), torch.zeros(
        1 << 16, dtype=torch.int32))
    mgr.wait()
    got = mgr.restore({"pool": np.zeros(1 << 16, np.int32)})["pool"]
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------- the VPQ snapshot
def _entries(lo, hi, state_width=6):
    prio = np.arange(lo, hi, dtype=np.int32)
    states = np.repeat(prio[:, None], state_width, 1).astype(np.int32)
    return states, prio, prio.copy()


def _spill_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


PACKAGES = {"ref": ref_vpq.VirtualPriorityQueue,
            "port": vpq.VirtualPriorityQueue}
DIRECTIONS = [("port", "port"), ("ref", "port"), ("port", "ref")]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_restored_disk_runs_lifecycle(tmp_path, writer, reader):
    """tests/test_vpq_lifecycle.py's disk case: the snapshot hardlinks the
    live run files, a restore links them into a fresh spill dir, drains
    byte for byte, deletes its own links as runs exhaust, and leaves the
    checkpoint restorable again."""
    live, ckpt = tmp_path / "live", tmp_path / "ckpt"
    q = PACKAGES[writer](state_width=3, backend="disk", spill_dir=str(live),
                         buffer_size=8, run_flush_size=16)
    for round_ in range(3):
        q.maybe_push(*_entries(round_ * 16, round_ * 16 + 16, 3))
        q._flush_pending()
    q.maybe_push(*_entries(100, 105, 3))       # + an unflushed fragment
    q.pop_chunk(7)
    manifest = q.snapshot(str(ckpt))
    ckpt_files = _spill_files(str(ckpt))
    assert any(os.stat(os.path.join(str(ckpt), f)).st_nlink >= 2
               for f in ckpt_files)
    expect = []
    while len(q):
        expect.append(q.pop_chunk(11)[1])
    for round_ in range(2):
        spill = tmp_path / f"restored{round_}"
        back = PACKAGES[reader].restore(json.loads(json.dumps(manifest)),
                                        str(ckpt), spill_dir=str(spill))
        seen = len(_spill_files(str(spill)))
        assert seen
        for chunk in expect:
            np.testing.assert_array_equal(back.pop_chunk(11)[1], chunk)
            now = len(_spill_files(str(spill)))
            assert now <= seen
            seen = now
        assert len(back) == 0
        back.close()
        assert _spill_files(str(spill)) == []
        assert _spill_files(str(ckpt)) == ckpt_files


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_restored_host_queue_drains_identically(tmp_path, writer, reader):
    """tests/test_vpq_lifecycle.py's host case: the unconsumed remainder
    and the pending fragment restore; late pruning counts alike."""
    q = PACKAGES[writer](state_width=2, backend="host", run_flush_size=8)
    prio = np.random.default_rng(3).permutation(48).astype(np.int32)
    q.maybe_push(np.repeat(prio[:, None], 2, 1).astype(np.int32), prio,
                 prio.copy())
    q._flush_pending()
    q.maybe_push(*_entries(60, 63, 2))
    q.pop_chunk(5)
    manifest = q.snapshot(str(tmp_path / "ckpt"))
    back = PACKAGES[reader].restore(json.loads(json.dumps(manifest)),
                                    str(tmp_path / "ckpt"))
    assert len(back) == len(q)
    while len(q):
        for x, y in zip(q.pop_chunk(9, min_ub=20),
                        back.pop_chunk(9, min_ub=20)):
            np.testing.assert_array_equal(x, y)
    assert len(back) == 0
    assert back.total_late_pruned == q.total_late_pruned


def test_snapshot_never_flushes_pending(tmp_path):
    q = vpq.VirtualPriorityQueue(state_width=2, backend="host",
                                 run_flush_size=64)
    q.maybe_push(*_entries(0, 5, 2))
    m = q.snapshot(str(tmp_path))
    assert m["runs"] == [] and q.runs == [] and q._pending_n == 5
    assert sorted(m) == ["backend", "buffer_size", "pending", "run_flush_size",
                         "run_id", "runs", "state_width", "total_late_pruned",
                         "total_spilled"]
    assert m["pending"] == {n: f"pending_{n}.npy"
                            for n in ("states", "prio", "ub")}


# ----------------------------------------------------- engine-level parity
def _clique(graph_args):
    return make_clique_computation(gen.densifying_graph(*graph_args),
                                   device="cpu")


def _ref_clique(graph_args):
    return ref_make_clique(ref_gen.densifying_graph(*graph_args))


@pytest.mark.parametrize("spill,T", [("host", 1), ("disk", 4)])
def test_resume_intermediate_step_matches_uninterrupted(tmp_path, spill, T):
    """tests/test_checkpoint_resume.py's engine case: a checkpointed run,
    and a resume from a committed step before the last, each equal to the
    reference's uninterrupted run."""
    graph = (72, 600, 2)
    cfg = dict(k=3, batch=4, pool_capacity=48, max_steps=50_000, spill=spill,
               steps_per_sync=T)
    oracle = ref_engine.Engine(_ref_clique(graph), ref_engine.EngineConfig(
        **cfg, spill_dir=str(tmp_path / "s0"))).run()
    assert oracle.steps > 20
    comp = _clique(graph)
    ck = str(tmp_path / "ckpt")
    ckcfg = engine.EngineConfig(**cfg, spill_dir=str(tmp_path / "s2"),
                                checkpoint_every=8, checkpoint_dir=ck)
    _assert_same_result(engine.Engine(comp, ckcfg).run(), oracle,
                        "checkpointing perturbed the run")
    mgr = manager.CheckpointManager(ck)
    committed = mgr.committed_steps()
    assert len(committed) >= 2
    mid = committed[0]
    assert mid < oracle.steps
    reng = engine.Engine(comp, dataclasses.replace(
        ckcfg, spill_dir=str(tmp_path / "s3")))
    st = reng.resume(mgr, step=mid)
    assert st.steps == mid and st.pool_states.device.type == "cpu"
    while not st.done and st.steps < ckcfg.max_steps:
        reng.step(st, max_inner=ckcfg.max_steps - st.steps)
    _assert_same_result(reng.finalize(st), oracle, f"resume from {mid}")


def _save_mid_run(eng, mgr, min_step):
    """Step ``eng`` from the start until at least ``min_step`` steps are
    done and its spill queue holds runs, save there (blocking), then run
    the same state to the end; returns (saved step, finished result)."""
    st = eng.start()
    while st.steps < min_step or not len(st.vpq) or not st.vpq.runs:
        assert not st.done, "the run ended before its queue held a run"
        eng.step(st)
    eng.save_checkpoint(mgr, st, blocking=True)
    saved = st.steps
    while not st.done:
        eng.step(st)
    return saved, eng.finalize(st)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_package_resume_with_disk_queue(tmp_path, writer, T):
    """A checkpoint taken mid-run by one package's engine, with spill runs
    on disk, resumed by the other's engine, finishes byte-identical to the
    reference's uninterrupted run; so does the writer's own run on."""
    graph = (72, 600, 2)
    cfg = dict(k=3, batch=4, pool_capacity=48, max_steps=50_000,
               spill="disk", steps_per_sync=T)
    oracle = ref_engine.Engine(_ref_clique(graph), ref_engine.EngineConfig(
        **cfg, spill_dir=str(tmp_path / "s0"))).run()
    ck = str(tmp_path / "ckpt")
    engines = {
        "ref": lambda d: ref_engine.Engine(_ref_clique(graph),
                                           ref_engine.EngineConfig(
                                               **cfg, spill_dir=d)),
        "port": lambda d: engine.Engine(_clique(graph), engine.EngineConfig(
            **cfg, spill_dir=d))}
    reader = "port" if writer == "ref" else "ref"
    managers = {"ref": ref_manager, "port": manager}
    saved, finished = _save_mid_run(engines[writer](str(tmp_path / "s1")),
                                    managers[writer].CheckpointManager(ck), 9)
    _assert_same_result(finished, oracle, "the writer's own run")
    m = json.load(open(os.path.join(ck, f"step_{saved:08d}",
                                    "manifest.json")))
    assert m["extra"]["vpq"]["runs"] and \
        m["extra"]["vpq"]["runs"][0]["kind"] == "disk"
    reng = engines[reader](str(tmp_path / "s2"))
    st = reng.resume(ck)
    assert st.steps == saved and len(st.vpq) > 0
    while not st.done:
        reng.step(st)
    _assert_same_result(reng.finalize(st), oracle,
                        f"{writer}'s step {saved} resumed by {reader}")
    assert _spill_files(str(tmp_path / "s2")) == []


def test_engine_run_resume_flag_and_fresh_start(tmp_path):
    """``run(resume=True)`` on an empty dir starts fresh; after a run it
    restores the final state (done) and returns the same answer."""
    graph = (60, 400, 1)
    cfg = dict(k=3, batch=4, pool_capacity=48, max_steps=50_000)
    oracle = ref_engine.Engine(_ref_clique(graph),
                               ref_engine.EngineConfig(**cfg)).run()
    ck = str(tmp_path / "ck")
    ecfg = engine.EngineConfig(**cfg, checkpoint_every=8, checkpoint_dir=ck)
    _assert_same_result(engine.Engine(_clique(graph), ecfg).run(resume=True),
                        oracle)
    assert manager.CheckpointManager(ck).latest_step() == oracle.steps
    _assert_same_result(engine.Engine(_clique(graph), ecfg).run(resume=True),
                        oracle)


def test_carry_names_resume_for_a_state_with_spill():
    cfg = dict(k=3, batch=64, pool_capacity=96)
    graph = (500, 3000, 9, 42)
    ref = ref_engine.Engine(ref_make_clique(
        ref_gen.planted_clique_graph(*graph)), ref_engine.EngineConfig(**cfg))
    port = engine.Engine(make_clique_computation(
        gen.planted_clique_graph(*graph), device="cpu"),
        engine.EngineConfig(**cfg))
    st = ref.start()
    counters = {name: getattr(st, name) for name in carry.STATE_SCALARS}
    counters.update(vpq_len=len(st.vpq))
    assert carry.STATE_SCALARS == ref_engine._CKPT_SCALARS
    with pytest.raises(ValueError, match="Engine.resume"):
        carry.state_from_arrays(port, {n: np.asarray(getattr(st, n))
                                       for n in carry.STATE_ARRAYS}, counters)
    st.vpq.close()


# --------------------------------------------------------------- cache keys
def test_checkpoint_knobs_excluded_from_result_cache_key(tmp_path):
    r1 = DiscoveryRequest(graph="g", workload="clique", k=3)
    r2 = dataclasses.replace(r1, checkpoint_every=16,
                             checkpoint_dir=str(tmp_path / "ck"),
                             resume=True)
    assert r1.canonical_spec() == r2.canonical_spec() == RefRequest(
        graph="g", workload="clique", k=3).canonical_spec()
    svc = DiscoveryService(device="cpu")
    svc.register_graph("g", gen.densifying_graph(48, 160, seed=3))
    first = svc.query(DiscoveryRequest(graph="g", workload="clique", k=3))
    hit = svc.query(DiscoveryRequest(
        graph="g", workload="clique", k=3, checkpoint_every=8,
        checkpoint_dir=str(tmp_path / "ck2")))
    assert first.status == "ok" and hit.status == "ok", \
        (first.error, hit.error)
    assert not first.cached and hit.cached
    assert first.result_keys == hit.result_keys


def test_checkpoint_knobs_included_in_engine_reuse_key(tmp_path):
    svc = DiscoveryService(device="cpu")
    svc.register_graph("g", gen.densifying_graph(48, 160, seed=3))
    base = dict(graph="g", workload="clique", k=3, use_cache=False)
    svc.query(DiscoveryRequest(**base))
    assert len(svc._engines) == 1
    svc.query(DiscoveryRequest(**base))
    assert len(svc._engines) == 1
    svc.query(DiscoveryRequest(**base, checkpoint_every=8,
                               checkpoint_dir=str(tmp_path / "ck")))
    assert len(svc._engines) == 2
    svc.query(DiscoveryRequest(**base, checkpoint_every=8,
                               checkpoint_dir=str(tmp_path / "ck")))
    assert len(svc._engines) == 2


# ------------------------------------------------------------ service layer
def test_resumed_query_honors_budget_and_step_accounting(tmp_path):
    """The truncated, checkpointed query resumed with a larger budget stops
    at the absolute budget, equal to the reference's uninterrupted
    truncation, and adds only its own steps to ``engine_steps_total``."""
    base = dict(graph="g", workload="clique", k=3, batch=8,
                pool_capacity=64, use_cache=False)
    ref_svc = RefService()
    ref_svc.register_graph("g", ref_gen.densifying_graph(64, 256, seed=5))
    oracle = ref_svc.query(RefRequest(**base, step_budget=14))
    assert oracle.terminated == "step_budget" and oracle.stats["steps"] == 14

    g = gen.densifying_graph(64, 256, seed=5)
    ck = str(tmp_path / "ck")
    svc = DiscoveryService(device="cpu")
    svc.register_graph("g", g)
    part = svc.query(DiscoveryRequest(**base, step_budget=6,
                                      checkpoint_every=4, checkpoint_dir=ck))
    assert part.terminated == "step_budget" and part.stats["steps"] == 6
    assert manager.CheckpointManager(ck).latest_step() == 6
    assert svc.engine_steps_total == 6

    svc2 = DiscoveryService(device="cpu")
    svc2.register_graph("g", g)
    done = svc2.query(DiscoveryRequest(**base, step_budget=14,
                                       checkpoint_every=4,
                                       checkpoint_dir=ck, resume=True))
    assert done.terminated == "step_budget"
    assert done.stats["steps"] == 14
    assert svc2.engine_steps_total == 14 - 6
    assert done.result_keys == oracle.result_keys
    assert done.results == oracle.results
    assert {k: v for k, v in done.stats.items() if k != "straggler_steps"} \
        == {k: v for k, v in oracle.stats.items() if k != "straggler_steps"}


def test_resume_with_empty_checkpoint_dir_starts_fresh(tmp_path):
    svc = DiscoveryService(device="cpu")
    svc.register_graph("g", gen.densifying_graph(48, 160, seed=3))
    resp = svc.query(DiscoveryRequest(
        graph="g", workload="clique", k=3, use_cache=False,
        checkpoint_every=8, checkpoint_dir=str(tmp_path / "empty"),
        resume=True))
    assert resp.status == "ok", resp.error
    assert resp.terminated == "complete"


@pytest.mark.parametrize("fields,match", [
    (dict(workload="clique", checkpoint_every=8), "checkpoint_dir"),
    (dict(workload="clique", resume=True), "checkpoint_dir"),
    (dict(workload="pattern", checkpoint_every=8, checkpoint_dir="/tmp/x"),
     "engine workloads")])
def test_checkpoint_request_validation(fields, match):
    with pytest.raises(ValueError, match=match) as want:
        RefRequest(graph="g", k=1, **fields).validate(None)
    with pytest.raises(ValidationError, match=match) as got:
        DiscoveryRequest(graph="g", k=1, **fields).validate(None)
    assert str(got.value) == str(want.value)
    req = DiscoveryRequest.from_dict(dict(
        graph="g", workload="clique", k=1, checkpoint_every="8",
        checkpoint_dir="/tmp/x", resume="true"))
    assert req.checkpoint_every == 8 and req.resume is True


# ------------------------------------------------------------- serve loop
def test_serve_resume_finishes_truncated_request(tmp_path):
    """The serve loop's kill-and-resume: a checkpointed request
    truncated in one serve call finishes in a second one started with
    ``resume=True``, equal to the reference serve loop's uninterrupted
    answer, and the heartbeat advances."""
    ck, hb = str(tmp_path / "ck"), str(tmp_path / "hb")
    base = dict(graph="demo-social", workload="clique", k=3, batch=8,
                pool_capacity=64, use_cache=False, request_id="q1")
    out = io.StringIO()
    ref_serve(lines=[json.dumps(dict(base, step_budget=400))], out=out)
    oracle = json.loads(out.getvalue().splitlines()[0])
    assert oracle["status"] == "ok"

    out = io.StringIO()
    serve_discovery(lines=[json.dumps(dict(
        base, step_budget=8, checkpoint_every=4, checkpoint_dir=ck))],
        out=out, heartbeat=hb, device="cpu")
    first = json.loads(out.getvalue().splitlines()[0])
    assert first["terminated"] == "step_budget"
    assert not Heartbeat.is_stale(hb, timeout=120)

    out = io.StringIO()
    serve_discovery(lines=[json.dumps(dict(
        base, step_budget=400, checkpoint_every=4, checkpoint_dir=ck))],
        out=out, resume=True, heartbeat=hb, device="cpu")
    resumed = json.loads(out.getvalue().splitlines()[0])
    assert resumed["status"] == "ok", resumed.get("error")
    assert resumed["result_keys"] == oracle["result_keys"]
    assert resumed["results"] == oracle["results"]
    assert resumed["stats"]["steps"] == oracle["stats"]["steps"]
    assert not [d for d in os.listdir(ck) if d.endswith(".tmp")]
