"""The port's sharded checkpoint (``ShardedEngine.save_checkpoint``,
``resume`` and ``run(resume=...)``) on the CPU against the reference's
``ShardedEngine``:

* tests/test_checkpoint_resume.py's 2-shard resume;
* a resume from every committed step (a save at every host read) at 2 and
  8 shards, host and disk spill, ``steps_per_sync`` 1, 2 and 4,
  ``sync_every`` 1 and 2, with and without bound traces: each resumed run
  equals the reference's uninterrupted run in the ``result_keys`` and
  ``result_states`` bytes, every counter and every ``per_shard`` list (a
  resumed run's bound traces are the uninterrupted run's from the resumed
  step on: the journals are not checkpointed);
* ``run()``'s schedule (a save at the first host read ``checkpoint_every``
  steps after the last, one at the end), ``run(resume=True)`` on an empty
  directory and on a finished run;
* the step directories, manifests and leaves byte-equal to those the
  reference writes, and the hand-over both ways: steps the reference
  wrote resumed by the port, steps the port wrote resumed by the
  reference;
* the kind and shard-count errors with the reference's messages, and
  ``Engine.resume`` refusing a sharded checkpoint as the reference's does.

The reference needs one JAX device a shard, so its side runs once, as this
file's own ``__main__`` in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
tests/test_torch_sharded.py does); the port writes the checkpoints the
reference resumes before that subprocess starts.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.clique import make_clique_computation as ref_make_clique
from repro.core.graph import GraphStore as RefGraphStore
from repro.data import synthetic_graphs as ref_gen
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import engine
from repro_torch.core.clique import make_clique_computation
from repro_torch.core.graph import GraphStore
from repro_torch.data import synthetic_graphs as gen
from repro_torch.distributed import ShardedEngine

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "rebalanced", "late_pruned", "syncs", "host_syncs")
TRACES = ("bound_used", "bound_fresh")
KEEP_ALL = 1_000_000          # keep_last for the managers that save each step
# tests/test_checkpoint_resume.py's graph and shapes
DENSE = dict(k=3, batch=4, pool_capacity=48, max_steps=50_000)
# tests/test_distributed_engine.py's skewed case (spill, refill, rebalance)
SKEWED = dict(k=3, batch=8, pool_capacity=64, max_steps=50_000)

CASES = {
    "dense-x2-host-T1-K1": dict(graph="dense", shards=2, spill="host", T=1,
                                K=1),
    "dense-x2-disk-T2-K2": dict(graph="dense", shards=2, spill="disk", T=2,
                                K=2),
    "skewed-x2-disk-T4-K1": dict(graph="skewed", shards=2, spill="disk",
                                 T=4, K=1),
    "skewed-x2-host-T4-K2-trace": dict(graph="skewed", shards=2,
                                       spill="host", T=4, K=2, trace=True),
    "dense-x8-disk-T1-K1": dict(graph="dense", shards=8, spill="disk", T=1,
                                K=1),
    "skewed-x8-host-T2-K2": dict(graph="skewed", shards=8, spill="host",
                                 T=2, K=2),
    "skewed-x8-disk-T4-K2": dict(graph="skewed", shards=8, spill="disk",
                                 T=4, K=2),
}
# written by each package, resumed by the other; their manifests compared
HANDOVER = ("dense-x2-disk-T2-K2", "skewed-x8-disk-T4-K2")
RUN_EVERY = 4                 # checkpoint_every of the run() cases


def _graph(case: dict, ref: bool):
    mod, store = (ref_gen, RefGraphStore) if ref else (gen, GraphStore)
    if case["graph"] == "dense":
        return mod.densifying_graph(72, 600, seed=4)
    g = mod.densifying_graph(96, 500, seed=3)
    members = np.arange(0, 24, 2)          # a 12-clique on the even 0-22
    extra = [(int(u), int(v)) for i, u in enumerate(members)
             for v in members[i + 1:]]
    return store.from_edges(
        96, np.concatenate([g.edge_array, np.array(extra, np.int64)]))


def _computation(case: dict, ref: bool):
    g = _graph(case, ref)
    return ref_make_clique(g) if ref else make_clique_computation(
        g, device="cpu")


def _config(make, case: dict, spill_dir, **fields):
    """``make``'s EngineConfig for ``case``; ``spill_dir`` is used by the
    disk cases only."""
    base = DENSE if case["graph"] == "dense" else SKEWED
    return make(**base, shards=case["shards"], spill=case["spill"],
                spill_dir=str(spill_dir) if case["spill"] == "disk" else None,
                steps_per_sync=case["T"], sync_every=case["K"],
                record_bound_trace=case.get("trace", False), **fields)


def _record(res) -> dict:
    """A result as JSON values: keys, states, counters, per_shard."""
    rec = {name: int(getattr(res, name)) for name in COUNTERS}
    rec.update(result_keys=np.asarray(res.result_keys).tolist(),
               result_states=np.asarray(res.result_states).tolist(),
               per_shard=json.loads(json.dumps(res.per_shard)))
    return rec


def _finish(eng, st) -> dict:
    while not st.done and st.steps < eng.cfg.max_steps:
        eng.step(st, max_inner=eng.cfg.max_steps - st.steps)
    return _record(eng.finalize(st))


def _save_every_step(eng, mgr) -> dict:
    """Run ``eng`` from the start with a save after every host read."""
    st = eng.start()
    while not st.done and st.steps < eng.cfg.max_steps:
        eng.step(st, max_inner=eng.cfg.max_steps - st.steps)
        eng.save_checkpoint(mgr, st)
    mgr.wait()
    return _record(eng.finalize(st))


def _spread(steps: list) -> list:
    """Three committed steps spread over the run (the reference's resumes
    cost a second or two each on the CPU)."""
    return sorted({steps[len(steps) // 4], steps[len(steps) // 2],
                   steps[3 * len(steps) // 4]})


def _reference_child(out: pathlib.Path) -> None:
    """The reference's side (this file as a script, 8 forced host
    devices): every case's uninterrupted run, the hand-over cases' saves
    at every host read and ``run()`` with checkpoints, its resumes of the
    port's saved steps, and its error messages; one JSON file."""
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.distributed import ShardedEngine as RefShardedEngine
    rec = {"oracle": {}, "resumed": {}, "errors": {}}
    for name, case in CASES.items():
        eng = RefShardedEngine(_computation(case, ref=True), _config(
            ref_engine.EngineConfig, case, out / "spill" / "oracle" / name))
        rec["oracle"][name] = _record(eng.run())
    for name in HANDOVER:
        case = CASES[name]
        comp = _computation(case, ref=True)
        _save_every_step(RefShardedEngine(comp, _config(
            ref_engine.EngineConfig, case, out / "spill" / "ref" / name)),
            RefManager(str(out / "ref_ckpt" / name), keep_last=KEEP_ALL))
        RefShardedEngine(comp, _config(
            ref_engine.EngineConfig, case, out / "spill" / "ref_run" / name,
            checkpoint_every=RUN_EVERY,
            checkpoint_dir=str(out / "ref_run" / name))).run()
        src = RefManager(str(out / "port_ckpt" / name))
        for step in _spread(src.committed_steps()):
            eng = RefShardedEngine(comp, _config(
                ref_engine.EngineConfig, case,
                out / "spill" / "ref_resume" / f"{name}@{step}"))
            rec["resumed"][f"{name}@{step}"] = _finish(
                eng, eng.resume(src, step=step))
    x2, x8 = (CASES[name] for name in HANDOVER)
    eng = RefShardedEngine(_computation(x2, ref=True), _config(
        ref_engine.EngineConfig, x2, out / "spill" / "errors"))
    for what, src in (("kind", out / "engine_ckpt"),
                      ("shards", out / "ref_ckpt" / HANDOVER[1])):
        try:
            eng.resume(str(src))
        except ValueError as e:
            rec["errors"][what] = str(e)
    assert x8["shards"] == 8 and len(rec["errors"]) == 2
    (out / "reference.json").write_text(json.dumps(rec))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The port's saves that the reference resumes, then the reference's
    side; returns (its record, the shared directory)."""
    out = tmp_path_factory.mktemp("sharded_ckpt")
    for name in HANDOVER:
        case = CASES[name]
        _save_every_step(
            ShardedEngine(_computation(case, ref=False), _config(
                engine.EngineConfig, case, out / "spill" / "port" / name)),
            CheckpointManager(str(out / "port_ckpt" / name),
                              keep_last=KEEP_ALL))
    engine.Engine(_computation(CASES[HANDOVER[0]], ref=False),
                  engine.EngineConfig(**DENSE, checkpoint_every=8,
                                      checkpoint_dir=str(
                                          out / "engine_ckpt"))).run()
    env = dict(os.environ,            # a stripped env can stall JAX start-up
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((out / "reference.json").read_text()), out


def _assert_resumed(got: dict, want: dict, step: int, ctx: str):
    """``got``, resumed at ``step``, equals the uninterrupted ``want``;
    its bound traces are ``want``'s from ``step`` on."""
    got, want = dict(got), dict(want)
    got_shard, want_shard = dict(got.pop("per_shard")), \
        dict(want.pop("per_shard"))
    for name in TRACES:
        if name in want_shard:
            assert got_shard.pop(name) == [row[step:] for row in
                                           want_shard.pop(name)], (ctx, name)
    assert got == want, ctx
    assert got_shard == want_shard, ctx


def _spill_files(root: pathlib.Path) -> list:
    return [f for _, _, fs in os.walk(root) for f in fs]


# --------------------------------------------------- the reference's case
def test_sharded_resume_matches_uninterrupted(reference, tmp_path):
    """tests/test_checkpoint_resume.py's 2-shard case: a checkpointed run,
    and a resume from its oldest retained step, each equal to the
    reference's uninterrupted run (the queues and pool occupancies
    round-trip)."""
    rec, _ = reference
    case = CASES["dense-x2-disk-T2-K2"]
    want = rec["oracle"]["dense-x2-disk-T2-K2"]
    comp = _computation(case, ref=False)
    ck = str(tmp_path / "ckpt")
    ckcfg = _config(engine.EngineConfig, case, tmp_path / "s2",
                    checkpoint_every=8, checkpoint_dir=ck)
    assert _record(ShardedEngine(comp, ckcfg).run()) == want
    mgr = CheckpointManager(ck)
    mid = mgr.committed_steps()[0]
    assert mid < want["steps"]
    reng = ShardedEngine(comp, dataclasses.replace(
        ckcfg, spill_dir=str(tmp_path / "s3")))
    st = reng.resume(mgr, step=mid)
    assert st.steps == mid and st.pool_states.device.type == "cpu"
    assert _finish(reng, st) == want
    assert _spill_files(tmp_path / "s3") == []


# ------------------------------------------------ every committed step
@pytest.mark.parametrize("name", list(CASES))
def test_resume_from_every_step_equals_reference(reference, tmp_path, name):
    """A save after every host read; the run on from each saved step, by a
    fresh engine with its own spill directory, equals the reference's
    uninterrupted run, and so does the saving run itself."""
    rec, _ = reference
    case, want = CASES[name], rec["oracle"][name]
    comp = _computation(case, ref=False)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last=KEEP_ALL)
    assert _save_every_step(ShardedEngine(comp, _config(
        engine.EngineConfig, case, tmp_path / "spill")), mgr) == want
    steps = mgr.committed_steps()
    assert steps[-1] == want["steps"] and len(steps) == want["host_syncs"]
    for step in steps:
        root = tmp_path / f"resume{step}"
        eng = ShardedEngine(comp, _config(engine.EngineConfig, case, root))
        st = eng.resume(mgr, step=step)
        assert st.steps == step and len(st.vpqs) == case["shards"]
        _assert_resumed(_finish(eng, st), want, step, f"{name} @ {step}")
        if case["spill"] == "disk":    # every shard's run files gone
            assert _spill_files(root) == [], step
    if name == "skewed-x8-disk-T4-K2":
        assert want["rebalanced"] > 0 and want["late_pruned"] > 0


def test_disk_resume_without_spill_dir_uses_fresh_temp_dirs(reference,
                                                             tmp_path):
    """``spill_dir`` None: each shard's queue gets its own temporary
    directory, removed when the queue closes."""
    rec, out = reference
    name = HANDOVER[1]
    case, want = CASES[name], rec["oracle"][name]
    mgr = CheckpointManager(str(out / "port_ckpt" / name))
    step = _spread(mgr.committed_steps())[0]
    eng = ShardedEngine(_computation(case, ref=False), dataclasses.replace(
        _config(engine.EngineConfig, case, None), spill_dir=None))
    st = eng.resume(mgr, step=step)
    dirs = [v.spill_dir for v in st.vpqs]
    assert len(set(dirs)) == case["shards"]
    assert any(v.runs for v in st.vpqs)
    _assert_resumed(_finish(eng, st), want, step, name)
    assert not any(os.path.exists(d) for d in dirs)


# ------------------------------------------------------------------ run()
@pytest.mark.parametrize("name", list(CASES))
def test_checkpointed_run_equals_reference(reference, tmp_path, name):
    """``run()`` with ``checkpoint_every``: the reference's answer, the
    last save at the final step; ``run(resume=True)`` then restores the
    finished state and answers the same; on an empty directory it starts
    fresh."""
    rec, _ = reference
    case, want = CASES[name], rec["oracle"][name]
    comp = _computation(case, ref=False)
    ck = tmp_path / "ckpt"
    cfg = _config(engine.EngineConfig, case, tmp_path / "s1",
                  checkpoint_every=RUN_EVERY, checkpoint_dir=str(ck))
    assert _record(ShardedEngine(comp, cfg).run()) == want
    steps = CheckpointManager(str(ck)).committed_steps()
    assert steps[-1] == want["steps"] and len(steps) <= 3
    again = ShardedEngine(comp, dataclasses.replace(
        cfg, spill_dir=str(tmp_path / "s2"))).run(resume=True)
    # a finished run resumed takes no step: its traces are empty
    _assert_resumed(_record(again), want, want["steps"], name)
    fresh = ShardedEngine(comp, dataclasses.replace(
        cfg, spill_dir=str(tmp_path / "s3"),
        checkpoint_dir=str(tmp_path / "empty"))).run(resume=True)
    assert _record(fresh) == want


@pytest.mark.parametrize("name", HANDOVER)
def test_run_saves_the_reference_steps(reference, tmp_path, name):
    """``run()``'s save schedule under macro-steps is the reference's: the
    same committed steps, with equal manifests and leaves."""
    _, out = reference
    case = CASES[name]
    ck = tmp_path / "ckpt"
    ShardedEngine(_computation(case, ref=False), _config(
        engine.EngineConfig, case, tmp_path / "s1",
        checkpoint_every=RUN_EVERY, checkpoint_dir=str(ck))).run()
    ref_dir = out / "ref_run" / name
    assert sorted(os.listdir(ck)) == sorted(os.listdir(ref_dir))
    for step_dir in os.listdir(ref_dir):
        assert _tree(ck / step_dir) == _tree(ref_dir / step_dir), step_dir


# ------------------------------------------------------ across packages
def _tree(root: pathlib.Path) -> dict:
    """Relative path -> bytes of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("name", HANDOVER)
def test_step_directories_equal_the_reference(reference, name):
    """A save at every host read by each package: the same step
    directories, each with byte-equal files (manifest, leaves under the
    reference's names, the COMMITTED marker, every shard's queue under
    ``vpq/shard{i}``)."""
    _, out = reference
    port, ref = out / "port_ckpt" / name, out / "ref_ckpt" / name
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for step_dir in os.listdir(ref):
        got, want = _tree(port / step_dir), _tree(ref / step_dir)
        assert got == want, step_dir
    manifest = json.loads(want["manifest.json"])
    assert [leaf["name"] for leaf in manifest["leaves"]] == [
        "pool_prio", "pool_states", "pool_ub", "result_keys",
        "result_states"]
    extra = manifest["extra"]
    assert extra["kind"] == "sharded_engine"
    assert extra["shards"] == CASES[name]["shards"] == len(extra["vpqs"])
    assert sorted(extra["scalars"]) == sorted(
        ("steps", "candidates", "expanded", "pruned", "refilled",
         "rebalanced", "syncs", "host_syncs", "threshold", "done",
         "pool_occupancy"))


@pytest.mark.parametrize("name", HANDOVER)
def test_port_resumes_reference_steps(reference, tmp_path, name):
    """Every step the reference saved, resumed by the port, finishes with
    the reference's uninterrupted answer."""
    rec, out = reference
    case, want = CASES[name], rec["oracle"][name]
    comp = _computation(case, ref=False)
    mgr = CheckpointManager(str(out / "ref_ckpt" / name))
    steps = mgr.committed_steps()
    assert len(steps) == want["host_syncs"]
    for step in steps:
        eng = ShardedEngine(comp, _config(engine.EngineConfig, case,
                                          tmp_path / f"s{step}"))
        _assert_resumed(_finish(eng, eng.resume(mgr, step=step)), want,
                        step, f"{name} @ {step}")


@pytest.mark.parametrize("name", HANDOVER)
def test_reference_resumes_port_steps(reference, name):
    """Steps the port saved (a quarter, half and three quarters through),
    resumed by the reference, finish with its uninterrupted answer."""
    rec, out = reference
    steps = _spread(CheckpointManager(
        str(out / "port_ckpt" / name)).committed_steps())
    for step in steps:
        _assert_resumed(rec["resumed"][f"{name}@{step}"], rec["oracle"][name],
                        step, f"{name} @ {step}")
    assert len(rec["resumed"]) == sum(
        len(_spread(CheckpointManager(str(out / "port_ckpt" / n))
                    .committed_steps())) for n in HANDOVER)


# ----------------------------------------------------------------- errors
@pytest.mark.parametrize("what", ["kind", "shards"])
def test_resume_errors_are_the_references(reference, what):
    """An engine checkpoint, and one written at 8 shards, given to a
    2-shard engine: ``ValueError`` with the reference's message."""
    rec, out = reference
    case = CASES[HANDOVER[0]]
    src = (out / "engine_ckpt" if what == "kind"
           else out / "ref_ckpt" / HANDOVER[1])
    eng = ShardedEngine(_computation(case, ref=False), _config(
        engine.EngineConfig, case, out / "spill" / "port_errors"))
    with pytest.raises(ValueError) as got:
        eng.resume(str(src))
    assert str(got.value) == rec["errors"][what]


def test_engine_refuses_a_sharded_checkpoint(reference):
    """``Engine.resume`` on a sharded checkpoint raises the reference
    Engine's error."""
    _, out = reference
    src = str(out / "port_ckpt" / HANDOVER[0])
    with pytest.raises(ValueError) as want:
        ref_engine.Engine(ref_make_clique(ref_gen.densifying_graph(
            72, 600, seed=4)), ref_engine.EngineConfig(**DENSE)).resume(src)
    with pytest.raises(ValueError) as got:
        engine.Engine(_computation(CASES[HANDOVER[0]], ref=False),
                      engine.EngineConfig(**DENSE)).resume(src)
    assert str(got.value) == str(want.value)
    assert "is not an engine checkpoint" in str(got.value)


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
