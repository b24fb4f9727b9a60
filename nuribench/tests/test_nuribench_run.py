"""The harness's control flow end to end, on the CPU at tiny sizes with the
program's plain kernel versions: no measurement (every number these runs
print is the CPU's).  A sound run comes out correct; the control (the
program's own ``step_budget`` cut) and each fault the cells can have,
planted underneath the timed path, come out not correct."""
import dataclasses
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nuribench import harness
from repro_torch.core import clique as clique_mod
from repro_torch.core import vpq as vpq_mod
from repro_torch.core.engine import Engine

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 7
#: every cell of the manifest
CELLS = [w["name"] for w in MANIFEST["workloads"]]
#: the two cells that spill and refill at their tiny sizes (about 270
#: triangles, a pool of 64, a batch of 8), where the stuck step and the
#: dropped spill queue are planted; the other faults go into every cell
FAULT_CELLS = ["clique-densify.t1", "clique-densify.t16"]


def cut_to_tiny(root: Path, manifest: dict) -> None:
    """Lay each configuration's ``tiny`` over its file in the checkout
    ``root``: its size keys over the file's, its ``request`` over the
    file's ``request``."""
    for c in manifest["configs"]:
        path = root / c["file"]
        config = json.loads(path.read_text())
        tiny = dict(config["tiny"])
        config["request"] = dict(config["request"], **tiny.pop("request", {}))
        config.update(tiny)
        path.write_text(json.dumps(config))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the checkout (``BENCHMARK.json`` and ``nuribench/``) whose
    configurations are cut to their ``tiny``: its root and its manifest."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "nuribench", root / "nuribench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cut_to_tiny(root, manifest)
    return root, manifest


def run(tiny, cell, trace=False, **kw):
    root, manifest = tiny
    kw.setdefault("seconds", 0.5)
    return harness.run_cell(root, manifest, cell, SEED, trace=trace,
                            device="cpu", log=lambda line: None, **kw)


def failing(result):
    return sorted(k for k, c in result["checks"].items()
                  if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny, cell, trace):
    r = run(tiny, cell, trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"unanswered", "incomplete", "wrong_keys",
                                "wrong_results", "unexpanded"}
    want = {m["name"] for m in harness.metrics_of(tiny[1], cell, trace)}
    got = set(r["metrics"])
    # no device on the CPU: the device trace's readers find nothing
    assert got == {n for n in want if not n.startswith(
        ("passes.", "kernel.", "device."))}
    assert r["device"]["platform"] == "cpu" and "breakdown" not in r


#: each configuration of the manifest with its first cell
FIRST_CELLS = {w["config"]: w["name"]
               for w in reversed(MANIFEST["workloads"])}


@pytest.mark.parametrize("config", sorted(FIRST_CELLS))
def test_the_data_reaches_the_service_and_the_reference(tiny, monkeypatch,
                                                        config):
    """Every part of the generator's data is passed on: the registered
    graph holds its labels (none where it has none), every request holds
    its request fields, and the reference is built from its edges and
    labels."""
    from repro_torch.service import DiscoveryService
    root, manifest = tiny
    cell = FIRST_CELLS[config]
    conf = json.loads((root / {c["name"]: c["file"] for c in
                               manifest["configs"]}[config]).read_text())
    module = importlib.import_module(f"nuribench.reference."
                                     f"{conf['reference']}")
    seen = {}
    register, judge = DiscoveryService.register_graph, harness.judge

    def spy_register(self, name, store):
        seen["store"] = store
        return register(self, name, store)

    def spy_judge(config, data, sent, log):
        seen["data"], seen["sent"] = data, sent
        return judge(config, data, sent, log)

    class SpyReference(module.Reference):
        def __init__(self, n, edges, labels=None):
            seen["ref"] = (n, edges, labels)
            super().__init__(n, edges, labels=labels)

    monkeypatch.setattr(DiscoveryService, "register_graph", spy_register)
    monkeypatch.setattr(harness, "judge", spy_judge)
    monkeypatch.setattr(module, "Reference", SpyReference)
    r = run(tiny, cell)
    assert r["correct"] and r["attempted"] >= 1
    data = seen["data"]
    labels = data.get("labels")
    if labels is None:
        assert seen["store"].labels is None
    else:
        assert np.array_equal(seen["store"].labels, labels)
    assert seen["store"].n == data["n"]
    n, edges, ref_labels = seen["ref"]
    assert n == data["n"] and edges is data["edges"]
    assert ref_labels is labels
    assert seen["sent"] and all(
        s.fields[k] == v for s in seen["sent"]
        for k, v in data.get("request", {}).items())


def test_the_same_seed_sends_the_same_requests(tiny):
    root, manifest = tiny
    cell, config, traffic = harness.find_cell(manifest, "clique-densify.t16",
                                              root)
    one = harness.make_requests(config, traffic, False)
    two = harness.make_requests(config, traffic, False)
    assert one[0] == two[0] and one[0]["step_budget"] == 32
    firsts = [next(one[1]) for _ in range(3)]
    assert firsts == [next(two[1]) for _ in range(3)]
    assert all(f["use_cache"] is False and f["steps_per_sync"] == 16 and
               "step_budget" not in f for f in firsts)
    cut = harness.make_requests(config, traffic, True,
                                dict(step_budget=5))[1]
    assert next(cut)["step_budget"] == 5 and next(cut)["observe"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    """The control: the program's own path that breaks the exactness
    guarantee, a run cut by ``step_budget``."""
    r = run(tiny, cell, overrides=dict(step_budget=20))
    assert not r["correct"]
    assert {"incomplete", "unexpanded"} <= set(failing(r))


def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    """From the window's first step on (the warm-up runs its 2), a step
    returns the state as it came: the request never answers."""
    step, calls = Engine.step, []

    def stuck(self, st, max_inner=None):
        calls.append(1)
        return step(self, st, max_inner) if len(calls) <= 2 else st

    monkeypatch.setattr(Engine, "step", stuck)
    r = run(tiny, FAULT_CELLS[0], grace=1.0)
    assert not r["correct"] and failing(r) == ["unanswered"]


def _half(make, lower: bool):
    """``make`` with a computation that leaves half of each dequeued batch
    unexpanded: the lower-priority half, or the upper one."""
    def made(*args, **kwargs):
        comp = make(*args, **kwargs)

        def score(states):
            prio, ub = comp.score_children(states)
            b = states.shape[0]
            rows = torch.arange(b)
            keep = rows < b // 2 if lower else rows >= b // 2
            neg = torch.iinfo(torch.int32).min
            return (torch.where(keep[:, None], prio, neg),
                    torch.where(keep[:, None], ub, neg))
        return dataclasses.replace(comp, score_children=score)
    return made


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("lower", [True, False])
def test_half_of_each_batch_left_unexpanded(tiny, monkeypatch, cell, lower):
    """Losing either half of each batch loses some of the best
    cliques."""
    monkeypatch.setattr(clique_mod, "make_clique_computation",
                        _half(clique_mod.make_clique_computation, lower))
    r = run(tiny, cell)
    assert not r["correct"] and "wrong_results" in failing(r)


@pytest.mark.parametrize("cell", FAULT_CELLS)
def test_every_spilled_entry_dropped(tiny, monkeypatch, cell):
    """The spill queue keeps nothing: no entry comes back by refill."""
    monkeypatch.setattr(vpq_mod.VirtualPriorityQueue, "maybe_push",
                        lambda self, *args, **kwargs: None)
    r = run(tiny, cell)
    assert not r["correct"] and "unexpanded" in failing(r)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(tiny, cell, monkeypatch):
    finalize = Engine.finalize

    def altered(self, st):
        res = finalize(self, st)
        res.result_states = np.array(res.result_states)
        res.result_states[0, 0] ^= 1      # a vertex in, or a vertex moved
        return res

    monkeypatch.setattr(Engine, "finalize", altered)
    r = run(tiny, cell)
    assert not r["correct"] and "wrong_results" in failing(r)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert harness.forbidden_modules() == [] or \
        "jax" in sys.modules    # this test process may hold the JAX tests'
    import types
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.forbidden_modules()
    assert "repro_torchlike" not in harness.forbidden_modules()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_and_its_control_on_the_card(tiny, card, cell):
    root, manifest = tiny
    sound = harness.run_cell(root, manifest, cell, SEED, 0.5, False,
                             log=lambda line: None)
    assert sound["correct"] and sound["device"]["platform"] == "gpu"
    control = harness.run_cell(root, manifest, cell, SEED, 0.5, False,
                               overrides=dict(step_budget=20),
                               log=lambda line: None)
    assert not control["correct"]
    traced = harness.run_cell(root, manifest, cell, SEED, 0.5, True,
                              log=lambda line: None)
    assert traced["correct"] and traced["device"]["busy_s"] > 0
    assert {"passes.device_ms", "device.idle_share", "engine.enqueue_ms"} \
        <= set(traced["metrics"])


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_run_refuses_without_a_card(no_card):
    out = subprocess.run(
        [sys.executable, str(ROOT / "nuribench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
