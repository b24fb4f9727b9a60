"""Configurations as data: ``clique-densify`` reads through its generator
file exactly as it read before generators were files, and a configuration
that arrives as new files and manifest entries alone passes the suite
(all of it but the runs of the cells already there, which this suite makes
itself), its labels and request fields reaching the service and the
reference."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from nuribench import harness
from nuribench.reference import clique

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
#: seeds of the parent's readings, one past 32 bits
SEEDS = [2 ** 31 + 7, 0, 2 ** 40 + 3]

#: the readings of the commit before generators were files (its
#: ``graphs.make_graph`` and ``harness.judge(config, graph, ...)``), by
#: :func:`fingerprint`
PARENT = {
    "edges":
    "8603d2a4fac49a66efb6b02d967846f0ae661605ef060acbea3fa7cb0717836f",
    "requests":
    "7d32ce196b8e0599821d64b2e3c466424e8c4bd3d1030ecf54c8500812525463",
    "verdicts":
    "9e9f389f772c522fb21799b5993ed2d18d3311d6721aa052fad01708ba1291df",
}


def _config(name: str, **sizes) -> dict:
    """The configuration ``name`` as its file holds it, cut to its ``tiny``
    and then to ``sizes``."""
    conf = {c["name"]: c["file"] for c in MANIFEST["configs"]}[name]
    config = json.loads((ROOT / conf).read_text())
    cut = dict(config["tiny"])
    config["request"] = dict(config["request"], **cut.pop("request", {}))
    config.update(cut, **sizes)
    return config


def _responses(top):
    """Answers to judge, from the reference's own list ``top``: right;
    one clique altered; a search that expanded nothing; a cut run; an
    error; none."""
    keys = [len(c) for c in top]
    ok = dict(status="ok", terminated="complete", result_keys=keys,
              results=top, stats=dict(expanded=10 ** 9))
    altered = [list(c) for c in top]
    altered[0][0] += 1
    return [ok, dict(ok, results=altered), dict(ok, stats=dict(expanded=0)),
            dict(ok, terminated="step_budget"),
            dict(status="error", error="x"), None]


def fingerprint(make_data) -> dict:
    """sha256 of ``clique-densify``'s edges (tiny and 4,096 vertices), of
    its cells' requests (warm-up and the window's first three, untraced,
    traced and cut) and of the reference's verdicts on :func:`_responses`,
    over :data:`SEEDS`.  ``make_data(config, seed)`` is the harness's (the
    parent's ``graphs.make_graph``)."""
    h = {k: hashlib.sha256() for k in PARENT}
    for seed in SEEDS:
        for config in (_config("clique-densify"), _config(
                "clique-densify", num_vertices=4096, num_edges=40000)):
            edges = np.ascontiguousarray(make_data(config, seed)["edges"],
                                         np.int64)
            h["edges"].update(edges.tobytes())
    config = _config("clique-densify")
    for cell in ("clique-densify.t1", "clique-densify.t16"):
        _, _, traffic = harness.find_cell(MANIFEST, cell, ROOT)
        for trace, overrides in ((False, None), (True, None),
                                 (False, dict(step_budget=20))):
            warm, window = harness.make_requests(config, traffic, trace,
                                                 overrides)
            sent = [warm] + [next(window) for _ in range(3)]
            h["requests"].update(json.dumps(sent, sort_keys=True).encode())
    for seed in SEEDS[:2]:
        data = make_data(config, seed)
        top = clique.Reference(data["n"], data["edges"]).top(16)
        _, window = harness.make_requests(config, {}, False)
        sent = [harness.Sent(next(window), 0.0, None if r is None else 1.0,
                             r) for r in _responses(top)]
        checks = harness.judge(config, data, sent, lambda line: None)
        h["verdicts"].update(json.dumps(checks, sort_keys=True).encode())
    return {k: v.hexdigest() for k, v in h.items()}


def test_clique_densify_reads_as_the_parent_did():
    """The same seed gives the same edges, the same requests and the same
    verdicts as before generators were files."""
    got = fingerprint(lambda config, seed: harness.make_data(ROOT, config,
                                                             seed))
    assert got == PARENT


# ------------------------------------------- a configuration as new files
NEW = "labeled-densify"
NEW_CELL = f"{NEW}.t4"
NEW_FILES = {
    "nuribench/gen/labeled_densifying.py": '''"""The densification
protocol's graph with seeded vertex labels and vertex weights."""
import numpy as np

from nuribench.gen import graphs


def make(config, seed):
    data = graphs.densifying_graph(config["num_vertices"],
                                   config["num_edges"], seed)
    rng = np.random.default_rng([seed, 1])     # a stream after the edges'
    data["labels"] = rng.integers(0, config["num_labels"], data["n"])
    data["request"] = dict(
        weights=rng.integers(1, 100, data["n"]).tolist())
    return data
''',
    f"nuribench/configs/{NEW}.json": json.dumps(dict(
        name=NEW, source="a test's configuration", generator=
        "labeled_densifying", num_vertices=46336, num_edges=1000000,
        num_labels=8, published={}, reduced=[], reference="clique",
        request=dict(workload="clique", k=16, batch=64, pool_capacity=16384),
        tiny=dict(num_vertices=200, num_edges=1200,
                  request=dict(batch=8, pool_capacity=64)))),
    "nuribench/traffic/t4.json": json.dumps(dict(
        loop="closed", clients=1, request=dict(steps_per_sync=4),
        warmup_step_budget=8)),
}


def _with_new_configuration(manifest: dict) -> dict:
    """The manifest with the new configuration's entries."""
    m = json.loads(json.dumps(manifest))
    m["configs"].append(dict(name=NEW, source="a test's configuration",
                             file=f"nuribench/configs/{NEW}.json",
                             reduced=[], why="labels and weights"))
    m["workloads"].append(dict(name=NEW_CELL, config=NEW, traffic="t4",
                               chips=1, why="its one cell"))
    for metric in m["per_layer"]:
        if metric["name"] in ("service.host_ms", "engine.start_ms"):
            metric["workloads"].append(NEW_CELL)
    return m


def test_a_configuration_arrives_as_new_files_only(tmp_path):
    """A copy of the checkout gains a configuration by new files (a
    generator with labels and a request field, a config file with its
    ``tiny``, a traffic file) and manifest entries; the copy's suite, run
    there but for the tests of the cells already there, takes it in its
    fixture and manifest tests and passes, and its cell's runs are correct
    with the data passed on."""
    shutil.copytree(ROOT / "nuribench", tmp_path / "nuribench",
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  Path(__file__).name))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(
        _with_new_configuration(MANIFEST), indent=1))
    for rel, text in NEW_FILES.items():
        assert not (ROOT / rel).exists(), rel
        (tmp_path / rel).write_text(text)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    # the runs of the cells already there are this suite's own
    known = " or ".join(w["name"] for w in MANIFEST["workloads"])
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-p", "no:randomly", "-k", f"not ({known})",
         "nuribench/tests"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {line.split()[1] for line in out.stdout.splitlines()
              if line.startswith("PASSED ")}
    run = "nuribench/tests/test_nuribench_run.py::"
    for test in (
            f"{run}test_a_sound_run_is_correct[False-{NEW_CELL}]",
            f"{run}test_a_sound_run_is_correct[True-{NEW_CELL}]",
            f"{run}test_the_control_is_not_correct[{NEW_CELL}]",
            f"{run}test_the_data_reaches_the_service_and_the_reference"
            f"[{NEW}]",
            "nuribench/tests/test_nuribench_manifest.py::"
            f"test_every_configuration_has_tiny_and_a_generator[{NEW}]"):
        assert test in passed, test
