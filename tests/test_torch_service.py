"""The port's discovery service (``repro_torch.service``) and serve loop
(``repro_torch.launch.serve``) on the CPU against the reference's.

* every case of tests/test_service.py on the port, with each answer held
  to the reference's (validation messages, cache keys, scheduled results
  against the reference's ``Engine.run()``);
* ``make_cache_key`` equal to the reference's for equal requests;
* one JSONL request file through both ``serve_discovery`` loops: equal
  response lines, the wall-clock fields aside (``latency_s`` and the
  straggler count, which times steps);
* ``shards > 1`` requests (the sharded engine at T = 1, in macro-steps
  with stale bounds, truncated, iso and weighted clique) through both
  loops with equal response lines, and a checkpointed 2-shard request cut
  by its budget and resumed through the service to the uninterrupted
  answer.  The reference's sharded engine needs one JAX device a shard,
  so its loop runs in one subprocess of this file under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``;
* the port's differences: the weighted-clique ``use_pallas`` rejection
  (the reference's) and ``interpret`` not null, each answered as an error
  response; ``shards: 2`` answered on one device, where a one-device
  reference answers an error; and ``device=None`` raising without a card.
"""
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.clique import make_clique_computation as ref_make_clique
from repro.core.engine import Engine as RefEngine
from repro.core.engine import EngineConfig as RefEngineConfig
from repro.data import synthetic_graphs as ref_gen
from repro.launch.serve import serve_discovery as ref_serve
from repro.service import DiscoveryRequest as RefRequest
from repro.service import DiscoveryService as RefService
from repro.service import GraphRegistry as RefRegistry
from repro.service import make_cache_key as ref_make_cache_key
from repro_torch.data import synthetic_graphs as gen
from repro_torch.launch.serve import serve_discovery
from repro_torch.service import (DiscoveryRequest, DiscoveryService,
                                 GraphRegistry, ResultCache, ValidationError,
                                 make_cache_key)

torch.set_num_threads(2)

NEG_KEY = np.iinfo(np.int32).min


@pytest.fixture(scope="module")
def social():
    return gen.planted_clique_graph(n=80, m=300, clique_size=6, seed=1)


@pytest.fixture(scope="module")
def cite():
    return gen.labeled_graph(40, 120, 3, seed=2)


def make_service(social, cite, **kw):
    svc = DiscoveryService(device="cpu", **kw)
    svc.register_graph("social", social)
    svc.register_graph("cite", cite)
    return svc


def make_ref_service():
    svc = RefService()
    svc.register_graph("social", ref_gen.planted_clique_graph(
        n=80, m=300, clique_size=6, seed=1))
    svc.register_graph("cite", ref_gen.labeled_graph(40, 120, 3, seed=2))
    return svc


def _same_error(port_svc, fields):
    """The port's service answers ``fields`` with the reference's error."""
    got = port_svc.query(DiscoveryRequest(**fields))
    want = make_ref_service().query(RefRequest(**fields))
    assert got.status == want.status == "error"
    assert got.error == want.error
    return got


# ------------------------------------------------------------- validation
def test_rejects_unknown_workload(social, cite):
    resp = _same_error(make_service(social, cite),
                       dict(graph="social", workload="motif"))
    assert "workload" in resp.error


@pytest.mark.parametrize("fields", [
    dict(k=0), dict(step_budget=0), dict(candidate_budget=-5)])
def test_rejects_bad_k_and_budgets(social, cite, fields):
    _same_error(make_service(social, cite),
                dict(graph="social", workload="clique", **fields))


@pytest.mark.parametrize("fields", [
    dict(graph="nope", workload="clique"),
    dict(graph="social", workload="weighted-clique"),
    dict(graph="social", workload="weighted-clique", weights=(1, 2, 3)),
    dict(graph="social", workload="iso", q_edges=((0, 1),), q_labels=(0, 1)),
    dict(graph="cite", workload="pattern")])
def test_rejects_unknown_graph_and_missing_params(social, cite, fields):
    _same_error(make_service(social, cite), fields)


def test_from_dict_rejects_unknown_fields():
    with pytest.raises(ValidationError, match="frobnicate"):
        DiscoveryRequest.from_dict(
            dict(graph="g", workload="clique", frobnicate=1))


def test_request_fields_mirror_reference():
    names = [f.name for f in dataclasses.fields(DiscoveryRequest)]
    assert names == [f.name for f in dataclasses.fields(RefRequest)]


# --------------------------------------------------------- cache key/LRU/TTL
def test_cache_key_deterministic(social):
    r1 = DiscoveryRequest(graph="social", workload="clique", k=3)
    r2 = DiscoveryRequest(graph="social", workload="clique", k=3,
                          request_id="different-id", use_cache=False)
    k1 = make_cache_key(social.fingerprint, r1.canonical_spec())
    k2 = make_cache_key(social.fingerprint, r2.canonical_spec())
    assert k1 == k2
    r3 = DiscoveryRequest(graph="social", workload="clique", k=4)
    assert make_cache_key(social.fingerprint, r3.canonical_spec()) != k1


def test_cache_key_covers_graph_and_query_graph(social, cite):
    req = DiscoveryRequest(graph="g", workload="clique", k=2)
    assert make_cache_key(social.fingerprint, req.canonical_spec()) != \
        make_cache_key(cite.fingerprint, req.canonical_spec())
    a = DiscoveryRequest(graph="g", workload="iso",
                         q_edges=((0, 1), (1, 2)), q_labels=(0, 1, 0))
    b = DiscoveryRequest(graph="g", workload="iso",
                         q_edges=((2, 1), (1, 0)), q_labels=(0, 1, 0))
    assert a.canonical_spec() == b.canonical_spec()


KEYED_REQUESTS = [
    dict(graph="social", workload="clique", k=3),
    dict(graph="social", workload="clique", k=3, use_pallas=True,
         steps_per_sync=16, checkpoint_every=8, checkpoint_dir="/x",
         observe=True, request_id="r", use_cache=False),
    dict(graph="social", workload="weighted-clique", k=2,
         weights=tuple(range(1, 81)), candidate_budget=50),
    dict(graph="cite", workload="iso", k=3, q_edges=((1, 0), (2, 1)),
         q_labels=(0, 1, 2), induced=False, max_hops=3),
    dict(graph="cite", workload="iso", k=3, q_edges=((0, 1),),
         q_labels=(1, 2), label_predicate={"vertex_any_of": [2, 1, 1],
                                           "q_any_of": [[1], [2, 0]]},
         label_filter="post"),
    dict(graph="cite", workload="pattern", k=2, m_edges=3, shards=1,
         label_predicate={}),
]


@pytest.mark.parametrize("i", range(len(KEYED_REQUESTS)))
def test_make_cache_key_equals_reference(social, cite, i):
    fields = KEYED_REQUESTS[i]
    graph = {"social": social, "cite": cite}[fields["graph"]]
    ref_graph = {"social": ref_gen.planted_clique_graph(
        n=80, m=300, clique_size=6, seed=1),
        "cite": ref_gen.labeled_graph(40, 120, 3, seed=2)}[fields["graph"]]
    assert graph.fingerprint == ref_graph.fingerprint
    got = DiscoveryRequest(**fields)
    want = RefRequest(**fields)
    assert got.canonical_spec() == want.canonical_spec()
    assert make_cache_key(graph.fingerprint, got.canonical_spec()) == \
        ref_make_cache_key(ref_graph.fingerprint, want.canonical_spec())


def test_lru_eviction():
    cache = ResultCache(capacity=2, ttl_s=1e9)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1
    cache.put("c", 3)
    assert cache.get("b") is None
    assert cache.get("a") == 1
    assert cache.get("c") == 3
    assert cache.evictions == 1


def test_ttl_expiry():
    now = [0.0]
    cache = ResultCache(capacity=8, ttl_s=10.0, clock=lambda: now[0])
    cache.put("a", 1)
    now[0] = 5.0
    assert cache.get("a") == 1
    now[0] = 10.1
    assert cache.get("a") is None
    assert cache.expirations == 1


# ------------------------------------------------------- scheduled execution
def test_interleaved_matches_sequential(social):
    """Two concurrent clique queries give the reference's dedicated
    ``Engine.run()`` answers, states and counters."""
    svc = DiscoveryService(device="cpu")
    svc.register_graph("social", social)
    resps = svc.serve([
        DiscoveryRequest(graph="social", workload="clique", k=3,
                         use_cache=False),
        DiscoveryRequest(graph="social", workload="clique", k=1, batch=32,
                         use_cache=False)])
    comp = ref_make_clique(ref_gen.planted_clique_graph(
        n=80, m=300, clique_size=6, seed=1))
    for resp, cfg in zip(resps, (dict(k=3), dict(k=1, batch=32))):
        ref = RefEngine(comp, RefEngineConfig(**cfg)).run()
        assert resp.result_keys == [int(x) for x in ref.result_keys]
        assert resp.results == [comp.describe(row) for key, row in zip(
            ref.result_keys, ref.result_states) if key != NEG_KEY]
        for name in ("steps", "candidates", "expanded", "pruned",
                     "spilled", "refilled", "late_pruned", "host_syncs"):
            assert resp.stats[name] == getattr(ref, name), name
        assert resp.terminated == "complete"


def test_cache_hit_runs_zero_engine_steps(social, cite):
    svc = make_service(social, cite)
    req = DiscoveryRequest(graph="social", workload="clique", k=2)
    first = svc.query(req)
    assert not first.cached and svc.engine_steps_total > 0
    steps_before = svc.engine_steps_total
    second = svc.query(req)
    assert second.cached
    assert svc.engine_steps_total == steps_before
    assert second.result_keys == first.result_keys
    assert second.results == first.results


def test_candidate_budget_terminates_early(social):
    svc = DiscoveryService(device="cpu")
    svc.register_graph("social", social)
    fields = dict(graph="social", workload="clique", k=1,
                  candidate_budget=100, use_cache=False)
    resp = svc.query(DiscoveryRequest(**fields))
    want = make_ref_service().query(RefRequest(**fields))
    assert resp.status == "ok"
    assert resp.terminated == want.terminated == "candidate_budget"
    assert resp.result_keys == want.result_keys
    assert resp.stats["candidates"] == want.stats["candidates"]


def test_mixed_workload_batch(social, cite):
    """clique + pattern + iso interleave in one batch, complete, and give
    the reference service's answers."""
    l0, l1 = int(cite.labels[0]), int(cite.labels[1])
    fields = [
        dict(graph="social", workload="clique", k=2),
        dict(graph="cite", workload="pattern", m_edges=2, k=2),
        dict(graph="cite", workload="iso", k=2, q_edges=((0, 1),),
             q_labels=(l0, l1)),
    ]
    resps = make_service(social, cite).serve(
        [DiscoveryRequest(**f) for f in fields])
    wants = make_ref_service().serve([RefRequest(**f) for f in fields])
    assert [r.status for r in resps] == ["ok"] * 3
    for r, w in zip(resps, wants):
        assert r.result_keys, f"{r.workload} returned no results"
        assert len(r.results) == len(
            [k for k in r.result_keys if k > NEG_KEY])
        assert (r.result_keys, r.results, r.terminated) == \
            (w.result_keys, w.results, w.terminated)


# ------------------------------------------------- the port's differences
def test_weighted_clique_rejects_kernel_path():
    """tests/test_kernels.py's case: use_pallas is rejected for weighted
    clique at validation, with the reference's message."""
    reg = GraphRegistry()
    reg.register("g", gen.planted_clique_graph(30, 100, 5, seed=0))
    ref_reg = RefRegistry()
    ref_reg.register("g", ref_gen.planted_clique_graph(30, 100, 5, seed=0))
    fields = dict(graph="g", workload="weighted-clique",
                  weights=tuple([1] * 30), use_pallas=True)
    with pytest.raises(ValidationError, match="weighted-clique") as got:
        DiscoveryRequest(**fields).validate(reg)
    with pytest.raises(ValueError) as want:
        RefRequest(**fields).validate(ref_reg)
    assert str(got.value) == str(want.value)
    DiscoveryRequest(graph="g", workload="weighted-clique",
                     weights=tuple([1] * 30)).validate(reg)


@pytest.mark.parametrize("fields,words", [
    (dict(workload="clique", interpret=True), "has no meaning here"),
    (dict(workload="clique", interpret=False), "has no meaning here")])
def test_port_rejects_what_it_does_not_run(social, cite, fields, words):
    """``interpret`` has no meaning on the port: an error response, and
    the service goes on serving the rest of the batch."""
    svc = make_service(social, cite)
    bad, ok = svc.serve([
        DiscoveryRequest(graph="social", k=2, **fields),
        DiscoveryRequest(graph="social", workload="clique", k=2)])
    assert bad.status == "error" and words in bad.error
    assert ok.status == "ok" and ok.result_keys


def test_sync_every_runs_on_one_device(social, cite):
    """With one shard the reference's single-device engine ignores
    ``sync_every``, and so does the port (the answer is equal)."""
    svc = make_service(social, cite)
    a = svc.query(DiscoveryRequest(graph="social", workload="clique", k=3,
                                   sync_every=4, use_cache=False))
    b = svc.query(DiscoveryRequest(graph="social", workload="clique", k=3,
                                   use_cache=False))
    assert a.status == "ok", a.error
    assert (a.result_keys, a.results) == (b.result_keys, b.results)


@pytest.mark.parametrize("fields", [
    dict(graph="social", workload="clique", k=3, sync_every=4,
         steps_per_sync=4, use_pallas=True),
    dict(graph="cite", workload="iso", k=3, q_edges=((1, 0), (2, 1)),
         q_labels=(0, 1, 2), sync_every=2, use_pallas=True)])
def test_compile_request_carries_engine_knobs_like_reference(social, cite,
                                                             fields):
    """``engine_cfg`` carries ``sync_every``, ``steps_per_sync`` and
    ``use_pallas`` as the reference's does (the engine does not read the
    first and the last)."""
    from repro.service.api import compile_request as ref_compile
    from repro_torch.service.api import compile_request
    got = compile_request(DiscoveryRequest(**fields),
                          make_service(social, cite).registry,
                          device="cpu").engine_cfg
    want = ref_compile(RefRequest(**fields),
                       make_ref_service().registry).engine_cfg
    for name in ("sync_every", "steps_per_sync", "use_pallas"):
        assert getattr(got, name) == getattr(want, name), name


def test_default_device_raises_without_card(social):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiscoveryService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_discovery(lines=[], out=io.StringIO())


def test_serve_cli_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    (tmp_path / "r.jsonl").write_text("")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests",
         str(tmp_path / "r.jsonl")], capture_output=True, text=True,
        timeout=120, env=_env())
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# ------------------------------------------------------------ the serve loop
JSONL = [
    {"graph": "demo-social", "workload": "clique", "k": 3,
     "request_id": "clique"},
    {"graph": "demo-social", "workload": "clique", "k": 3,
     "request_id": "clique-hit"},
    {"graph": "demo-social", "workload": "clique", "k": 2, "batch": 8,
     "pool_capacity": 32, "steps_per_sync": 4, "request_id": "spill"},
    {"graph": "demo-social", "workload": "weighted-clique", "k": 2,
     "weights": [(v * 7) % 19 + 1 for v in range(200)],
     "request_id": "weighted"},
    {"graph": "demo-citeseer", "workload": "iso", "k": 3,
     "q_edges": [[0, 1], [1, 2]], "q_labels": [0, 1, 0], "use_pallas": True,
     "request_id": "iso"},
    {"graph": "demo-citeseer", "workload": "pattern", "k": 2, "m_edges": 3,
     "use_pallas": True, "request_id": "pattern"},
    {"graph": "demo-attributed", "workload": "iso", "k": 3,
     "q_edges": [[0, 1], [1, 2], [0, 2]], "q_labels": [1, 1, 1],
     "label_predicate": {"vertex_any_of": [1, 2],
                         "q_any_of": [[1, 2], [1, 2], [1, 2]],
                         "edge_any_of": [0]}, "request_id": "predicate"},
    "not json at all",
    {"graph": "demo-social", "workload": "clique", "k": "three"},
    {"graph": "nope", "workload": "clique", "request_id": "unknown"},
    {"graph": "demo-social", "workload": "weighted-clique",
     "weights": [1] * 200, "use_pallas": True, "request_id": "w-kernel"},
    {"cmd": "metrics"},
    {"graph": "demo-social", "workload": "clique", "k": 3,
     "candidate_budget": 200, "request_id": "budget"},
]


def _lines():
    return [x if isinstance(x, str) else json.dumps(x) for x in JSONL]


def _strip_wall_clock(line: str) -> dict:
    d = json.loads(line)
    d.pop("latency_s", None)
    if isinstance(d.get("stats"), dict):
        d["stats"].pop("straggler_steps", None)
    return d


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    return env


def test_jsonl_stream_gives_the_reference_response_lines(tmp_path):
    dump = str(tmp_path / "metrics.json")
    port_out, ref_out = io.StringIO(), io.StringIO()
    svc = serve_discovery(lines=_lines(), out=port_out, batch_size=4,
                          device="cpu", metrics_dump=dump)
    ref = ref_serve(lines=_lines(), out=ref_out, batch_size=4,
                    metrics_dump=str(tmp_path / "ref_metrics.json"))
    got = [_strip_wall_clock(x) for x in port_out.getvalue().splitlines()]
    want = [_strip_wall_clock(x) for x in ref_out.getvalue().splitlines()]
    assert len(got) == len(want) == len(JSONL)
    for g, w in zip(got, want):
        if g.get("cmd") == "metrics":     # counters only: timings differ
            assert g["status"] == w["status"] == "ok"
            for name in ("service_requests_total", "service_cache_hits_total",
                         "service_cache_misses_total",
                         "service_validation_errors_total",
                         "service_engine_steps_total"):
                assert g["snapshot"]["metrics"][name]["value"] == \
                    w["snapshot"]["metrics"][name]["value"], name
            continue
        assert g == w
    by_id = {g.get("request_id"): g for g in got}
    assert by_id["clique-hit"]["cached"] is True
    assert by_id["pattern"]["status"] == "ok" and by_id["pattern"]["results"]
    assert by_id["predicate"]["status"] == "ok"
    assert by_id["w-kernel"]["status"] == "error"
    assert sum(g.get("status") == "error" for g in got) == 4
    assert svc.engine_steps_total == ref.engine_steps_total
    assert svc.cache.stats() == ref.cache.stats()
    assert json.load(open(dump))["metrics"]["service_requests_total"][
        "value"] == len(JSONL) - 3


def test_serve_cli_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu``: one response
    line a request, the stderr summary, and a ``shards: 2`` request
    answered on the one device with the single-shard answer."""
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join([
        json.dumps({"graph": "demo-social", "workload": "clique", "k": 3,
                    "shards": 2, "request_id": "sharded"}),
        json.dumps({"graph": "demo-social", "workload": "clique", "k": 3,
                    "request_id": "one"})]) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", str(reqs)], capture_output=True, text=True,
        timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr
    sharded, one = (json.loads(x) for x in proc.stdout.splitlines())
    assert sharded["status"] == "ok", sharded
    assert sharded["stats"]["syncs"] == sharded["stats"]["steps"] > 0
    assert one["status"] == "ok" and one["result_keys"] == [7, 6, 6]
    assert (sharded["result_keys"], sharded["results"]) == \
        (one["result_keys"], one["results"])
    assert "[serve] 2 requests" in proc.stderr


# -------------------------------------------------------- sharded requests
SHARDED_JSONL = [
    {"graph": "demo-social", "workload": "clique", "k": 3, "shards": 2,
     "request_id": "x2"},
    {"graph": "demo-social", "workload": "clique", "k": 3, "shards": 2,
     "steps_per_sync": 4, "sync_every": 2, "use_cache": False,
     "request_id": "x2-T4-K2"},
    {"graph": "demo-social", "workload": "clique", "k": 3, "shards": 2,
     "step_budget": 7, "request_id": "x2-budget"},
    {"graph": "demo-citeseer", "workload": "iso", "k": 3,
     "q_edges": [[0, 1], [1, 2]], "q_labels": [0, 1, 0], "shards": 2,
     "request_id": "iso-x2"},
    {"graph": "demo-social", "workload": "weighted-clique", "k": 2,
     "weights": [(v * 7) % 19 + 1 for v in range(200)], "shards": 8,
     "steps_per_sync": 4, "sync_every": 2, "request_id": "weighted-x8"},
    {"graph": "demo-citeseer", "workload": "pattern", "k": 2, "m_edges": 3,
     "shards": 2, "request_id": "pattern-x2"},
    {"graph": "demo-social", "workload": "clique", "k": 3,
     "request_id": "x1"},
]


def _reference_child(out: str) -> None:
    """The reference's serve loop over :data:`SHARDED_JSONL` (this file as
    a script, 8 forced host devices), its response lines to ``out``."""
    with open(out, "w") as f:
        ref_serve(lines=[json.dumps(x) for x in SHARDED_JSONL], out=f,
                  batch_size=4)


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    """The reference's response lines for :data:`SHARDED_JSONL`, by
    request id, wall-clock fields removed."""
    out = tmp_path_factory.mktemp("service_reference") / "lines.jsonl"
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ,            # a stripped env can stall JAX start-up
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(repo / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=repo, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [_strip_wall_clock(x) for x in out.read_text().splitlines()]
    assert len(lines) == len(SHARDED_JSONL)
    return {line["request_id"]: line for line in lines}


def test_sharded_requests_give_the_reference_response_lines(
        sharded_reference):
    """Every ``shards > 1`` request through the port's loop: the reference
    loop's response line (under forced devices), ``latency_s`` and
    ``straggler_steps`` removed; the pattern request the reference's
    error."""
    out = io.StringIO()
    serve_discovery(lines=[json.dumps(x) for x in SHARDED_JSONL], out=out,
                    batch_size=4, device="cpu")
    got = [_strip_wall_clock(x) for x in out.getvalue().splitlines()]
    assert [g["request_id"] for g in got] == \
        [x["request_id"] for x in SHARDED_JSONL]
    for g in got:
        assert g == sharded_reference[g["request_id"]], g["request_id"]
    by_id = {g["request_id"]: g for g in got}
    assert by_id["pattern-x2"]["status"] == "error"
    assert by_id["x2-budget"]["terminated"] == "step_budget"
    assert by_id["x2-budget"]["stats"]["steps"] == 7
    for name in ("x2", "x2-T4-K2", "iso-x2", "weighted-x8"):
        assert by_id[name]["status"] == "ok" and by_id[name]["results"]
    # one exchange a step at K = 1, one a segment of 2 at K = 2
    assert by_id["x2"]["stats"]["syncs"] == by_id["x2"]["stats"]["steps"]
    stale = by_id["x2-T4-K2"]["stats"]
    assert stale["syncs"] == -(-stale["steps"] // 2)
    assert stale["host_syncs"] < stale["steps"]
    assert (by_id["x2"]["result_keys"], by_id["x2"]["results"]) == \
        (by_id["x1"]["result_keys"], by_id["x1"]["results"])


@pytest.mark.parametrize("T,K", [(1, 1), (4, 2)])
def test_sharded_request_resumes_through_the_service(sharded_reference,
                                                     tmp_path, T, K):
    """A checkpointed 2-shard request cut by its step budget (at a
    macro-step's end), then resumed with the full budget by a new service:
    the reference's uninterrupted answer and counters."""
    from repro_torch.launch.serve import make_demo_registry
    want = sharded_reference["x2" if T == 1 else "x2-T4-K2"]
    base = dict(graph="demo-social", workload="clique", k=3, shards=2,
                steps_per_sync=T, sync_every=K, checkpoint_every=4,
                checkpoint_dir=str(tmp_path / "ck"), use_cache=False)
    cut = DiscoveryService(registry=make_demo_registry(), device="cpu").query(
        DiscoveryRequest(**base, step_budget=8))
    assert cut.status == "ok" and cut.terminated == "step_budget"
    assert cut.stats["steps"] == 8
    steps = sorted(os.listdir(tmp_path / "ck"))
    assert steps[-1] == "step_00000008"
    manifest = json.loads((tmp_path / "ck" / steps[-1] / "manifest.json")
                          .read_text())
    assert manifest["extra"]["kind"] == "sharded_engine"
    assert manifest["extra"]["shards"] == 2
    svc = DiscoveryService(registry=make_demo_registry(), device="cpu")
    done = svc.query(DiscoveryRequest(**base, resume=True))
    assert done.status == "ok" and done.terminated == "complete"
    got = _strip_wall_clock(json.dumps(done.to_dict()))
    for field in ("result_keys", "results", "stats", "workload"):
        assert got[field] == want[field], field
    assert svc.engine_steps_total == want["stats"]["steps"] - 8


if __name__ == "__main__":
    _reference_child(sys.argv[1])
