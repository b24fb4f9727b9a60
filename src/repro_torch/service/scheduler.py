"""Multi-query scheduler + the discovery service facade (the reference's
DESIGN.md §9.2) — the port of ``repro.service.scheduler``, on one device:
:class:`DiscoveryService` runs every query on its ``device`` (``cuda``
unless the caller names another; it raises without a card).

The engine's super-step is pure per-query state-in/state-out
(:class:`repro_torch.core.engine.EngineState`), so serving many concurrent
queries is a *scheduling* problem, not an engine problem: this module
round-robins super-steps across all live queries, giving every query
forward progress while long-running ones keep the device busy.  Each query
keeps its own device pool, result set, and VPQ, so interleaving cannot
change any query's answer — a scheduled query returns exactly what a
dedicated ``Engine.run()`` would (asserted in ``tests/test_service.py``).

``pattern`` queries run on the aggregate model (host-side group heap,
vectorized embedding extension); one scheduler step processes one group
pop, mirroring :func:`repro_torch.core.aggregate.topk_frequent_patterns`
exactly.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional


from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.aggregate import TopKPatternMiner
from repro_torch.core.api import resolve_device
from repro_torch.core.engine import NEG, Engine
from repro_torch.core.graph import GraphStore
from repro_torch.distributed import ShardedEngine
from repro_torch.obs import NOOP
from repro_torch.runtime.fault_tolerance import StragglerMonitor

from .api import (DiscoveryRequest, DiscoveryResponse, GraphRegistry,
                  compile_request)
from .cache import ResultCache, make_cache_key


# ------------------------------------------------------------------- tasks
class EngineQueryTask:
    """One queue-driven query (clique / weighted-clique / iso) being stepped.

    ``engine`` may be shared across tasks with the identical compiled spec
    (the service's engine cache): all per-query search state lives in
    ``self.state``, so a shared engine only shares the computation's device
    tables and the macro-step accumulator.
    """

    def __init__(self, request: DiscoveryRequest, engine: Engine,
                 obs=NOOP):
        self.request = request
        self.comp = engine.comp
        self.engine = engine
        # queue-wait attribution (DESIGN.md §16): time from admission to
        # this task's first scheduled step under the round-robin
        self._obs = obs
        self._admitted = time.perf_counter() if obs.enabled else 0.0
        self._started = False
        # durable runs (DESIGN.md §15): resume re-admits the query from the
        # newest committed checkpoint; checkpoint_every persists it as it
        # steps.  The restored state carries its step count, so the
        # remaining step_budget is honored exactly, and steps_at_admission
        # lets the service count only the steps *this* admission ran
        # (a restored query must not double-count its pre-crash steps in
        # engine_steps_total).
        self._mgr = None
        if request.checkpoint_dir and (request.checkpoint_every > 0
                                       or request.resume):
            self._mgr = CheckpointManager(request.checkpoint_dir)
        self.state = None
        if request.resume and self._mgr is not None and \
                self._mgr.latest_step() is not None:
            self.state = engine.resume(self._mgr)
        if self.state is None:
            self.state = engine.start()
        self.steps_at_admission = self.state.steps
        self._last_ckpt = self.state.steps
        # per-query slow-step watchdog: EMA step-time monitor, flagged
        # steps surfaced as stats["straggler_steps"]
        self.straggler = StragglerMonitor()
        self.terminated: Optional[str] = None
        self._payload: Optional[dict] = None
        if self.state.done:                 # a resumed, finished run
            self.terminated = "complete"
        elif self.state.steps >= request.step_budget:
            self.terminated = "step_budget"
        elif self._over_candidate_budget():  # seed frontier alone may exceed
            self.terminated = "candidate_budget"

    def _over_candidate_budget(self) -> bool:
        budget = self.request.candidate_budget
        return budget is not None and self.state.candidates >= budget

    @property
    def finished(self) -> bool:
        return self.terminated is not None

    def step(self) -> None:
        if self.finished:
            return
        # one scheduled step is one engine macro-step (steps_per_sync fused
        # super-steps); capping the fused count to the remaining budget
        # keeps step_budget truncation exact for any steps_per_sync
        t0 = time.perf_counter()
        if not self._started:
            self._started = True
            if self._obs.enabled:
                self._obs.histogram(
                    "service_queue_wait_seconds",
                    "admission-to-first-step wait under the scheduler"
                ).observe(t0 - self._admitted)
        self.engine.step(self.state,
                         max_inner=self.request.step_budget
                         - self.state.steps)
        self.straggler.record(self.state.steps, time.perf_counter() - t0)
        # budgets come from the request, not engine.cfg: the engine may be
        # shared with requests that differ only in budgets
        if self.state.done:
            self.terminated = "complete"
        elif self.state.steps >= self.request.step_budget:
            self.terminated = "step_budget"
        elif self._over_candidate_budget():
            self.terminated = "candidate_budget"
        if self._mgr is not None and self.request.checkpoint_every > 0 and \
                self.state.steps - self._last_ckpt >= \
                self.request.checkpoint_every:
            self.engine.save_checkpoint(self._mgr, self.state)
            self._last_ckpt = self.state.steps

    def finalize(self) -> dict:
        if self._payload is not None:
            return self._payload
        if self._mgr is not None and self.request.checkpoint_every > 0 \
                and self.state.steps > self._last_ckpt:
            # terminal state is restorable too (before finalize closes
            # the VPQ; the capture runs synchronously so close is safe)
            self.engine.save_checkpoint(self._mgr, self.state)
        res = self.engine.finalize(self.state)
        if self._mgr is not None:
            self._mgr.wait()
        results = []
        for i, key in enumerate(res.result_keys):
            if int(key) == int(NEG):
                continue   # empty result slot (fewer than k results exist)
            state_row = res.result_states[i]
            results.append(self.comp.describe(state_row)
                           if self.comp.describe else
                           [int(x) for x in state_row])
        self._payload = dict(
            workload=self.request.workload,
            result_keys=[int(x) for x in res.result_keys],
            results=results,
            stats=dict(steps=res.steps, candidates=res.candidates,
                       expanded=res.expanded, pruned=res.pruned,
                       spilled=res.spilled, refilled=res.refilled,
                       rebalanced=res.rebalanced,
                       late_pruned=res.late_pruned,
                       syncs=res.syncs, host_syncs=res.host_syncs,
                       straggler_steps=self.straggler.straggler_steps),
            terminated=self.terminated or "complete")
        return self._payload


class PatternQueryTask:
    """Top-k frequent-pattern query, stepped one group pop at a time.

    Thin budget/termination wrapper over
    :class:`repro_torch.core.aggregate.TopKPatternMiner` — the same
    implementation :func:`~repro_torch.core.aggregate.topk_frequent_patterns`
    runs to completion, so prioritization/pruning order cannot diverge
    between scheduled and library runs.  Budget early-termination is a
    service-level concern enforced here (inclusive, like the engine task),
    not inside the miner.
    """

    def __init__(self, req: DiscoveryRequest, graph: GraphStore,
                 obs=NOOP, device=None):
        self.request = req
        self._obs = obs
        self._admitted = time.perf_counter() if obs.enabled else 0.0
        self._started = False
        # the miner keeps its library-default runaway cap; the service
        # budget is enforced here, between steps, with the same inclusive
        # (>=) semantics as EngineQueryTask for every workload
        self.miner = TopKPatternMiner(graph, req.m_edges, req.k,
                                      use_pallas=req.use_pallas,
                                      predicate=req.predicate(),
                                      label_filter=req.label_filter,
                                      device=device)
        self.straggler = StragglerMonitor()
        self.terminated: Optional[str] = (
            "complete" if self.miner.done else None)
        self._payload: Optional[dict] = None
        if not self.finished and self._over_candidate_budget():
            self.terminated = "candidate_budget"   # seed embeddings alone

    def _over_candidate_budget(self) -> bool:
        budget = self.request.candidate_budget
        return budget is not None and self.miner.candidates >= budget

    @property
    def finished(self) -> bool:
        return self.terminated is not None

    def step(self) -> None:
        if self.finished:
            return
        t0 = time.perf_counter()
        if not self._started:
            self._started = True
            if self._obs.enabled:
                self._obs.histogram(
                    "service_queue_wait_seconds",
                    "admission-to-first-step wait under the scheduler"
                ).observe(t0 - self._admitted)
        self.miner.step()
        self.straggler.record(self.miner.steps, time.perf_counter() - t0)
        if self.miner.done:
            self.terminated = ("complete" if self.miner.completed
                               else "candidate_budget")
        elif self._over_candidate_budget():
            self.terminated = "candidate_budget"
        elif self.miner.steps >= self.request.step_budget:
            self.terminated = "step_budget"

    def finalize(self) -> dict:
        if self._payload is not None:
            return self._payload
        res = self.miner.result()
        self._payload = dict(
            workload="pattern",
            result_keys=[sup for sup, _ in res.patterns],
            results=[[list(edge) for edge in code]
                     for _, code in res.patterns],
            stats=dict(steps=self.miner.steps, candidates=res.candidates,
                       expanded=res.groups_expanded,
                       pruned=res.groups_pruned, spilled=0, refilled=0,
                       rebalanced=0, late_pruned=0,
                       straggler_steps=self.straggler.straggler_steps),
            terminated=self.terminated or "complete")
        return self._payload


# --------------------------------------------------------------- scheduler
class QueryScheduler:
    """Round-robins engine steps across live queries.

    ``slice_steps`` is the number of consecutive engine steps a query gets
    per scheduling turn — 1 is fair round-robin; larger values amortize
    host-side scheduling overhead at the cost of per-query latency spread.
    When a request sets ``steps_per_sync = T > 1`` each scheduled step is
    one fused *macro*-step of up to T super-steps (DESIGN.md §13), so a
    slice covers up to ``slice_steps * T`` super-steps — the two knobs
    compose: slices amortize scheduling, macro-steps amortize dispatch.
    """

    def __init__(self, slice_steps: int = 1):
        assert slice_steps >= 1
        self.slice_steps = slice_steps

    def drive(self, tasks: List) -> None:
        """Step all tasks to completion, interleaved."""
        live = [t for t in tasks if not t.finished]
        while live:
            for task in live:
                for _ in range(self.slice_steps):
                    task.step()
                    if task.finished:
                        break
            live = [t for t in live if not t.finished]


# ----------------------------------------------------------------- service
class DiscoveryService:
    """Request validation -> cache lookup -> scheduled execution -> response.

    The unit of service work is a *batch* of requests (:meth:`serve`): all
    cache misses in the batch run concurrently under one
    :class:`QueryScheduler`.  ``engine_steps_total`` counts every engine
    super-step executed on behalf of this service — cache hits add zero.

    Every query runs on ``device`` (default ``cuda``; raises when no CUDA
    device is present and ``device`` is not given), so the engines the
    service caches all hold their tables and pools there.
    """

    def __init__(self, registry: Optional[GraphRegistry] = None,
                 cache: Optional[ResultCache] = None,
                 slice_steps: int = 1, engine_cache_size: int = 32,
                 observability=None, device=None):
        self.device = resolve_device(device)
        self.registry = registry or GraphRegistry()
        self.cache = cache or ResultCache()
        self.scheduler = QueryScheduler(slice_steps=slice_steps)
        # engine reuse: identical specs (same engine key) share one Engine
        # and therefore one computation's device tables; all search state
        # is per-task (EngineState), so sharing is safe even within a
        # batch.  Every engine here lives on self.device.  LRU-bounded;
        # TTL is irrelevant for an engine.
        self._engines = ResultCache(capacity=engine_cache_size,
                                    ttl_s=float("inf"))
        self.engine_steps_total = 0
        self.requests_served = 0
        # observability (DESIGN.md §16): one shared registry for service
        # counters AND (via _make_task injection) the engines of observe=
        # True requests, so /metrics answers for the whole stack at once
        self.obs = observability if observability is not None else NOOP
        self._m_requests = self.obs.counter(
            "service_requests_total", "requests received")
        self._m_cache_hits = self.obs.counter(
            "service_cache_hits_total", "result-cache hits")
        self._m_cache_misses = self.obs.counter(
            "service_cache_misses_total",
            "result-cache misses (executed queries)")
        self._m_validation_errors = self.obs.counter(
            "service_validation_errors_total", "rejected requests")
        self._m_engine_steps = self.obs.counter(
            "service_engine_steps_total",
            "engine super-steps run on behalf of this service")
        self._h_request = self.obs.histogram(
            "service_request_seconds", "per-request wall time")

    def register_graph(self, name: str, graph) -> None:
        self.registry.register(name, graph)

    # ------------------------------------------------------------ serving
    def serve(self, requests: List[DiscoveryRequest]
              ) -> List[DiscoveryResponse]:
        """Serve a batch; responses come back in request order."""
        t0 = time.perf_counter()
        self._m_requests.inc(len(requests))
        responses: List[Optional[DiscoveryResponse]] = [None] * len(requests)
        pending: List[tuple] = []      # (indices, cache_key|None, task)
        by_key: Dict[str, tuple] = {}  # within-batch dedup of identical specs

        for i, req in enumerate(requests):
            # validation, the cache key and the task (engine.start in it)
            with self.obs.span("service.admit"):
                try:
                    # validate only — lowering to a computation is deferred
                    # to cache misses, so a cache hit costs no compile work
                    graph = req.validate(self.registry)
                    key = make_cache_key(graph.fingerprint,
                                         req.canonical_spec())
                    if req.use_cache:
                        payload = self.cache.get(key)
                        if payload is not None:
                            self._m_cache_hits.inc()
                            lat = time.perf_counter() - t0
                            self._h_request.observe(lat)
                            responses[i] = self._payload_to_response(
                                req, payload, cached=True, latency_s=lat)
                            continue
                        if key in by_key:  # identical spec in this batch
                            by_key[key][0].append(i)
                            continue
                    entry = ([i], key if req.use_cache else None,
                             self._make_task(req, graph))
                    self._m_cache_misses.inc()
                except (TypeError, ValueError) as e:
                    # ValidationError and any mistyped field the validators
                    # trip over: reject this request, keep serving the batch
                    self._m_validation_errors.inc()
                    responses[i] = DiscoveryResponse(
                        request_id=req.request_id,
                        workload=str(req.workload), status="error",
                        error=str(e))
                    continue
                pending.append(entry)
                if req.use_cache:
                    by_key[key] = entry

        with self.obs.span("service.drive"):
            self.scheduler.drive([task for _, _, task in pending])

        for indices, key, task in pending:
            # the task's finalize and its responses
            with self.obs.span("service.finalize"):
                payload = task.finalize()
                if isinstance(task, EngineQueryTask):
                    # count only the steps this admission actually ran: a
                    # resumed state arrives carrying its pre-crash step
                    # count
                    ran = task.state.steps - task.steps_at_admission
                    self.engine_steps_total += ran
                    self._m_engine_steps.inc(ran)
                if key is not None:
                    self.cache.put(key, payload)
                for j, i in enumerate(indices):
                    if j > 0:   # within-batch dedup joins are cache hits too
                        self._m_cache_hits.inc()
                    lat = time.perf_counter() - t0
                    self._h_request.observe(lat)
                    responses[i] = self._payload_to_response(
                        requests[i], payload, cached=j > 0, latency_s=lat)

        self.requests_served += len(requests)
        return responses   # type: ignore[return-value]

    def query(self, request: DiscoveryRequest) -> DiscoveryResponse:
        """Single-request convenience wrapper around :meth:`serve`."""
        return self.serve([request])[0]

    def _make_task(self, req: DiscoveryRequest, graph: GraphStore):
        if req.workload == "pattern":
            return PatternQueryTask(req, graph, obs=self.obs,
                                    device=self.device)
        # the engine key covers only what shapes the engine: budgets are
        # enforced per-task (so they're dropped from the spec), while
        # use_pallas/interpret/steps_per_sync/sync_every change the step
        # without changing complete-run results (so they're added back —
        # all four are deliberately absent from the result-cache key;
        # shards is already in the spec).  The key is the reference's;
        # the engine cache is this service's, so its device needs no key.  The checkpoint
        # knobs join them: they ride EngineConfig (Engine.run reads them),
        # so tasks sharing an engine must share its checkpoint policy —
        # and two queries writing different checkpoint_dirs must not share
        # one engine object (DESIGN.md §15).
        engine_spec = req.canonical_spec()
        engine_spec.pop("step_budget", None)
        engine_spec.pop("candidate_budget", None)
        engine_spec["use_pallas"] = req.use_pallas
        engine_spec["interpret"] = req.interpret
        engine_spec["steps_per_sync"] = req.steps_per_sync
        engine_spec["sync_every"] = req.sync_every
        engine_spec["checkpoint_every"] = req.checkpoint_every
        engine_spec["checkpoint_dir"] = req.checkpoint_dir
        engine_spec["observe"] = req.observe
        engine_key = make_cache_key(graph.fingerprint, engine_spec)
        engine = self._engines.get(engine_key)
        if engine is None:
            with self.obs.span("service.compile"):
                compiled = compile_request(req, self.registry, graph=graph,
                                           device=self.device)
                if req.observe and self.obs.enabled:
                    # observing engines record into the service registry
                    # so a single snapshot covers the whole process
                    # (DESIGN.md §16)
                    compiled.engine_cfg.observability = self.obs
                if compiled.engine_cfg.shards > 1:
                    engine = ShardedEngine(compiled.comp,
                                           compiled.engine_cfg)
                else:
                    engine = Engine(compiled.comp, compiled.engine_cfg)
            self._engines.put(engine_key, engine)
        return EngineQueryTask(req, engine, obs=self.obs)

    @staticmethod
    def _payload_to_response(req: DiscoveryRequest, payload: dict,
                             cached: bool, latency_s: float
                             ) -> DiscoveryResponse:
        # deep copy so callers mutating a response (or its nested result
        # lists) cannot corrupt the cached payload or sibling responses
        payload = copy.deepcopy(payload)
        return DiscoveryResponse(
            request_id=req.request_id, workload=payload["workload"],
            status="ok", result_keys=payload["result_keys"],
            results=payload["results"], stats=payload["stats"],
            terminated=payload["terminated"], cached=cached,
            latency_s=latency_s)
