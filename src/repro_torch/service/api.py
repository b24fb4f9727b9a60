"""Discovery-service request/response schema (the reference's DESIGN.md §9,
docs/API.md) — the port of ``repro.service.api``.

Every request field, validation message and canonical spec is the
reference's, so equal requests key equally and a JSONL request stream gets
the same response lines from both packages.  The port differs in three
places:

* ``interpret`` must be null, else a :class:`ValidationError` (a ``status:
  "error"`` response, never a crash): the kernel path follows the tensors'
  device (the service's ``device``), so a Pallas interpret mode has no
  meaning;
* ``shards > 1`` runs :class:`repro_torch.distributed.ShardedEngine`,
  whose shard axis is logical: any shard count runs on the one device,
  where the reference answers an error beyond its JAX device count;
* ``use_pallas`` stays on the wire and out of the cache key as in the
  reference, and picks the candidate algorithm of iso and of the pattern
  probes; the :class:`EngineConfig` carries it, as the reference's does,
  and the engine does not read it: clique's kernel follows the device.

A :class:`DiscoveryRequest` is a declarative query spec — workload, graph
handle, ``k``, and budgets — that :func:`compile_request` turns into the
engine-facing form: a :class:`repro_torch.core.api.SubgraphComputation` on
the service's device plus an
:class:`repro_torch.core.engine.EngineConfig` for the queue-driven workloads
(clique / weighted-clique / iso), or an aggregate-model mining task for
``pattern``.  Validation happens eagerly at submit time so malformed
queries are rejected before any device work, mirroring the query-driven
front-end of Dasgupta & Gupta (arXiv:2102.09120).

Graphs are referred to by *handle* (a registry name), never shipped inline;
the registry resolves handles to :class:`repro_torch.core.graph.GraphStore` and
exposes each graph's content :attr:`~repro.core.graph.GraphStore.fingerprint`
for cache keying.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.api import resolve_device
from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import GraphStore
from repro_torch.core.labels import LABEL_FILTERS, LabelPredicate

from .cache import ResultCache

WORKLOADS = ("clique", "weighted-clique", "iso", "pattern")


class ValidationError(ValueError):
    """A malformed :class:`DiscoveryRequest` (rejected before execution)."""


class GraphRegistry:
    """Named graph handles -> :class:`GraphStore` (the service's data tier)."""

    def __init__(self):
        self._graphs: Dict[str, GraphStore] = {}

    def register(self, name: str, graph: GraphStore) -> None:
        if not isinstance(graph, GraphStore):
            raise TypeError(f"{name}: expected a GraphStore")
        self._graphs[name] = graph

    def get(self, name: str) -> GraphStore:
        if name not in self._graphs:
            raise ValidationError(
                f"unknown graph handle {name!r}; registered: "
                f"{sorted(self._graphs)}")
        return self._graphs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._graphs

    def names(self) -> List[str]:
        return sorted(self._graphs)


@dataclasses.dataclass(frozen=True)
class DiscoveryRequest:
    """One top-k discovery query (fields documented in docs/API.md)."""

    graph: str                        # registry handle
    workload: str                     # clique | weighted-clique | iso | pattern
    k: int = 1
    # budgets / execution knobs
    batch: int = 64                   # B: states dequeued per super-step
    pool_capacity: int = 4096         # C: device pool slots
    step_budget: int = 100_000        # max engine super-steps for this query
    candidate_budget: Optional[int] = None  # max subgraphs materialized
    # workload-specific parameters
    weights: Optional[Tuple[int, ...]] = None             # weighted-clique
    q_edges: Optional[Tuple[Tuple[int, int], ...]] = None  # iso query graph
    q_labels: Optional[Tuple[int, ...]] = None             # iso query labels
    induced: bool = True                                   # iso semantics
    max_hops: int = 2                                      # iso index depth
    m_edges: Optional[int] = None                          # pattern size
    # label-constrained discovery (iso / pattern; DESIGN.md §12):
    # label_predicate is a spec dict with any of `vertex_any_of` (allowed
    # vertex labels), `q_any_of` (per-query-vertex label classes, iso
    # only), `edge_any_of` (allowed edge types; needs a graph with edge
    # labels).  label_filter places the vertex predicate: "pushdown"
    # folds it into the kernel constraint mask + priority index (default),
    # "post" filters after candidate materialization (the host-side
    # baseline).  Complete runs are byte-identical across modes, but
    # budget-truncated runs are not — so BOTH fields join the result-cache
    # key (canonicalized), like batch/pool_capacity/shards.
    label_predicate: Optional[Dict[str, Any]] = None
    label_filter: str = "pushdown"
    # kernel-path knobs (all workloads; byte-identical results, so both
    # are excluded from the result-cache key — DESIGN.md §10)
    use_pallas: bool = False          # Pallas masked-intersection path
    interpret: Optional[bool] = None  # None = auto-detect backend
    # macro-stepping (engine workloads; DESIGN.md §13): number of engine
    # super-steps fused into one jitted device loop per host sync.
    # Complete runs are byte-identical for any value (parity-tested), and
    # step_budget truncation lands on the same step count for any value
    # (the fused loop is capped to the remaining budget) — so like
    # use_pallas/interpret it is EXCLUDED from the result-cache key.
    # Truncated-run caveats (documented in docs/API.md): candidate_budget
    # is still checked between host syncs, so a fused run can overshoot
    # it by up to T-1 super-steps of candidates, and a truncated run's
    # partial answer can differ across values in spill tie-order.
    # Ignored by `pattern` (host-side aggregate model, no engine loop).
    steps_per_sync: int = 1
    # staleness-tolerant bound exchange (sharded engine; DESIGN.md §14):
    # number of shard-local inner steps between §4 bound-exchange
    # all-gathers.  Between exchanges shards prune against the
    # last-exchanged global bound (max'd with the fresh local k-th best),
    # which is only ever looser than per-step exchange — complete runs
    # are byte-identical for any value (parity-tested), so like
    # steps_per_sync it is EXCLUDED from the result-cache key but part of
    # the engine-reuse key (it changes the compiled macro loop).  Ignored
    # by single-device runs (shards == 1 still accepts it — the 1-shard
    # engine amortizes its degenerate self-exchange) and by `pattern`.
    sync_every: int = 1
    # device-mesh sharding (engine workloads; DESIGN.md §11).  shards > 1
    # runs the query on the sharded multi-device engine with batch /
    # pool_capacity as per-shard shapes.  Complete runs are byte-identical
    # for any shard count (parity-tested), but budget-truncated runs are
    # not — so like batch/pool_capacity (and unlike the kernel knobs) it
    # is part of the result-cache key.
    shards: int = 1
    # durable runs (engine workloads; DESIGN.md §15): checkpoint_every =
    # N > 0 persists the query's engine state to checkpoint_dir at the
    # first host-sync boundary every >= N steps, through the atomic-commit
    # protocol; resume=True re-admits the query from the newest committed
    # step there (fresh start when none exists), with the remaining
    # step_budget honored exactly — the restored state carries its step
    # count, so budget truncation lands on the same total step count as an
    # uninterrupted run.  Checkpoints are pure observers (a resumed
    # complete run is byte-identical — crash-proved in
    # tests/test_fault_injection.py), so like use_pallas/steps_per_sync
    # both knobs are EXCLUDED from the result-cache key; they ARE part of
    # the engine-reuse key (tasks sharing an engine share its checkpoint
    # policy via EngineConfig).
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    # observability (DESIGN.md §16): observe=True routes this query's
    # engine metrics/spans into the service's live Observability (or a
    # private one for direct compile_request callers).  A pure observer
    # like checkpointing — results are byte-identical either way
    # (parity-tested in tests/test_obs.py) — so it is EXCLUDED from the
    # result-cache key but part of the engine-reuse key.
    observe: bool = False
    # service knobs
    use_cache: bool = True
    request_id: Optional[str] = None

    # ------------------------------------------------------------- building
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiscoveryRequest":
        """Build from a JSON-decoded dict (lists become tuples)."""
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValidationError(f"unknown request fields: {sorted(unknown)}")
        try:
            for f in ("k", "batch", "pool_capacity", "step_budget",
                      "candidate_budget", "max_hops", "m_edges", "shards",
                      "steps_per_sync", "sync_every", "checkpoint_every"):
                if d.get(f) is not None:
                    d[f] = int(d[f])
            for f in ("induced", "use_pallas", "use_cache", "interpret",
                      "resume", "observe"):
                if d.get(f) is not None:
                    d[f] = bool(d[f])
            if d.get("label_filter") is not None:
                d["label_filter"] = str(d["label_filter"])
            if d.get("checkpoint_dir") is not None:
                d["checkpoint_dir"] = str(d["checkpoint_dir"])
            if d.get("weights") is not None:
                d["weights"] = tuple(int(w) for w in d["weights"])
            if d.get("q_edges") is not None:
                d["q_edges"] = tuple((int(a), int(b)) for a, b in d["q_edges"])
            if d.get("q_labels") is not None:
                d["q_labels"] = tuple(int(l) for l in d["q_labels"])
        except (TypeError, ValueError) as e:
            raise ValidationError(f"malformed request field: {e}") from e
        return cls(**d)

    # ----------------------------------------------------------- validation
    def validate(self, registry: GraphRegistry) -> GraphStore:
        """Check the spec against the registry; returns the resolved graph."""
        if self.workload not in WORKLOADS:
            raise ValidationError(
                f"workload must be one of {WORKLOADS}, got {self.workload!r}")
        if self.k <= 0:
            raise ValidationError(f"k must be >= 1, got {self.k}")
        if self.batch <= 0:
            raise ValidationError(f"batch must be >= 1, got {self.batch}")
        if self.pool_capacity < self.batch:
            raise ValidationError(
                f"pool_capacity ({self.pool_capacity}) must be >= batch "
                f"({self.batch})")
        if self.step_budget <= 0:
            raise ValidationError(
                f"step_budget must be >= 1, got {self.step_budget}")
        if self.candidate_budget is not None and self.candidate_budget <= 0:
            raise ValidationError(
                f"candidate_budget must be >= 1, got {self.candidate_budget}")
        if self.shards < 1:
            raise ValidationError(f"shards must be >= 1, got {self.shards}")
        if self.steps_per_sync < 1:
            raise ValidationError(
                f"steps_per_sync must be >= 1, got {self.steps_per_sync}")
        if self.sync_every < 1:
            raise ValidationError(
                f"sync_every must be >= 1, got {self.sync_every}")
        if self.shards > 1 and self.workload == "pattern":
            raise ValidationError(
                "shards > 1 applies to engine workloads only; pattern "
                "mining runs on the host-side aggregate model "
                "(DESIGN.md §11)")
        if self.checkpoint_every < 0:
            raise ValidationError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValidationError(
                "checkpoint_every > 0 requires `checkpoint_dir`")
        if self.resume and not self.checkpoint_dir:
            raise ValidationError("resume requires `checkpoint_dir`")
        if (self.checkpoint_every > 0 or self.resume) and \
                self.workload == "pattern":
            raise ValidationError(
                "checkpoint/resume applies to engine workloads only; "
                "pattern mining runs on the host-side aggregate model "
                "(DESIGN.md §15)")
        if self.interpret is not None:
            raise ValidationError(
                "interpret has no meaning here: the kernel path follows "
                "the tensors' device")
        g = registry.get(self.graph)

        if self.workload == "weighted-clique":
            if self.use_pallas:
                # the reference's rejection and message, kept: its Pallas
                # kernel has no weighted form.  Here the computation takes
                # the card's kernels (the weighted popcount over weight
                # planes) by its tensors' device, as clique does, whatever
                # use_pallas says
                raise ValidationError(
                    "use_pallas is not supported for weighted-clique "
                    "(needs a weighted-popcount kernel variant; "
                    "DESIGN.md §10)")
            if self.weights is None:
                raise ValidationError("weighted-clique requires `weights`")
            if len(self.weights) != g.n:
                raise ValidationError(
                    f"weights has {len(self.weights)} entries for an "
                    f"{g.n}-vertex graph")
            if any(w <= 0 for w in self.weights):
                raise ValidationError("weights must be positive integers")
        elif self.workload == "iso":
            if self.q_edges is None or self.q_labels is None:
                raise ValidationError("iso requires `q_edges` and `q_labels`")
            if g.labels is None:
                raise ValidationError(
                    f"iso requires a labeled graph; {self.graph!r} is "
                    "unlabeled")
            nq = len(self.q_labels)
            if nq == 0:
                raise ValidationError("iso query graph is empty")
            for a, b in self.q_edges:
                if not (0 <= a < nq and 0 <= b < nq) or a == b:
                    raise ValidationError(
                        f"iso query edge ({a}, {b}) out of range for "
                        f"{nq} query vertices")
            if self.max_hops <= 0:
                raise ValidationError(
                    f"max_hops must be >= 1, got {self.max_hops}")
        elif self.workload == "pattern":
            if self.m_edges is None or self.m_edges <= 0:
                raise ValidationError(
                    "pattern requires `m_edges` >= 1")
            if g.labels is None:
                raise ValidationError(
                    f"pattern mining requires a labeled graph; "
                    f"{self.graph!r} is unlabeled")

        if self.label_filter not in LABEL_FILTERS:
            raise ValidationError(
                f"label_filter must be one of {LABEL_FILTERS}, got "
                f"{self.label_filter!r}")
        if self.label_predicate is not None:
            if self.workload not in ("iso", "pattern"):
                raise ValidationError(
                    f"label_predicate applies to iso/pattern only, not "
                    f"{self.workload!r}")
            try:
                pred = LabelPredicate.from_spec(self.label_predicate)
                if pred is not None:
                    pred.validate(g, self.workload,
                                  nq=(len(self.q_labels)
                                      if self.workload == "iso" else None))
            except ValueError as e:
                raise ValidationError(str(e)) from e
        return g

    def predicate(self) -> Optional[LabelPredicate]:
        """The parsed, canonical :class:`LabelPredicate` (None when the
        spec is absent or trivial).  Raises ``ValidationError`` on a
        malformed spec — call after/with :meth:`validate`.

        Parsed once per request (memoized via ``__dict__``, the
        cached_property idiom — validate, cache keying, engine keying,
        and compilation all consume the same parse).
        """
        if "_pred_cache" not in self.__dict__:
            try:
                pred = LabelPredicate.from_spec(self.label_predicate)
            except ValueError as e:
                raise ValidationError(str(e)) from e
            self.__dict__["_pred_cache"] = pred
        return self.__dict__["_pred_cache"]

    # -------------------------------------------------------- canonical form
    def canonical_spec(self) -> Dict[str, Any]:
        """Canonical, JSON-stable dict of everything that determines the
        *result* of this request — the cache-key payload.

        Excludes ``use_cache`` and ``request_id`` (service plumbing), the
        kernel-path knobs ``use_pallas`` / ``interpret``
        (parity-tested to leave results byte-identical *per step*, so
        kernel- and reference-path runs of the same query share one cache
        entry), ``steps_per_sync`` (DESIGN.md §13: complete runs are
        byte-identical for any fusion depth and budget truncation lands
        on the same step count, so fused and unfused runs of the same
        query share one cache entry too), ``sync_every`` for the same
        reason (DESIGN.md §14: a stale bound is only ever looser, so
        complete runs are byte-identical for any exchange cadence — both
        knobs remain part of the engine-reuse key, which they DO change),
        and the checkpoint knobs ``checkpoint_every`` / ``checkpoint_dir``
        / ``resume`` (DESIGN.md §15: checkpoints are pure observers and a
        resumed run is byte-identical to an uninterrupted one, so
        checkpointed, resumed, and plain runs of the same query share one
        cache entry; the first two join the engine-reuse key — tasks
        sharing an engine share its checkpoint policy).  ``observe`` is
        excluded by the same pure-observer discipline (DESIGN.md §16:
        metrics and spans never touch the step trajectory — parity-tested
        in tests/test_obs.py), so instrumented and plain runs of the same
        query share one cache entry; it joins the engine-reuse key.
        ``shards`` IS included, like
        ``batch``/``pool_capacity``:
        complete runs are shard-count invariant, but a run truncated by
        ``step_budget``/``candidate_budget`` is not, and the cache key
        cannot know at lookup time which case a payload is.  Query edges
        are normalized
        to sorted ``(min, max)`` pairs so isomorphic edge orderings of the
        same query graph key identically.  A label predicate enters in
        its canonical form (sorted, deduplicated label sets) together
        with ``label_filter`` — pushdown and post are byte-identical only
        for complete runs, the same reason ``shards`` is keyed; a trivial
        predicate (absent or empty spec) adds nothing, so constrained and
        unconstrained requests never collide.
        """
        spec: Dict[str, Any] = dict(
            workload=self.workload, k=self.k, batch=self.batch,
            pool_capacity=self.pool_capacity, shards=self.shards,
            step_budget=self.step_budget,
            candidate_budget=self.candidate_budget)
        pred = self.predicate()
        if pred is not None:
            spec["label_predicate"] = pred.canonical()
            spec["label_filter"] = self.label_filter
        if self.workload == "weighted-clique":
            spec["weights"] = list(self.weights)
        elif self.workload == "iso":
            spec["q_edges"] = sorted(
                [min(a, b), max(a, b)] for a, b in self.q_edges)
            spec["q_labels"] = list(self.q_labels)
            spec["induced"] = self.induced
            spec["max_hops"] = self.max_hops
        elif self.workload == "pattern":
            spec["m_edges"] = self.m_edges
        return spec


@dataclasses.dataclass
class DiscoveryResponse:
    """Service reply: top-k results plus execution accounting."""

    request_id: Optional[str]
    workload: str
    status: str                       # "ok" | "error"
    result_keys: List[int] = dataclasses.field(default_factory=list)
    results: List[Any] = dataclasses.field(default_factory=list)
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    terminated: str = "complete"      # complete | step_budget | candidate_budget
    cached: bool = False
    latency_s: float = 0.0
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


# ------------------------------------------------------------------ compile
@dataclasses.dataclass(frozen=True)
class CompiledQuery:
    """A validated request lowered to its executable form."""

    request: DiscoveryRequest
    graph: GraphStore
    kind: str                                     # "engine" | "aggregate"
    comp: Optional[object] = None                 # SubgraphComputation
    engine_cfg: Optional[EngineConfig] = None


# per-(graph fingerprint, max_hops, allowed edge types, device) iso index
# cache: building the Fig.-7 index is a dense-matmul preprocessing pass,
# amortized across requests.  Edge-type predicates need an index built on
# the restricted adjacency (full-graph hop distances would be unsound —
# see build_iso_index), hence the edge-type key component; vertex
# predicates reuse the unrestricted index (restriction happens at
# bound-assembly time inside make_iso_computation).  The device joins the
# key so that a service on one device never takes an index another device
# built (the arrays are equal, but the cache is the process's and one
# process may serve both).  LRU-bounded so long-lived services that cycle
# graphs don't leak indexes.
_ISO_INDEX_CACHE = ResultCache(capacity=16, ttl_s=float("inf"))


def _iso_index(g: GraphStore, max_hops: int,
               predicate: Optional[LabelPredicate], device) -> np.ndarray:
    from repro_torch.core.iso import build_iso_index
    etypes = (",".join(map(str, predicate.edge_any_of))
              if predicate is not None and predicate.edge_any_of is not None
              else "")
    key = f"{g.fingerprint}:{max_hops}:{etypes}:{device}"
    index = _ISO_INDEX_CACHE.get(key)
    if index is None:
        index = build_iso_index(g, max_hops, predicate=predicate,
                                device=device)
        _ISO_INDEX_CACHE.put(key, index)
    return index


def compile_request(req: DiscoveryRequest, registry: GraphRegistry,
                    graph: Optional[GraphStore] = None,
                    device=None) -> CompiledQuery:
    """Validate and lower a request onto the core computational models,
    on ``device`` (default ``cuda``; raises when no CUDA device is present
    and ``device`` is not given).

    ``graph`` short-circuits validation when the caller has already run
    :meth:`DiscoveryRequest.validate` (the service's serve loop does).
    """
    device = resolve_device(device)
    g = graph if graph is not None else req.validate(registry)
    if req.workload == "pattern":
        return CompiledQuery(request=req, graph=g, kind="aggregate")

    # the engine ignores use_pallas (and Engine sync_every), as the
    # reference's does; the computation reads use_pallas
    cfg = EngineConfig(k=req.k, batch=req.batch,
                       pool_capacity=req.pool_capacity,
                       max_steps=req.step_budget, shards=req.shards,
                       steps_per_sync=req.steps_per_sync,
                       sync_every=req.sync_every,
                       checkpoint_every=req.checkpoint_every,
                       checkpoint_dir=req.checkpoint_dir,
                       use_pallas=req.use_pallas, observe=req.observe)

    if req.workload == "clique":
        from repro_torch.core.clique import make_clique_computation
        comp = make_clique_computation(g, device=device)
    elif req.workload == "weighted-clique":
        from repro_torch.core.weighted_clique import (
            make_weighted_clique_computation)
        comp = make_weighted_clique_computation(
            g, np.asarray(req.weights, np.int32), device=device)
    else:  # iso
        from repro_torch.core.iso import make_iso_computation
        pred = req.predicate()
        comp = make_iso_computation(
            g, list(req.q_edges), list(req.q_labels),
            _iso_index(g, req.max_hops, pred, device), induced=req.induced,
            use_pallas=req.use_pallas, predicate=pred,
            label_filter=req.label_filter, device=device)

    return CompiledQuery(request=req, graph=g, kind="engine",
                         comp=comp, engine_cfg=cfg)
