"""Label predicates over attributed data graphs (the reference's
DESIGN.md §12) — the port of ``repro.core.labels``, a numpy-only copy over
the port's :mod:`~repro_torch.core.bitset` and
:class:`~repro_torch.core.graph.GraphStore`.

A :class:`LabelPredicate` constrains which vertices and edges of a labeled
graph may take part in a discovery query.  Three independent components,
all optional:

* ``vertex_any_of`` — a set of allowed vertex labels; every matched data
  vertex must carry one of them;
* ``q_any_of`` — per-query-vertex label *classes* (iso only): query
  vertex ``j`` may map to any data vertex whose label is in class ``j``,
  generalizing the exact ``q_labels`` match;
* ``edge_any_of`` — a set of allowed edge types; discovery runs on the
  spanning subgraph containing only edges of those types (requires a
  graph built with ``edge_labels``).

The predicate compiles to packed ``uint32`` bitsets in the reference's
bytes — an allowed-vertex bitset ``[W]`` and a type-restricted adjacency
``[N, W]`` — which the iso computation moves to its device as ``int32``
words, where the allowed-vertex bitset becomes the row mask of the
masked-intersection kernel (predicate pushdown).  The same object
canonicalizes to a JSON-stable dict.

Validation raises plain :class:`ValueError`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import bitset
from .graph import GraphStore

#: computation constructors accept one of these two placement modes:
#: ``pushdown`` folds the predicate into the kernel-path constraint masks
#: (and tightens the priority index); ``post`` materializes the
#: unconstrained candidates and filters them afterwards (the host-side
#: filtering baseline).  Both return byte-identical complete-run top-k.
LABEL_FILTERS = ("pushdown", "post")

_SPEC_FIELDS = ("vertex_any_of", "q_any_of", "edge_any_of")


def _int_tuple(name: str, value) -> Tuple[int, ...]:
    try:
        out = tuple(int(x) for x in value)
    except (TypeError, ValueError) as e:
        raise ValueError(f"label_predicate.{name}: expected a list of "
                         f"ints, got {value!r}") from e
    if not out:
        raise ValueError(f"label_predicate.{name}: must be non-empty "
                         f"when present (omit the field for no constraint)")
    if any(x < 0 for x in out):
        raise ValueError(f"label_predicate.{name}: labels must be >= 0, "
                         f"got {sorted(out)}")
    return tuple(sorted(set(out)))


@dataclasses.dataclass(frozen=True)
class LabelPredicate:
    """A validated, canonicalized label constraint (all components optional).

    Construct via :meth:`from_spec`, which accepts a JSON-decoded dict (the
    ``label_predicate`` request field), an existing predicate, or ``None``
    (returns ``None``).  Fields are canonical: sorted, deduplicated tuples.
    """

    vertex_any_of: Optional[Tuple[int, ...]] = None
    q_any_of: Optional[Tuple[Tuple[int, ...], ...]] = None
    edge_any_of: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------- building
    @staticmethod
    def from_spec(spec) -> Optional["LabelPredicate"]:
        if spec is None:
            return None
        if isinstance(spec, LabelPredicate):
            return spec
        if not isinstance(spec, dict):
            raise ValueError(
                f"label_predicate must be an object with any of "
                f"{_SPEC_FIELDS}, got {type(spec).__name__}")
        unknown = set(spec) - set(_SPEC_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown label_predicate fields: {sorted(unknown)} "
                f"(known: {_SPEC_FIELDS})")
        v = spec.get("vertex_any_of")
        q = spec.get("q_any_of")
        e = spec.get("edge_any_of")
        if v is not None:
            v = _int_tuple("vertex_any_of", v)
        if e is not None:
            e = _int_tuple("edge_any_of", e)
        if q is not None:
            try:
                q = tuple(_int_tuple(f"q_any_of[{j}]", cls)
                          for j, cls in enumerate(q))
            except TypeError as err:
                raise ValueError(
                    "label_predicate.q_any_of: expected a list of label "
                    "lists, one per query vertex") from err
            if not q:
                raise ValueError(
                    "label_predicate.q_any_of: must be non-empty when "
                    "present")
        pred = LabelPredicate(vertex_any_of=v, q_any_of=q, edge_any_of=e)
        if pred.is_trivial:
            return None
        return pred

    @property
    def is_trivial(self) -> bool:
        return (self.vertex_any_of is None and self.q_any_of is None
                and self.edge_any_of is None)

    # ----------------------------------------------------------- validation
    def validate(self, graph: GraphStore, workload: str,
                 nq: Optional[int] = None) -> None:
        """Check the predicate against a graph + workload; raises ValueError."""
        if graph.labels is None:
            raise ValueError(
                f"label_predicate requires a vertex-labeled graph "
                f"({workload} on an unlabeled graph)")
        n_labels = graph.n_labels
        if self.vertex_any_of is not None and \
                max(self.vertex_any_of) >= n_labels:
            raise ValueError(
                f"label_predicate.vertex_any_of: label "
                f"{max(self.vertex_any_of)} out of range for a graph "
                f"with {n_labels} vertex labels")
        if self.q_any_of is not None:
            if workload != "iso":
                raise ValueError(
                    "label_predicate.q_any_of applies to iso only "
                    f"(got workload {workload!r})")
            if nq is not None and len(self.q_any_of) != nq:
                raise ValueError(
                    f"label_predicate.q_any_of has {len(self.q_any_of)} "
                    f"classes for {nq} query vertices")
            bad = max(max(cls) for cls in self.q_any_of)
            if bad >= n_labels:
                raise ValueError(
                    f"label_predicate.q_any_of: label {bad} out of range "
                    f"for a graph with {n_labels} vertex labels")
        if self.edge_any_of is not None:
            if graph.edge_labels is None:
                raise ValueError(
                    "label_predicate.edge_any_of requires a graph built "
                    "with edge_labels")
            if max(self.edge_any_of) >= graph.n_edge_labels:
                raise ValueError(
                    f"label_predicate.edge_any_of: type "
                    f"{max(self.edge_any_of)} out of range for a graph "
                    f"with {graph.n_edge_labels} edge types")

    # -------------------------------------------------------- canonical form
    def canonical(self) -> Dict[str, Any]:
        """JSON-stable dict for the service result-cache key."""
        out: Dict[str, Any] = {}
        if self.vertex_any_of is not None:
            out["vertex_any_of"] = list(self.vertex_any_of)
        if self.q_any_of is not None:
            out["q_any_of"] = [list(cls) for cls in self.q_any_of]
        if self.edge_any_of is not None:
            out["edge_any_of"] = list(self.edge_any_of)
        return out

    # --------------------------------------------------------- bitset views
    # The views are memoized per (view, graph fingerprint) on the instance:
    # a mining run calls them from every expand_group step and the
    # restricted-adjacency OR-reduce over [T, N, W] planes is far more
    # expensive than the probe it feeds.  The memo rides __dict__ (the
    # cached_property idiom), so frozen-ness, ==, and hash are unaffected.
    def _memo(self, name: str, graph: GraphStore, build):
        memo = self.__dict__.setdefault("_view_memo", {})
        key = (name, graph.fingerprint)
        if key not in memo:
            memo[key] = build()
        return memo[key]

    def vertex_bits(self, graph: GraphStore) -> Optional[np.ndarray]:
        """Packed ``[W] uint32`` bitset of vertices satisfying
        ``vertex_any_of`` (``None`` when the component is absent)."""
        if self.vertex_any_of is None:
            return None
        return self._memo("vertex_bits", graph,
                          lambda: bitset.from_bool(self.vertex_mask(graph)))

    def vertex_mask(self, graph: GraphStore) -> Optional[np.ndarray]:
        """Boolean ``[N]`` form of :meth:`vertex_bits`."""
        if self.vertex_any_of is None:
            return None
        return self._memo(
            "vertex_mask", graph,
            lambda: np.isin(np.asarray(graph.labels), self.vertex_any_of))

    def adjacency(self, graph: GraphStore) -> np.ndarray:
        """``[N, W] uint32`` adjacency restricted to allowed edge types
        (the full adjacency when ``edge_any_of`` is absent)."""
        if self.edge_any_of is None:
            return graph.adj_bits
        return self._memo(
            "adjacency", graph,
            lambda: np.bitwise_or.reduce(
                graph.etype_adj_bits[list(self.edge_any_of)], axis=0))

    def edge_mask_csr(self, graph: GraphStore) -> Optional[np.ndarray]:
        """Boolean ``[M2]`` mask over the CSR ``indices`` slots whose edge
        type is allowed (``None`` when ``edge_any_of`` is absent)."""
        if self.edge_any_of is None:
            return None
        return self._memo(
            "edge_mask_csr", graph,
            lambda: np.isin(np.asarray(graph.edge_labels),
                            self.edge_any_of))
