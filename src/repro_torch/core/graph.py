"""Graph store: the data-graph substrate shared by the Nuri engine and the
GNN workloads.

Holds three synchronized views of an undirected (optionally labeled) graph:

* **CSR** (``indptr``/``indices``) — for neighbor iteration, sampling, and
  ``segment_sum`` message passing,
* **edge list** (``src``/``dst``, each undirected edge twice) — for GNN
  scatter kernels,
* **bitset adjacency** (``adj_bits [N, W] uint32``) — for the discovery
  engine's vectorized set intersections.

Attributed graphs carry two optional label layers (DESIGN.md §12): per-
vertex labels (packed per-label bitsets in :attr:`GraphStore.label_bits`)
and per-edge types (per-type packed adjacency planes in
:attr:`GraphStore.etype_adj_bits`) — both in the same ``[.., W] uint32``
word layout as :mod:`repro_torch.core.bitset`, so label predicates compose
with the masked-intersection kernel by bitwise AND.

All arrays are numpy on the host, byte-identical to ``repro.core.graph``'s;
:meth:`device_arrays` returns torch tensors on a device, with the packed
``uint32`` words as ``int32``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from . import bitset


@dataclasses.dataclass(frozen=True)
class GraphStore:
    n: int                               # number of vertices
    indptr: np.ndarray                   # [N+1] int32 CSR row pointers
    indices: np.ndarray                  # [M2] int32 CSR column indices (sorted per row)
    labels: Optional[np.ndarray] = None  # [N] int32 vertex labels (None = unlabeled)
    # [M2] int32 edge type per directed CSR slot (aligned with ``indices``;
    # both directions of an undirected edge carry the same type) — the
    # attributed-graph edge layer (DESIGN.md §12); None = untyped edges
    edge_labels: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- build
    @staticmethod
    def from_edges(n: int, edges: np.ndarray,
                   labels: Optional[np.ndarray] = None,
                   edge_labels: Optional[np.ndarray] = None) -> "GraphStore":
        """Build from an undirected edge array [M, 2]; dedupes + drops loops.

        ``edge_labels`` is one int type per input edge row; on duplicate
        edges the first occurrence's type wins (deterministic given input
        order).
        """
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        if edge_labels is not None:
            edge_labels = np.asarray(edge_labels, np.int64).reshape(-1)
            if len(edge_labels) != len(edges):
                raise ValueError(
                    f"edge_labels has {len(edge_labels)} entries for "
                    f"{len(edges)} edges")
        keep = edges[:, 0] != edges[:, 1]
        edges = edges[keep]
        if edge_labels is not None:
            edge_labels = edge_labels[keep]
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n + hi
        _, first = np.unique(key, return_index=True)
        lo, hi = lo[first], hi[first]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        lab = (np.concatenate([edge_labels[first], edge_labels[first]])
               if edge_labels is not None else None)
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return GraphStore(
            n=n,
            indptr=indptr.astype(np.int32),
            indices=dst.astype(np.int32),
            labels=None if labels is None else np.asarray(labels, np.int32),
            edge_labels=None if lab is None else lab[order].astype(np.int32),
        )

    # ------------------------------------------------------------ properties
    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return len(self.indices) // 2

    @cached_property
    def fingerprint(self) -> str:
        """Deterministic content hash of the graph (topology + vertex and
        edge labels).

        Keys the service result cache (DESIGN.md §9): two GraphStores with
        identical CSR and labels hash identically regardless of how they
        were built.  The unlabeled/untyped hashes are unchanged from before
        the attributed layers existed (the extra blocks are appended only
        when present).
        """
        h = hashlib.sha256()
        h.update(np.int64(self.n).tobytes())
        h.update(np.ascontiguousarray(self.indptr, np.int64).tobytes())
        h.update(np.ascontiguousarray(self.indices, np.int64).tobytes())
        if self.labels is not None:
            h.update(np.ascontiguousarray(self.labels, np.int64).tobytes())
        if self.edge_labels is not None:
            h.update(b"etypes")
            h.update(np.ascontiguousarray(
                self.edge_labels, np.int64).tobytes())
        return h.hexdigest()

    @property
    def n_labels(self) -> int:
        """Number of distinct vertex-label values (0 = unlabeled)."""
        return 0 if self.labels is None else int(self.labels.max()) + 1

    @property
    def n_edge_labels(self) -> int:
        """Number of distinct edge-type values (0 = untyped)."""
        return 0 if self.edge_labels is None else \
            int(self.edge_labels.max()) + 1

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @cached_property
    def adj_bits(self) -> np.ndarray:
        """[N, W] uint32 packed adjacency rows."""
        w = bitset.num_words(self.n)
        out = np.zeros((self.n, w), np.uint32)
        src = np.repeat(np.arange(self.n), np.diff(self.indptr))
        dst = self.indices.astype(np.int64)
        np.bitwise_or.at(
            out, (src, dst // 32), np.uint32(1) << (dst % 32).astype(np.uint32))
        return out

    @cached_property
    def edge_array(self) -> np.ndarray:
        """[M2, 2] directed edge list (each undirected edge both ways)."""
        src = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.indptr))
        return np.stack([src, self.indices], axis=1)

    @cached_property
    def label_bits(self) -> Optional[np.ndarray]:
        """[L, W] uint32: bitset of vertices per label."""
        if self.labels is None:
            return None
        return np.stack([
            bitset.from_indices(np.nonzero(self.labels == l)[0], self.n)
            for l in range(self.n_labels)])

    @cached_property
    def etype_adj_bits(self) -> Optional[np.ndarray]:
        """[T, N, W] uint32: per-edge-type packed adjacency — row ``v`` of
        plane ``t`` is the set of neighbors reached from ``v`` over an edge
        of type ``t``.  ORing planes over an allowed-type set yields the
        restricted adjacency a label predicate's ``edge_any_of`` runs on
        (:meth:`repro.core.labels.LabelPredicate.adjacency`); the OR over
        *all* planes is exactly :attr:`adj_bits`.
        """
        if self.edge_labels is None:
            return None
        w = bitset.num_words(self.n)
        out = np.zeros((self.n_edge_labels, self.n, w), np.uint32)
        src = np.repeat(np.arange(self.n), np.diff(self.indptr))
        dst = self.indices.astype(np.int64)
        et = self.edge_labels.astype(np.int64)
        np.bitwise_or.at(
            out, (et, src, dst // 32),
            np.uint32(1) << (dst % 32).astype(np.uint32))
        return out

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors(u)
        i = np.searchsorted(row, v)
        return bool(i < len(row) and row[i] == v)

    # ------------------------------------------------------------ device view
    def device_arrays(self, device) -> dict:
        """Torch views on ``device``; bitset tables as int32 words."""
        d = dict(
            adj_bits=bitset.to_tensor(self.adj_bits, device),
            gt_bits=bitset.to_tensor(bitset.lt_mask_table(self.n), device),
            degrees=torch.from_numpy(self.degrees).to(device),
            indptr=torch.from_numpy(self.indptr).to(device),
            indices=torch.from_numpy(self.indices).to(device),
        )
        if self.labels is not None:
            d["labels"] = torch.from_numpy(self.labels).to(device)
            d["label_bits"] = bitset.to_tensor(self.label_bits, device)
        return d

    # --------------------------------------------------------------- queries
    def bfs_hops(self, source: int, max_hops: int) -> np.ndarray:
        """[N] hop distance from ``source`` (-1 if > max_hops / unreachable)."""
        dist = np.full(self.n, -1, np.int32)
        dist[source] = 0
        frontier = np.array([source])
        for h in range(1, max_hops + 1):
            nxt = np.unique(np.concatenate(
                [self.neighbors(v) for v in frontier])) if len(frontier) else \
                np.empty(0, np.int32)
            nxt = nxt[dist[nxt] < 0]
            dist[nxt] = h
            frontier = nxt
            if not len(frontier):
                break
        return dist
