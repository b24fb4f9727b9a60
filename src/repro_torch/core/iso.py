"""Top-k subgraph isomorphism on the engine (paper §4.3, Ullmann [54] +
Gupta-style index [23]) — the port of ``repro.core.iso``.

Finds the k highest-scored subgraphs of a labeled data graph isomorphic to a
query graph, score = Σ degree of matched data vertices.  The bijection
preserves labels, and adjacency *iff* (induced isomorphism).

State layout (``S = nq + 2`` int32): ``mapping[nq]`` (data vertex per query
vertex, -1 unmatched), ``depth`` (matched count), ``score``.

Targeted expansion: the candidate set for the next query vertex ``j`` is a
bitset intersection over the matched query vertices ``i`` — ``adj(map[i])``
when ``(i,j) ∈ E_q`` and its complement otherwise — AND the label bitset of
``j``'s label class, minus used vertices.  A :class:`~repro_torch.core.
labels.LabelPredicate` pushes down into the same product: the allowed-vertex
bitset seeds the constraint mask and ``edge_any_of`` swaps in the
type-restricted adjacency.

Pruning/prioritization: ``index[v, l, h]`` = max degree over label-``l``
vertices exactly ``h`` hops from ``v`` gives ``u(s) = Σ_{unmatched t}
index[seed, label_q(t), hop_q(t)]``; priority is ``(edgeCount, score + u)``
as one int32 key.

The reference's bitset words are ``uint32``, the port's ``int32``: the bits
are the same (``0xFFFFFFFF`` is ``-1``), and every priority, bound and
state word stays ``int32``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitset
from .api import NEG, SubgraphComputation, resolve_device
from .graph import GraphStore
from .labels import LABEL_FILTERS, LabelPredicate
from ..kernels import ops as kops

CAND_PATHS = ("batched", "vmap", "map")


# ----------------------------------------------------------------- the index
def build_iso_index(graph: GraphStore, max_hops: int,
                    predicate: Optional[LabelPredicate] = None,
                    device=None) -> np.ndarray:
    """``index[v, l, h]`` = max degree over label-l vertices exactly h hops
    from v (h in 1..max_hops; h index 0 is hop 1).  Shape [N, L, H], int32,
    the reference's array byte for byte.

    Built on ``device`` (default ``cuda``) with one dense ``[N, N]`` product
    a hop.  Its operands are 0/1 in bfloat16 and only ``> 0`` is read: a
    0/1 product is exact and a sum of non-negative terms that is positive
    cannot round to 0, so the result is exact in any precision of the sum.
    Per hop and label, the max runs over that label's columns only, so a
    hop reads the ``[N, N]`` level once over all labels.

    With a predicate that restricts edge types (``edge_any_of``), hops are
    counted on the restricted adjacency; degrees stay full-graph (the
    reference's docstring gives the reasons).
    """
    if graph.labels is None:
        raise ValueError("iso index requires a labeled graph")
    device = resolve_device(device)
    n = graph.n
    n_labels = int(graph.labels.max()) + 1
    ea = graph.edge_array
    if predicate is not None and predicate.edge_any_of is not None:
        ea = ea[predicate.edge_mask_csr(graph)]
    ea = torch.from_numpy(ea.astype(np.int64)).to(device)
    adj = torch.zeros((n, n), dtype=torch.bfloat16, device=device)
    adj[ea[:, 0], ea[:, 1]] = 1
    deg = torch.from_numpy(graph.degrees).to(device)
    labels = np.asarray(graph.labels)
    cols = [torch.from_numpy(np.nonzero(labels == l)[0]).to(device)
            for l in range(n_labels)]

    index = torch.zeros((n, n_labels, max_hops), dtype=torch.int32,
                        device=device)
    reached = torch.eye(n, dtype=torch.bool, device=device)  # within h-1 hops
    frontier = torch.eye(n, dtype=torch.bfloat16, device=device)
    for h in range(max_hops):
        nxt = (frontier @ adj) > 0
        level = nxt & ~reached                        # exactly h+1 hops away
        reached |= nxt
        del nxt
        frontier = level.to(torch.bfloat16)
        for l, c in enumerate(cols):
            if len(c):
                index[:, l, h] = torch.where(level[:, c], deg[c], 0).amax(1)
        del level
    return index.cpu().numpy()


def _query_order(q_edges: Sequence[Tuple[int, int]], nq: int) -> List[int]:
    """BFS order from query vertex 0 so every matched vertex has a matched
    neighbor (connected expansion)."""
    adj = [[] for _ in range(nq)]
    for a, b in q_edges:
        adj[a].append(b)
        adj[b].append(a)
    order, seen = [0], {0}
    i = 0
    while len(order) < nq:
        if i >= len(order):                      # disconnected query
            rest = [v for v in range(nq) if v not in seen]
            order.append(rest[0])
            seen.add(rest[0])
            continue
        for u in sorted(adj[order[i]]):
            if u not in seen:
                order.append(u)
                seen.add(u)
        i += 1
    return order


def _query_hops(q_edges, nq) -> np.ndarray:
    """Hop distance from query vertex 0 inside the query graph."""
    adj = [[] for _ in range(nq)]
    for a, b in q_edges:
        adj[a].append(b)
        adj[b].append(a)
    dist = np.full(nq, nq, np.int32)
    dist[0] = 0
    frontier = [0]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for v in frontier:
            for u in adj[v]:
                if dist[u] > d:
                    dist[u] = d
                    nxt.append(u)
        frontier = nxt
    return dist


def make_iso_computation(graph: GraphStore,
                         q_edges: Sequence[Tuple[int, int]],
                         q_labels: Sequence[int],
                         index: np.ndarray,
                         induced: bool = True,
                         use_pallas: bool = False,
                         interpret: Optional[bool] = None,
                         cand_path: str = "batched",
                         predicate: Optional[LabelPredicate] = None,
                         label_filter: str = "pushdown",
                         device=None) -> SubgraphComputation:
    """The iso :class:`SubgraphComputation` on ``device`` (default
    ``cuda``; raises when no CUDA device is present and ``device`` is not
    given).  ``index`` is :func:`build_iso_index`'s array (the reference's
    comes across as it is).

    Candidate generation, byte-identical on every path:

    * ``use_pallas=True`` (the reference's name; it picks an algorithm,
      not a device) — the batched constraint product, then
      :func:`repro_torch.kernels.ops.masked_intersect` of the rows' label
      bitsets, masked by their constraint masks, against the ``eye_table``
      columns: the Hopper kernel's masked form for tensors on ``cuda``, its
      plain version on the CPU (``cand_path`` is ignored);
    * ``cand_path="batched"`` (default) — the same product, then the bits
      unpacked (the kernel's reference path);
    * ``cand_path="vmap"`` — the per-state loop form, the batch dimension
      written out;
    * ``cand_path="map"`` — the per-state loop run one state at a time.

    ``interpret`` is accepted for the reference's signature and must be
    None: the kernel path follows the tensors' device.

    Label predicates: ``q_any_of`` and ``edge_any_of`` change matching and
    apply in both filter modes; ``vertex_any_of`` is a filter placed by
    ``label_filter`` — ``"pushdown"`` seeds the kernel's row mask with the
    allowed-vertex bitset and restricts the priority index to allowed
    labels; ``"post"`` filters the materialized candidate grid.  Complete
    runs return the same top-k in both modes.
    """
    if interpret is not None:
        raise ValueError("interpret has no meaning here: the kernel path "
                         "follows the tensors' device")
    if cand_path not in CAND_PATHS:
        raise ValueError(f"cand_path must be one of {CAND_PATHS}, got "
                         f"{cand_path!r}")
    if label_filter not in LABEL_FILTERS:
        raise ValueError(f"label_filter must be one of {LABEL_FILTERS}, "
                         f"got {label_filter!r}")
    if graph.labels is None:
        raise ValueError("iso requires a labeled graph")
    if predicate is not None:
        predicate.validate(graph, "iso", nq=len(q_labels))
    device = resolve_device(device)
    n = graph.n
    nq = len(q_labels)
    S = nq + 2
    w = bitset.num_words(n)

    # reorder query vertices so expansion is always connected
    order = _query_order(q_edges, nq)
    inv = {v: i for i, v in enumerate(order)}
    q_labels_o = np.asarray([q_labels[v] for v in order], np.int32)
    q_adj_o = np.zeros((nq, nq), bool)
    for a, b in q_edges:
        q_adj_o[inv[a], inv[b]] = q_adj_o[inv[b], inv[a]] = True
    hops_o = _query_hops(q_edges, nq)[order]       # distance from seed vertex

    # per-query-vertex label classes (exact q_labels when no q_any_of),
    # in expansion order
    if predicate is not None and predicate.q_any_of is not None:
        classes_o = [tuple(predicate.q_any_of[v]) for v in order]
    else:
        classes_o = [(int(l),) for l in q_labels_o]
    # the global vertex predicate, as packed bitset + boolean vector
    allowed_vbits = predicate.vertex_bits(graph) if predicate else None
    allowed_vmask = predicate.vertex_mask(graph) if predicate else None
    pushdown = label_filter == "pushdown"

    max_hops = index.shape[2]
    hops_clamped = np.clip(hops_o, 1, max_hops)
    # ub_rest[v, d] = Σ_{t >= d} max_{l ∈ L_t} index[v, l, hop(t)] (seed = v)
    # where L_t is slot t's label class — under pushdown intersected with
    # the allowed-label set (a tighter bound, still sound); the post
    # baseline keeps the unrestricted classes
    per_t = np.zeros((n, nq), np.int32)
    for t in range(nq):
        lt = classes_o[t]
        if pushdown and predicate is not None and \
                predicate.vertex_any_of is not None:
            lt = tuple(l for l in lt if l in predicate.vertex_any_of)
        if lt:
            per_t[:, t] = index[:, list(lt), hops_clamped[t] - 1].max(axis=1)
    suffix = np.cumsum(per_t[:, ::-1], axis=1)[:, ::-1]     # [N, nq]
    ub_rest = np.concatenate(
        [suffix, np.zeros((n, 1), np.int32)], axis=1)       # [N, nq+1]

    # constraint-product adjacency: restricted to allowed edge types when
    # the predicate carries edge_any_of (structural; both filter modes)
    adjc = predicate.adjacency(graph) if predicate is not None \
        else graph.adj_bits
    # class bitsets: the kernel's per-row label operand, one row per slot
    class_bits = np.stack([
        np.bitwise_or.reduce(graph.label_bits[list(cls)], axis=0)
        for cls in classes_o])                              # [nq, W]

    def on_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    deg = on_device(graph.degrees.astype(np.int32))
    adj_bits = bitset.to_tensor(adjc, device)                # [N, W]
    class_bits_d = bitset.to_tensor(class_bits, device)      # [nq, W]
    ub_rest_d = on_device(ub_rest.astype(np.int32))          # [N, nq+1]
    q_adj_d = on_device(q_adj_o)                             # [nq, nq]
    eye_bits = bitset.to_tensor(bitset.eye_table(n), device)  # [N, W]
    allowed_vbits_d = (bitset.to_tensor(allowed_vbits, device)
                       if allowed_vbits is not None else None)
    allowed_vmask_d = (on_device(allowed_vmask)
                       if allowed_vmask is not None else None)

    max_deg = int(graph.degrees.max())
    base = int(2 * nq * max_deg + max_deg + 2)     # lexicographic stride
    if (nq + 1) * base >= 2 ** 31:
        raise ValueError(f"int32 priority keys: (nq + 1) * base = "
                         f"{(nq + 1) * base} >= 2**31")
    full_word = -1                                 # 0xFFFFFFFF as int32

    def _cand_parts(states):
        """Batched candidate generation for a dequeued batch: per-row label
        bitsets and constraint masks (adjacency/complement products ∧
        ~used), one gather + AND a constraint slot.  The candidate set of
        state ``b`` is ``lbl[b] & mask[b]``; the two parts are the rows and
        row mask of the masked-intersection kernel."""
        b = states.shape[0]
        mapping = states[:, :nq]                        # [B, nq]
        d = states[:, nq]                               # [B]
        j = torch.clamp(d, max=nq - 1).long()
        lbl = class_bits_d[j]                           # [B, W]
        if pushdown and allowed_vbits_d is not None:
            # predicate pushdown: the allowed-vertex bitset seeds the
            # per-row kernel mask, so label-infeasible candidates are
            # culled inside the masked intersection
            mask = allowed_vbits_d.expand(b, w)
        else:
            mask = torch.full((b, w), full_word, dtype=torch.int32,
                              device=states.device)
        used = torch.zeros((b, w), dtype=torch.int32, device=states.device)
        for i in range(nq):                             # static: nq small
            mi = torch.clamp(mapping[:, i], min=0).long()   # [B]
            row = adj_bits[mi]                          # [B, W]
            need = q_adj_d[i][j]                        # [B] (symmetric)
            con = torch.where(need[:, None], row, ~row) if induced else \
                torch.where(need[:, None], row, full_word)
            active = (i < d)[:, None]                   # [B, 1]
            mask = torch.where(active, mask & con, mask)
            used = torch.where(active, used | eye_bits[mi], used)
        mask = mask & ~used
        return lbl, torch.where((d < nq)[:, None], mask, 0)

    def _cand_bits(states):
        """The per-state loop form of :func:`_cand_parts` (the reference's
        ``_cand_bits`` under ``vmap``, the batch dimension written out):
        the label bitset is the accumulator, and used vertices are set bit
        by bit."""
        b = states.shape[0]
        mapping = states[:, :nq]
        d = states[:, nq]
        j = torch.clamp(d, max=nq - 1).long()
        acc = class_bits_d[j]                           # [B, W]
        if pushdown and allowed_vbits_d is not None:
            acc = acc & allowed_vbits_d
        used = torch.zeros((b, w), dtype=torch.int32, device=states.device)
        for i in range(nq):
            mi = torch.clamp(mapping[:, i], min=0)
            row = adj_bits[mi.long()]
            need = q_adj_d[i][j]
            constraint = torch.where(need[:, None], row, ~row) if induced \
                else torch.where(need[:, None], row, full_word)
            active = (i < d)[:, None]
            acc = torch.where(active, acc & constraint, acc)
            used = torch.where(active, bitset.set_bit(used, mi), used)
        acc = acc & ~used
        return torch.where((d < nq)[:, None], acc, 0)

    def init_frontier():
        # seed = vertices matching slot 0's label class; the vertex
        # predicate applies here in both filter modes (a disallowed seed
        # could complete into a violating result)
        seed_ok = np.isin(np.asarray(graph.labels), list(classes_o[0]))
        if allowed_vmask is not None:
            seed_ok &= allowed_vmask
        seeds = np.nonzero(seed_ok)[0]
        n0 = len(seeds)
        states = np.full((n0, S), -1, np.int32)
        states[:, 0] = seeds
        states[:, nq] = 1                                    # depth
        sc = graph.degrees[seeds].astype(np.int32)
        states[:, nq + 1] = sc
        ub = (sc + ub_rest[seeds, 1]).astype(np.int32)
        prio = (1 * base + ub).astype(np.int32)
        return on_device(states), on_device(prio), on_device(ub)

    def score_children(states):
        if use_pallas:
            lbl, mask = _cand_parts(states)
            in_cand = kops.masked_intersect(
                lbl.contiguous(), eye_bits, mask.contiguous()) > 0   # [B, N]
        elif cand_path == "batched":
            lbl, mask = _cand_parts(states)
            in_cand = bitset.to_bool(lbl & mask, n)                  # [B, N]
        elif cand_path == "vmap":
            in_cand = bitset.to_bool(_cand_bits(states), n)          # [B, N]
        else:  # "map": one state at a time (the pre-batching loop form)
            cand = torch.cat([_cand_bits(states[r:r + 1])
                              for r in range(states.shape[0])])
            in_cand = bitset.to_bool(cand, n)                        # [B, N]
        if not pushdown and allowed_vmask_d is not None:
            # host-side-filter baseline: the unconstrained candidate grid
            # was materialized above; the predicate lands only now
            in_cand = in_cand & allowed_vmask_d[None, :]
        d = states[:, nq]
        score = states[:, nq + 1]
        seed = torch.clamp(states[:, 0], min=0).long()
        nd = torch.clamp(d + 1, max=nq)
        rest = ub_rest_d[seed, nd.long()]                    # [B]
        child_score = score[:, None] + deg[None, :]
        child_ub = child_score + rest[:, None]
        child_prio = nd[:, None] * base + child_ub
        invalid = ~in_cand
        return (torch.where(invalid, NEG, child_prio),
                torch.where(invalid, NEG, child_ub))

    def materialize(states, actions):
        d = states[:, nq].long()
        row = torch.arange(states.shape[0], device=states.device)
        actions = actions.to(torch.int32)
        out = states.clone()
        out[row, d] = actions
        out[:, nq] += 1
        out[:, nq + 1] += deg[actions.long()]
        return out

    def result_key(states):
        complete = states[:, nq] == nq
        return torch.where(complete, states[:, nq + 1], NEG)

    def upper_bound(states):
        d = states[:, nq]
        seed = torch.clamp(states[:, 0], min=0).long()
        return states[:, nq + 1] + ub_rest_d[seed, torch.clamp(
            d, max=nq).long()]

    def describe(state_row: np.ndarray) -> list:
        m = list(map(int, state_row[:nq]))
        return [m[inv[v]] for v in range(nq)]    # original query order

    return SubgraphComputation(
        name="iso", state_width=S, num_actions=n,
        init_frontier=init_frontier, score_children=score_children,
        materialize=materialize, result_key=result_key,
        upper_bound=upper_bound, describe=describe, device=device)
