"""gSpan DFS codes and pattern-oriented expansion (paper §3.3, [62]) — the
port of ``repro.core.patterns``.

A pattern is a DFS code — a tuple of edges ``(i, j, li, lj)`` over discovery
ids — and a *group* is the pattern plus all of its embeddings (ordered tuples
of data vertices, one column per discovery id).  Pattern-oriented expansion
extends every embedding of a group by one rightmost-path edge; a child
pattern is kept only if its code is **minimal** (gSpan canonicality), which
yields Property 1 of the paper: all embeddings of a child pattern come from
exactly one parent group.

The code algebra, the groups and the embedding extension (numpy-vectorized
CSR gathering) are the reference's host code, copied.  The device does the
edge-existence checks: all rightmost-path backward probes of a group go
through **one** batched probe call (:func:`_edge_probe`) on ``device``
(``cuda`` unless the caller names another), either as a word gather into
the packed adjacency (``use_pallas=False``, the reference's numpy path as a
torch gather) or through the masked-intersection kernel with one-hot row
masks (``use_pallas=True``: the Hopper kernel on ``cuda``, its plain
version on the CPU).  Each probe ends in one device→host read of its
answer, as in the reference; :data:`reads` counts them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bitset
from .api import resolve_device
from .graph import GraphStore
from .labels import LABEL_FILTERS, LabelPredicate
from ..kernels import ops as kops

Code = Tuple[Tuple[int, int, int, int], ...]   # ((i, j, li, lj), ...)


def edge_key(e: Tuple[int, int, int, int]) -> tuple:
    """Sortable key implementing gSpan's edge order ≺ [62]: backward edges
    before forward (for extensions of the same prefix), backward by
    increasing target id, forward by *decreasing* source id (deeper
    rightmost-path vertices first), then by labels."""
    i, j, li, lj = e
    if j < i:                       # backward
        return (0, j, li, lj)
    return (1, -i, li, lj)          # forward


def code_key(code) -> tuple:
    return tuple(edge_key(e) for e in code)


# --------------------------------------------------------------- code algebra
def code_num_vertices(code: Code) -> int:
    return max(max(e[0], e[1]) for e in code) + 1


def code_vertex_labels(code: Code) -> List[int]:
    labels = [0] * code_num_vertices(code)
    for i, j, li, lj in code:
        labels[i] = li
        labels[j] = lj
    return labels


def code_rightmost_path(code: Code) -> List[int]:
    """Vertex ids on the rightmost path, root first."""
    rightmost = 0
    parent = {}
    for i, j, _, _ in code:
        if j > i:                      # forward edge
            parent[j] = i
            rightmost = max(rightmost, j)
    path = [rightmost]
    while path[-1] in parent:
        path.append(parent[path[-1]])
    return path[::-1]


def _pattern_adj(code: Code) -> List[set]:
    nv = code_num_vertices(code)
    adj = [set() for _ in range(nv)]
    for i, j, _, _ in code:
        adj[i].add(j)
        adj[j].add(i)
    return adj


def min_dfs_code(vertex_labels: Sequence[int],
                 edges: Sequence[Tuple[int, int]]) -> Code:
    """Canonical (minimal) DFS code of a small pattern graph.

    Recursive greedy construction: at every step only the extensions whose
    code-edge value is minimal (gSpan's ≺ order: backward before forward,
    backward by increasing target id, forward from deepest rightmost-path
    vertex, ties by new-vertex label) are explored; ties branch and the
    lexicographically smallest completed code wins.
    """
    nv = len(vertex_labels)
    adj = [set() for _ in range(nv)]
    eset = set()
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
        eset.add((min(a, b), max(a, b)))
    n_edges = len(eset)
    best: List[Optional[Code]] = [None]

    def edge_used(used, a, b):
        return (min(a, b), max(a, b)) in used

    def rec(code, order, pos, used, rmpath):
        # order: graph vertex per dfs id; pos: graph vertex -> dfs id
        if len(code) == n_edges:
            c = tuple(code)
            if best[0] is None or code_key(c) < code_key(best[0]):
                best[0] = c
            return
        if best[0] is not None and \
                code_key(code) > code_key(best[0][:len(code)]):
            return
        right = order[-1]
        # --- backward candidates from the rightmost vertex (smallest j wins)
        back = sorted(
            pos[v] for v in adj[right]
            if v in pos and pos[v] < len(order) - 1
            and not edge_used(used, right, v))
        if back:
            j = back[0]
            v = order[j]
            e = (len(order) - 1, j, vertex_labels[right], vertex_labels[v])
            rec(code + [e], order, pos,
                used | {(min(right, v), max(right, v))}, rmpath)
            return
        # --- forward candidates from the rightmost path, deepest first
        for u_id in reversed(rmpath):
            u = order[u_id]
            cands = [wv for wv in adj[u]
                     if wv not in pos and not edge_used(used, u, wv)]
            if not cands:
                continue
            lmin = min(vertex_labels[wv] for wv in cands)
            for wv in cands:
                if vertex_labels[wv] != lmin:
                    continue
                e = (u_id, len(order), vertex_labels[u], vertex_labels[wv])
                rec(code + [e], order + [wv], {**pos, wv: len(order)},
                    used | {(min(u, wv), max(u, wv))},
                    rmpath[:rmpath.index(u_id) + 1] + [len(order)])
            return          # only the deepest rmpath vertex may extend
        # disconnected remainder cannot happen for connected patterns

    # initial edges: minimal (la, lb) first
    lmin = min(min(vertex_labels[a], vertex_labels[b]) for a, b in eset)
    for a, b in eset:
        for u, v in ((a, b), (b, a)):
            if vertex_labels[u] != lmin:
                continue
            code0 = [(0, 1, vertex_labels[u], vertex_labels[v])]
            rec(code0, [u, v], {u: 0, v: 1}, {(min(u, v), max(u, v))}, [0, 1])
    return best[0]


def is_min_code(code: Code) -> bool:
    nv = code_num_vertices(code)
    labels = code_vertex_labels(code)
    edges = [(i, j) for i, j, _, _ in code]
    return min_dfs_code(labels, edges) == tuple(code)


# ------------------------------------------------------------------ the group
@dataclasses.dataclass
class PatternGroup:
    code: Code
    embeddings: np.ndarray        # [E, nv] data vertices, column = dfs id

    @property
    def num_edges(self) -> int:
        return len(self.code)

    def support(self) -> int:
        """Minimum image-based support [5]: min over pattern vertices of the
        number of distinct data vertices mapped to it."""
        if len(self.embeddings) == 0:
            return 0
        return min(len(np.unique(self.embeddings[:, c]))
                   for c in range(self.embeddings.shape[1]))


# ------------------------------------------------- vectorized data-graph ops
# per-(graph, edge-type restriction, device) bitsets for the probes, keyed
# by content fingerprint so repeated expand_group calls don't re-upload
# adjacency; the device is part of the key, so one graph mined on two
# devices in one process keeps one entry on each
_DEVICE_BITS_CACHE: Dict[str, tuple] = {}
_DEVICE_BITS_CAPACITY = 8

#: device→host reads of probe answers so far, one a probe
reads = 0


def reset_reads() -> None:
    global reads
    reads = 0


def _check_interpret(interpret: Optional[bool]) -> None:
    if interpret is not None:
        raise ValueError("interpret has no meaning here: the kernel path "
                         "follows the tensors' device")


def _device_bits_key(g: GraphStore, adj_key: str,
                     device: torch.device) -> str:
    return f"{g.fingerprint}:{adj_key}:{device}"


def _device_bits(g: GraphStore, adj: np.ndarray, adj_key: str,
                 device: torch.device) -> tuple:
    """``(adj, eye, ones)`` on ``device`` as int32 words: the adjacency
    ``[N, W]``, ``eye_table`` ``[N, W]`` and one all-ones column ``[1, W]``
    (``-1`` is the reference's ``0xFFFFFFFF``)."""
    key = _device_bits_key(g, adj_key, device)
    ent = _DEVICE_BITS_CACHE.pop(key, None)     # LRU: re-insert on hit
    if ent is None:
        w = bitset.num_words(g.n)
        ent = (bitset.to_tensor(adj, device),
               bitset.to_tensor(bitset.eye_table(g.n), device),
               torch.full((1, w), -1, dtype=torch.int32, device=device))
        while len(_DEVICE_BITS_CACHE) >= _DEVICE_BITS_CAPACITY:
            _DEVICE_BITS_CACHE.pop(next(iter(_DEVICE_BITS_CACHE)))
    _DEVICE_BITS_CACHE[key] = ent
    return ent


def _edge_probe(g: GraphStore, u: np.ndarray, v: np.ndarray,
                use_pallas: bool = False,
                interpret: Optional[bool] = None,
                predicate: Optional[LabelPredicate] = None,
                device=None) -> np.ndarray:
    """Batched edge-existence probe on ``device``: ``out[e] = (u[e], v[e])
    in E``, a numpy bool array.

    ``use_pallas=False``: the reference's word gather ``adj[u, v // 32] >>
    (v % 32) & 1``, as a torch gather.  ``use_pallas=True``:
    ``popcount(adj[u] & eye[v] & ones)`` through the masked-intersection
    kernel (rows = adjacency rows, row mask = one-hot target bitsets,
    single all-ones column).  Rows are padded to the next power of two, as
    in the reference.

    Under a predicate with ``edge_any_of``, both paths probe the
    type-restricted adjacency (DESIGN.md §12) — the restriction rides the
    same packed layout, so the kernel call shape is unchanged.
    """
    global reads
    _check_interpret(interpret)
    device = resolve_device(device)
    if predicate is not None and predicate.edge_any_of is not None:
        adj = predicate.adjacency(g)
        adj_key = ",".join(map(str, predicate.edge_any_of))
    else:
        adj, adj_key = g.adj_bits, ""
    e = len(u)
    if e == 0:
        return np.zeros(0, bool)
    adj_d, eye_d, ones = _device_bits(g, adj, adj_key, device)
    ep = 1 << max(3, (e - 1).bit_length()) if use_pallas else e
    pairs = np.zeros((2, ep), np.int64)
    pairs[0, :e], pairs[1, :e] = u, v
    up, vp = torch.from_numpy(pairs).to(device)
    if use_pallas:
        counts = kops.masked_intersect(adj_d[up], ones, eye_d[vp])
        hit = counts[:e, 0] > 0
    else:
        word = adj_d[up, vp // bitset.WORD_BITS]
        hit = ((word >> (vp % bitset.WORD_BITS)) & 1) > 0
    reads += 1
    return hit.cpu().numpy()


def _gather_neighbors(g: GraphStore, vs: np.ndarray):
    """All (row, neighbor, CSR slot) triples for sources ``vs`` — fully
    vectorized CSR.  The slot index maps each pair back to its
    ``edge_labels`` entry (edge-type filtering)."""
    counts = g.degrees[vs].astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int64))
    rows = np.repeat(np.arange(len(vs), dtype=np.int64), counts)
    starts = g.indptr[vs].astype(np.int64)
    offset = np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    slots = np.repeat(starts, counts) + offset
    return rows, g.indices[slots], slots


def seed_groups(g: GraphStore,
                predicate: Optional[LabelPredicate] = None
                ) -> Dict[Code, PatternGroup]:
    """All one-edge groups with minimal codes (paper Fig. 5 step 1):
    one embedding per *directed* edge whose code ``(0,1,la,lb)`` is minimal
    (``la <= lb``; both orientations when ``la == lb``).

    A predicate filters the seed edge list up front in every mode — the
    seed pass is host-side either way; the pushdown-vs-post distinction
    concerns the per-step extension hot path (:func:`expand_group`).
    """
    assert g.labels is not None
    if predicate is not None:
        predicate.validate(g, "pattern")
    ea = g.edge_array                       # both directions present
    la = g.labels[ea[:, 0]]
    lb = g.labels[ea[:, 1]]
    keep = la <= lb
    if predicate is not None:
        vm = predicate.vertex_mask(g)
        if vm is not None:
            keep &= vm[ea[:, 0]] & vm[ea[:, 1]]
        em = predicate.edge_mask_csr(g)     # aligned with edge_array rows
        if em is not None:
            keep &= em
    groups: Dict[Code, PatternGroup] = {}
    for key in np.unique(np.stack([la[keep], lb[keep]], 1), axis=0):
        m = keep & (la == key[0]) & (lb == key[1])
        code = ((0, 1, int(key[0]), int(key[1])),)
        groups[code] = PatternGroup(code, ea[m].astype(np.int32))
    return groups


def expand_group(g: GraphStore, group: PatternGroup,
                 use_pallas: bool = False,
                 interpret: Optional[bool] = None,
                 predicate: Optional[LabelPredicate] = None,
                 label_filter: str = "pushdown",
                 device=None
                 ) -> Tuple[Dict[Code, PatternGroup], int]:
    """Pattern-oriented expansion: extend every embedding by one
    rightmost-path edge; child groups keyed by (minimal) code.

    The rightmost-path edge-existence checks run on ``device`` (default
    ``cuda``; raises when no CUDA device is present and ``device`` is not
    given); ``use_pallas`` routes them through the masked-intersection
    kernel (:func:`_edge_probe`).  Results are byte-identical on every
    path and device.  ``interpret`` is accepted for the reference's
    signature and must be None.

    Label-constrained mining (DESIGN.md §12): ``edge_any_of`` restricts
    both the forward CSR gather and the backward bitset probes to allowed
    edge types (structural, every mode).  ``vertex_any_of`` has two
    placements: ``label_filter="pushdown"`` drops disallowed-label
    neighbors *before* child embeddings are materialized (the paper's
    proactive pruning — they never count as candidates), while ``"post"``
    materializes them, counts them, and then filters — the host-side
    baseline.  Child groups and supports are identical in both modes;
    only ``candidates_created`` (and the work it measures) differs.

    Returns (children, candidates_created) — the latter is the paper's cost
    metric (embeddings materialized, pre minimality filtering).
    """
    assert label_filter in LABEL_FILTERS, label_filter
    _check_interpret(interpret)
    device = resolve_device(device)
    vmask = predicate.vertex_mask(g) if predicate is not None else None
    emask = predicate.edge_mask_csr(g) if predicate is not None else None
    code, emb = group.code, group.embeddings
    nv = emb.shape[1]
    rmpath = code_rightmost_path(code)
    vlabels = code_vertex_labels(code)
    p_adj = _pattern_adj(code)
    right = rmpath[-1]
    created = 0
    children: Dict[Code, PatternGroup] = {}

    def _add(child_code: Code, child_emb: np.ndarray):
        nonlocal created
        created += len(child_emb)
        if len(child_emb) == 0 or not is_min_code(child_code):
            return
        child_emb = np.unique(child_emb, axis=0)
        if child_code in children:
            prev = children[child_code].embeddings
            children[child_code] = PatternGroup(
                child_code, np.unique(np.concatenate([prev, child_emb]), axis=0))
        else:
            children[child_code] = PatternGroup(child_code, child_emb)

    # --- backward extensions: rightmost vertex -> earlier rmpath vertex.
    # All candidate targets share one batched probe call (E × |targets|
    # pairs) instead of one call per rightmost-path vertex.
    back_js = [j for j in rmpath[:-1] if j not in p_adj[right]]
    if back_js and len(emb):
        hits = _edge_probe(
            g, np.tile(emb[:, right], len(back_js)),
            np.concatenate([emb[:, j] for j in back_js]),
            use_pallas, predicate=predicate,
            device=device).reshape(len(back_js), len(emb))
        for row, j in enumerate(back_js):
            child_code = tuple(code) + \
                ((right, j, vlabels[right], vlabels[j]),)
            _add(child_code, emb[hits[row]])

    # --- forward extensions from every rightmost-path vertex
    allowed_lw = (set(predicate.vertex_any_of)
                  if vmask is not None else None)
    for i in rmpath:
        rows, nbr, slots = _gather_neighbors(g, emb[:, i])
        if len(rows) == 0:
            continue
        if emask is not None:             # edge-type restriction: structural
            keep = emask[slots]
            rows, nbr = rows[keep], nbr[keep]
        if vmask is not None and label_filter == "pushdown":
            # predicate pushdown: disallowed-label neighbors never become
            # embeddings (and never count as candidates)
            keep = vmask[nbr]
            rows, nbr = rows[keep], nbr[keep]
        # exclude neighbors already used by the embedding
        if len(rows) == 0:
            continue
        used = (emb[rows] == nbr[:, None]).any(axis=1)
        rows, nbr = rows[~used], nbr[~used]
        if len(rows) == 0:
            continue
        nl = g.labels[nbr]
        for lw in np.unique(nl):
            m = nl == lw
            if allowed_lw is not None and int(lw) not in allowed_lw:
                # post mode only (pushdown filtered above): the host-side
                # baseline materializes these embeddings, counts them as
                # candidates, then drops them
                created += int(m.sum())
                continue
            child_code = tuple(code) + ((i, nv, vlabels[i], int(lw)),)
            child_emb = np.concatenate(
                [emb[rows[m]], nbr[m, None].astype(np.int32)], axis=1)
            _add(child_code, child_emb)

    return children, created
