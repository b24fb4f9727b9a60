"""Deterministic, shard-aware synthetic data pipelines — the co-workload
substrate that feeds :mod:`repro_torch.kernels.ops`' float kernels.

A copy of ``repro.data.pipeline`` (numpy only, built on the port's
:class:`~repro_torch.core.graph.GraphStore`): the same RNG calls in the
same order, so every batch is byte-equal to the reference's.  Outputs stay
numpy; the caller moves them to its device.

Every batch is a pure function of ``(seed, step, shard)`` — restart-safe
(resume at step N reproduces the exact stream, so checkpoint/restart is
bitwise-consistent) and host-local (each data shard draws only its slice,
no cross-host shuffle service needed at 1000+ nodes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..core.graph import GraphStore


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


class TokenStream:
    """Synthetic LM batches with learnable structure (Zipf-ish unigram +
    short-range copy pattern, so a real model visibly reduces loss)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.shard, self.num_shards = seed, shard, num_shards
        assert batch % num_shards == 0
        self.local_batch = batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        r = _rng(self.seed, step, self.shard)
        zipf = np.clip(r.zipf(1.3, size=(self.local_batch, self.seq)),
                       1, self.vocab) - 1
        # copy pattern: second half repeats first half with small noise
        half = self.seq // 2
        tokens = zipf
        tokens[:, half:half * 2] = tokens[:, :half]
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = 0
        return {"tokens": tokens.astype(np.int32),
                "targets": targets.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class RecsysStream:
    def __init__(self, n_sparse: int, n_dense: int, vocab: int, batch: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.n_sparse, self.n_dense = n_sparse, n_dense
        self.vocab, self.batch = vocab, batch
        self.seed, self.shard = seed, shard
        self.local_batch = batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        r = _rng(self.seed, step, self.shard)
        ids = r.integers(0, self.vocab,
                         size=(self.local_batch, self.n_sparse))
        dense = r.normal(size=(self.local_batch, self.n_dense))
        # clickiness depends on a hidden linear model → learnable
        w = _rng(self.seed, 0, 10 ** 6).normal(size=self.n_dense)
        p = 1 / (1 + np.exp(-(dense @ w) * 0.5))
        labels = r.random(self.local_batch) < p
        return {"sparse_ids": ids.astype(np.int32),
                "dense": dense.astype(np.float32),
                "labels": labels.astype(np.float32)}


@dataclasses.dataclass
class SampledSubgraph:
    """Fixed-size padded output of the neighbor sampler."""
    features: np.ndarray      # [N_pad, F]
    positions: np.ndarray     # [N_pad, 3]
    edge_src: np.ndarray      # [E_pad]
    edge_dst: np.ndarray      # [E_pad]
    targets: np.ndarray       # [N_pad, O]
    node_mask: np.ndarray     # [N_pad]


class NeighborSampler:
    """GraphSAGE-style fanout sampler (e.g. 15-10) with fixed padded shapes.

    Seeds are drawn per (step, shard); each hop uniformly samples up to
    ``fanout[h]`` neighbors per frontier node (with replacement when the
    degree is smaller).  Output arrays are padded to the static maximum so
    the jitted train step never recompiles; padding edges point at a dummy
    node whose mask zeroes its loss contribution.
    """

    def __init__(self, graph: GraphStore, batch_nodes: int,
                 fanout: Sequence[int], d_feat: int, d_out: int = 1,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.g = graph
        self.batch_nodes = batch_nodes // num_shards
        self.fanout = list(fanout)
        self.d_feat, self.d_out = d_feat, d_out
        self.seed, self.shard = seed, shard
        n_pad = frontier = self.batch_nodes
        e_pad = 0
        for f in self.fanout:
            e_h = frontier * f          # one edge per sampled neighbor
            e_pad += e_h
            n_pad += e_h
            frontier = e_h
        self.n_pad, self.e_pad = n_pad + 1, e_pad       # +1 dummy node

    def sample(self, step: int) -> SampledSubgraph:
        g, r = self.g, _rng(self.seed, step, self.shard)
        dummy = self.n_pad - 1
        seeds = r.integers(0, g.n, size=self.batch_nodes)
        node_ids = [seeds]
        edges_src, edges_dst = [], []
        frontier_ids = seeds
        frontier_slots = np.arange(self.batch_nodes, dtype=np.int64)
        total = self.batch_nodes
        for f in self.fanout:
            deg = g.degrees[frontier_ids].astype(np.int64)
            pick = (r.random((len(frontier_ids), f)) *
                    np.maximum(deg, 1)[:, None]).astype(np.int64)
            base = g.indptr[frontier_ids].astype(np.int64)[:, None]
            nbrs = g.indices[np.minimum(base + pick, len(g.indices) - 1)]
            valid = np.repeat(deg > 0, f)
            child_slots = total + np.arange(len(frontier_ids) * f)
            parent_slots = np.repeat(frontier_slots, f)
            edges_src.append(np.where(valid, child_slots, dummy))
            edges_dst.append(parent_slots)
            node_ids.append(np.where(valid, nbrs.ravel(), 0))
            frontier_ids = np.where(valid, nbrs.ravel(), 0)
            frontier_slots = child_slots
            total += child_slots.size
        ids = np.concatenate(node_ids)
        n_real = len(ids)
        rr = _rng(self.seed, step, self.shard + 1000)
        features = np.zeros((self.n_pad, self.d_feat), np.float32)
        features[:n_real] = rr.normal(size=(n_real, self.d_feat)) * 0.1
        features[:n_real, 0] += (ids % 5 == 0)            # learnable signal
        positions = np.zeros((self.n_pad, 3), np.float32)
        positions[:n_real] = rr.normal(size=(n_real, 3))
        targets = np.zeros((self.n_pad, self.d_out), np.float32)
        targets[:n_real] = (ids[:, None] % 5 == 0)
        mask = np.zeros(self.n_pad, np.float32)
        mask[:self.batch_nodes] = 1.0                     # loss on seeds only
        src = np.concatenate(edges_src)[:self.e_pad]
        dst = np.concatenate(edges_dst)[:self.e_pad]
        return SampledSubgraph(features, positions,
                               src.astype(np.int32), dst.astype(np.int32),
                               targets, mask)


def molecule_batch(batch: int, n_atoms: int, n_edges: int, d_feat: int,
                   seed: int, step: int) -> Dict[str, np.ndarray]:
    """Batched small molecular graphs flattened into one disjoint graph."""
    r = _rng(seed, step, 0)
    n = batch * n_atoms
    positions = r.normal(size=(n, 3)).astype(np.float32) * 2
    features = r.normal(size=(n, d_feat)).astype(np.float32)
    src = np.concatenate([
        r.integers(0, n_atoms, n_edges) + b * n_atoms for b in range(batch)])
    dst = np.concatenate([
        r.integers(0, n_atoms, n_edges) + b * n_atoms for b in range(batch)])
    graph_ids = np.repeat(np.arange(batch), n_atoms)
    targets = r.normal(size=(batch, 1)).astype(np.float32)
    return dict(features=features, positions=positions,
                edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
                graph_ids=graph_ids.astype(np.int32),
                num_graphs=batch, targets=targets)
