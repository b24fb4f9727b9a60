"""Batched prioritized subgraph-expansion engine (paper Algorithm 1), on
PyTorch.

The port of ``repro.core.engine`` for one device at ``steps_per_sync=1``.
One *super-step* (:meth:`Engine._step_impl`) is the reference's, operation
for operation:

1. **dequeue** the ``B`` highest-priority states from the device pool;
2. **result insertion** into the top-k result set (:func:`merge_topk`);
3. **pruning** against the k-th result key (dequeued states and children);
4. **targeted expansion** — ``score_children`` over the ``[B, A]`` grid,
   greedy parent admission under the materialization budget ``M``;
5. **insert** — pool ∪ children ∪ deferred parents merge-sorted by
   priority; the top ``C`` stay on the device, the rest spill to the
   virtual priority queue.

Every answer and counter is byte-identical to the reference, which decides
how each selection is written here: ``jax.lax.top_k`` and
``jnp.argsort(descending=True)`` break ties by lower index, and
``torch.topk`` does not, so every selection is a stable descending
``torch.sort`` followed by a slice.

The host reads one small stats tensor per step (one device-to-host sync)
and ships only the valid prefix of the overflow block to the queue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .api import NEG, SubgraphComputation, resolve_device
from .vpq import VirtualPriorityQueue
from repro_torch.obs import NOOP, Observability

_STAT_NAMES = ("expanded", "created", "pruned", "pool_occupancy",
               "threshold", "overflow")


@dataclasses.dataclass
class EngineConfig:
    """The reference's ``EngineConfig``, field for field, so a config can be
    carried across.  This slice runs one device at ``steps_per_sync=1``;
    :class:`Engine` raises ``NotImplementedError`` for a value it does not
    support, naming the ROADMAP item that brings it."""
    k: int = 1                    # result set size
    batch: int = 64               # B: states dequeued per super-step
    pool_capacity: int = 4096     # C: device-resident priority pool slots
    max_children: Optional[int] = None  # M: materialization budget (>= A)
    max_steps: int = 100_000
    spill: str = "host"           # VPQ backing: "host" | "disk" | "none"
    spill_dir: Optional[str] = None
    shards: int = 1               # sharded engine: ROADMAP Queue 1, item 12
    steps_per_sync: int = 1       # macro-steps: ROADMAP Queue 1, item 4
    overflow_accum: Optional[int] = None   # macro-step accumulator (item 4)
    sync_every: int = 1           # stale bound exchange: item 12
    record_bound_trace: bool = False       # sharded test hook: item 12
    checkpoint_every: int = 0     # durable runs: ROADMAP Queue 1, item 9
    checkpoint_dir: Optional[str] = None
    use_pallas: bool = False      # the kernel follows the device (item 3)
    interpret: Optional[bool] = None
    observe: bool = False         # spans and metrics (repro_torch.obs)
    observability: Optional[object] = None


@dataclasses.dataclass
class EngineResult:
    result_states: np.ndarray     # [k, S]
    result_keys: np.ndarray       # [k] (NEG = empty slot)
    steps: int
    candidates: int               # subgraphs materialized (paper metric 1)
    expanded: int                 # subgraphs actually expanded
    pruned: int                   # dequeued states dropped by dominance
    spilled: int
    refilled: int
    rebalanced: int = 0           # spilled entries moved across shards
    late_pruned: int = 0          # dominated entries dropped at VPQ refill
    syncs: int = 0                # bound-exchange collectives (0 unsharded)
    host_syncs: int = 0           # host-device round-trips (== steps)
    per_shard: Optional[dict] = None


@dataclasses.dataclass
class EngineState:
    """Resumable per-query engine state; tensors live on the engine's
    device.  :meth:`Engine.step` maps it to the next state in place."""

    pool_states: torch.Tensor     # [C, S]
    pool_prio: torch.Tensor       # [C]
    pool_ub: torch.Tensor         # [C]
    result_states: torch.Tensor   # [k, S]
    result_keys: torch.Tensor     # [k]
    vpq: VirtualPriorityQueue
    steps: int = 0
    candidates: int = 0
    expanded: int = 0
    pruned: int = 0
    refilled: int = 0
    syncs: int = 0
    host_syncs: int = 0
    threshold: int = int(NEG)
    pool_occupancy: int = 0
    done: bool = False            # pool and VPQ both drained


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting ``x`` descending, ties by lower index — the order of
    ``jax.lax.top_k`` and ``jnp.argsort(descending=True)``."""
    return torch.sort(x, descending=True, stable=True).indices


def merge_topk(states: torch.Tensor, keys: torch.Tensor, k: int):
    """Canonical top-k selection over result candidates: key descending,
    ties broken by the state words lexicographically ascending (signed
    int32 order, word 0 most significant), duplicate (state, key) pairs
    collapsed — ``repro.core.engine.merge_topk``, byte for byte.

    The reference orders the ``R`` candidates with one ``jnp.lexsort`` over
    the key and all ``S`` state words; chained stable sorts would take
    ``S + 1`` launches.  Here every pair of rows is compared at the first
    word where the two differ (then by key, then by original index, which
    is the lexsort's stability), and each row's rank is the number of rows
    that precede it: an ``[R, R, S]`` comparison in a handful of launches.
    """
    r = states.shape[0]
    idx = torch.arange(r, device=states.device)
    differ = states[:, None, :] != states[None, :, :]           # [R, R, S]
    first = torch.argmax(differ.to(torch.uint8), dim=-1, keepdim=True)
    wi = torch.take_along_dim(states[:, None, :], first, dim=-1)[..., 0]
    wj = torch.take_along_dim(states[None, :, :], first, dim=-1)[..., 0]
    ki, kj = keys[:, None], keys[None, :]
    by_key = (ki < kj) | ((ki == kj) & (idx[:, None] < idx[None, :]))
    before = torch.where(differ.any(dim=-1), wi < wj, by_key)  # i before j
    rank = before.sum(dim=0)                        # rows preceding each row
    lex = torch.empty_like(idx)
    lex[rank] = idx
    ss, kk = states[lex], keys[lex]
    dup = torch.cat([
        torch.zeros((1,), dtype=torch.bool, device=states.device),
        (ss[1:] == ss[:-1]).all(dim=1) & (kk[1:] == kk[:-1])])
    kk = torch.where(dup, NEG, kk)
    top = _desc_order(kk)[:k]
    top_keys = kk[top]
    top_states = torch.where((top_keys > NEG)[:, None], ss[top], 0)
    return top_states, top_keys


class Engine:
    """Runs one :class:`SubgraphComputation` to completion (or stepwise) on
    the computation's device."""

    def __init__(self, comp: SubgraphComputation, config: EngineConfig):
        unsupported = [
            (config.steps_per_sync > 1, "steps_per_sync > 1 (macro-steps) "
             "is not ported yet: ROADMAP Queue 1, item 4"),
            (config.shards > 1 or config.sync_every > 1
             or config.record_bound_trace, "the sharded engine (shards, "
             "sync_every, record_bound_trace) is not ported yet: ROADMAP "
             "Queue 1, item 12"),
            (config.checkpoint_every > 0 or config.checkpoint_dir is not None,
             "checkpointing is not ported yet: ROADMAP Queue 1, item 9"),
            (config.use_pallas or config.interpret is not None,
             "use_pallas/interpret have no meaning here: the kernel path "
             "follows the tensors' device (ROADMAP Queue 1, item 3)"),
        ]
        for bad, why in unsupported:
            if bad:
                raise NotImplementedError(f"EngineConfig: {why}")
        self.comp = comp
        self.cfg = config
        self.device = resolve_device(comp.device)
        a = comp.num_actions
        self.M = max(config.max_children or 0, a)
        self.B = config.batch
        self.C = config.pool_capacity
        self.S = comp.state_width
        self.k = config.k
        if config.observe:
            self.obs = config.observability or Observability()
        else:
            self.obs = NOOP
        obs = self.obs
        self._span = obs.tracer.span
        self._m_steps = obs.counter(
            "engine_steps_total", "engine super-steps completed")
        self._m_host_syncs = obs.counter(
            "engine_host_syncs_total", "host-device round-trips")
        self._m_candidates = obs.counter(
            "engine_candidates_total", "subgraphs materialized")
        self._m_expanded = obs.counter(
            "engine_expanded_total", "subgraphs expanded")
        self._m_pruned = obs.counter(
            "engine_pruned_total", "dequeued states dropped by dominance")
        self._m_refilled = obs.counter(
            "engine_refilled_total", "pool entries refilled from spill")
        self._g_occupancy = obs.gauge(
            "engine_pool_occupancy", "live device-pool entries")
        self._g_threshold = obs.gauge(
            "engine_threshold", "current dominance threshold (k-th key)")
        self._h_step = obs.histogram(
            "engine_step_seconds", "wall time per engine step() call")

    # ------------------------------------------------------------------ step
    def _step_impl(self, pool_states, pool_prio, pool_ub,
                   result_states, result_keys):
        """One super-step; returns the new pool and result set, the overflow
        block (sorted by descending priority, so its valid rows are a
        prefix) and the step's stats as one int64 tensor."""
        comp, B, M, k = self.comp, self.B, self.M, self.k
        A = comp.num_actions

        # 1. dequeue top-B
        idx_b = _desc_order(pool_prio)[:B]
        prio_b = pool_prio[idx_b]
        valid_b = prio_b > NEG
        states_b = pool_states[idx_b]
        ub_b = pool_ub[idx_b]
        pool_prio = pool_prio.index_fill(0, idx_b, NEG)

        # 2. result insertion (Alg. 1 lines 6-10), canonical tie-break
        rkey_b = torch.where(valid_b, comp.result_key(states_b), NEG)
        result_states, result_keys = merge_topk(
            torch.cat([result_states, states_b]),
            torch.cat([result_keys, rkey_b]), k)

        # 3. dominance threshold: the k-th entry (NEG while R not full)
        threshold = result_keys[k - 1]
        expand_b = valid_b & (ub_b >= threshold)
        pruned = (valid_b & ~expand_b).sum()

        # 4. targeted expansion: score the [B, A] child grid
        child_prio, child_ub = comp.score_children(states_b)
        keep = expand_b[:, None] & (child_prio > NEG) & (child_ub >= threshold)

        # greedy parent admission: expand parents (already sorted by
        # priority) while the cumulative child count fits M; the rest
        # re-enter the pool unexpanded
        fits = torch.cumsum(keep.sum(dim=1), dim=0) <= M
        admitted = expand_b & fits
        deferred = valid_b & expand_b & ~fits
        keep = keep & admitted[:, None]

        flat_prio = torch.where(keep, child_prio, NEG).reshape(B * A)
        top_ci = _desc_order(flat_prio)[:M]
        top_cp = flat_prio[top_ci]
        sel_valid = top_cp > NEG
        sel_parent = top_ci // A
        sel_action = top_ci % A
        child_states = comp.materialize(states_b[sel_parent], sel_action)
        child_states = torch.where(sel_valid[:, None], child_states, 0)
        child_ub_sel = torch.where(sel_valid, child_ub.reshape(B * A)[top_ci],
                                   NEG)

        # 5. merge-sort insert: pool ∪ children ∪ deferred parents
        pool_states, pool_prio, pool_ub, *overflow = self._insert_impl(
            (pool_states, child_states, states_b),
            (pool_prio, top_cp, torch.where(deferred, prio_b, NEG)),
            (pool_ub, child_ub_sel, torch.where(deferred, ub_b, NEG)))

        stats = torch.stack([
            admitted.sum(), sel_valid.sum(), pruned,
            (pool_prio > NEG).sum(), threshold.long(),
            (overflow[1] > NEG).sum()])
        return (pool_states, pool_prio, pool_ub,
                result_states, result_keys, overflow, stats)

    # ---------------------------------------------------------------- insert
    def _insert_impl(self, states, prio, ub):
        """Merge-sort insert over row blocks (the pool first): all rows by
        descending priority, ties in block order; the top C are the new
        pool, the rest the overflow block (its valid rows lead)."""
        C = self.C
        cat_states, cat_prio, cat_ub = (torch.cat(x) for x in (states, prio,
                                                                ub))
        order = _desc_order(cat_prio)
        keep, over = order[:C], order[C:]
        return (cat_states[keep], cat_prio[keep], cat_ub[keep],
                cat_states[over], cat_prio[over], cat_ub[over])

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ----------------------------------------------------------------- start
    def start(self) -> EngineState:
        """Seed the frontier and return a resumable :class:`EngineState`."""
        with self._span("engine.start"):
            return self._start_impl()

    def _start_impl(self) -> EngineState:
        cfg, S, C, k, dev = self.cfg, self.S, self.C, self.k, self.device
        vpq = VirtualPriorityQueue(
            state_width=S, backend=cfg.spill, spill_dir=cfg.spill_dir,
            obs=self.obs)

        states0, prio0, ub0 = self.comp.init_frontier()
        n0 = states0.shape[0]

        if n0 <= C:
            empty = torch.full((C,), NEG, dtype=torch.int32, device=dev)
            pool_states, pool_prio, pool_ub, os_, op_, ou_ = self._insert_impl(
                (torch.zeros((C, S), dtype=torch.int32, device=dev), states0),
                (empty, prio0), (empty, ub0))
            vpq.maybe_push(os_.cpu().numpy(), op_.cpu().numpy(),
                           ou_.cpu().numpy())
        else:  # more seeds than pool slots: top-C on device, rest spilled
            prio0 = prio0.cpu().numpy()
            order = np.argsort(-prio0, kind="stable")
            states0 = states0.cpu().numpy()[order]
            prio0, ub0 = prio0[order], ub0.cpu().numpy()[order]
            pool_states = self._to_device(states0[:C])
            pool_prio = self._to_device(prio0[:C])
            pool_ub = self._to_device(ub0[:C])
            vpq.maybe_push(states0[C:], prio0[C:], ub0[C:])

        return EngineState(
            pool_states=pool_states, pool_prio=pool_prio, pool_ub=pool_ub,
            result_states=torch.zeros((k, S), dtype=torch.int32, device=dev),
            result_keys=torch.full((k,), NEG, dtype=torch.int32, device=dev),
            vpq=vpq, candidates=int(n0), pool_occupancy=min(int(n0), C))

    # ------------------------------------------------------------------ step
    def step(self, st: EngineState) -> EngineState:
        """Advance one super-step.  Updates ``st`` in place and returns it."""
        t0 = time.perf_counter() if self.obs.enabled else 0.0
        with self._span("engine.step"):
            # the launches are asynchronous: device time that the enqueue
            # does not cover lands in host_sync, where the stats read waits
            with self._span("engine.device_compute"):
                (st.pool_states, st.pool_prio, st.pool_ub,
                 st.result_states, st.result_keys, overflow,
                 stats) = self._step_impl(
                    st.pool_states, st.pool_prio, st.pool_ub,
                    st.result_states, st.result_keys)
            with self._span("engine.host_sync"):
                stats = dict(zip(_STAT_NAMES, stats.tolist()))
            st.steps += 1
            st.host_syncs += 1
            st.expanded += stats["expanded"]
            st.candidates += stats["created"]
            st.pruned += stats["pruned"]
            st.threshold = stats["threshold"]
            n_over = stats["overflow"]
            if n_over:   # the valid rows lead the block; ship only those
                with self._span("engine.spill"):
                    st.vpq.maybe_push(*(x[:n_over].cpu().numpy()
                                        for x in overflow))
            self._refill(st, stats["pool_occupancy"])
        self._after_step(st, stats, t0)
        return st

    def _after_step(self, st: EngineState, stats: dict, t0: float) -> None:
        """Record one step() call's metrics (no-op handles when off)."""
        self._m_steps.inc()
        self._m_host_syncs.inc()
        self._m_expanded.inc(stats["expanded"])
        self._m_candidates.inc(stats["created"])
        self._m_pruned.inc(stats["pruned"])
        self._g_occupancy.set(st.pool_occupancy)
        self._g_threshold.set(st.threshold)
        if self.obs.enabled:
            self._h_step.observe(time.perf_counter() - t0)

    # ---------------------------------------------------------------- refill
    def _refill(self, st: EngineState, occ: int) -> None:
        """Refill the pool from spill when under the C/2 watermark; sets
        ``pool_occupancy`` and ``done``."""
        C = self.C
        refilled_now = 0
        if occ < C // 2 and len(st.vpq):
            # refill from spill runs; entries dominated by the current
            # threshold are dropped at the VPQ (paper-style late pruning)
            with self._span("engine.refill"):
                r_states, r_prio, r_ub = st.vpq.pop_chunk(
                    C - occ, min_ub=st.threshold)
                if len(r_prio):
                    refilled_now = len(r_prio)
                    st.refilled += refilled_now
                    self._m_refilled.inc(refilled_now)
                    (st.pool_states, st.pool_prio, st.pool_ub,
                     os_, op_, ou_) = self._insert_impl(
                        (st.pool_states, self._to_device(r_states)),
                        (st.pool_prio, self._to_device(r_prio)),
                        (st.pool_ub, self._to_device(r_ub)))
                    st.vpq.maybe_push(os_.cpu().numpy(), op_.cpu().numpy(),
                                      ou_.cpu().numpy())
        # refilled entries are live in the pool (their priorities are > NEG),
        # so a refill that drained the VPQ must not read as completion
        st.pool_occupancy = occ + refilled_now
        st.done = st.pool_occupancy == 0 and len(st.vpq) == 0

    # -------------------------------------------------------------- finalize
    def finalize(self, st: EngineState) -> EngineResult:
        """Close the VPQ and package the result set."""
        with self._span("engine.finalize"):
            st.vpq.close()
            return EngineResult(
                result_states=st.result_states.cpu().numpy(),
                result_keys=st.result_keys.cpu().numpy(),
                steps=st.steps, candidates=st.candidates,
                expanded=st.expanded, pruned=st.pruned,
                spilled=st.vpq.total_spilled, refilled=st.refilled,
                late_pruned=st.vpq.total_late_pruned,
                syncs=st.syncs, host_syncs=st.host_syncs)

    # ------------------------------------------------------------------- run
    def run(self, progress_every: int = 0) -> EngineResult:
        """Run to completion (or ``max_steps``)."""
        st = self.start()
        while not st.done and st.steps < self.cfg.max_steps:
            self.step(st)
            if progress_every and st.steps % progress_every == 0:
                print(f"[{self.comp.name}] step={st.steps} "
                      f"occ={st.pool_occupancy} vpq={len(st.vpq)} "
                      f"thr={st.threshold} cand={st.candidates}")
        return self.finalize(st)
