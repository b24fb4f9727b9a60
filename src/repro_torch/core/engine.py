"""Batched prioritized subgraph-expansion engine (paper Algorithm 1), on
PyTorch.

The port of ``repro.core.engine`` for one device.  One *super-step*
(:meth:`Engine._step_impl`) is the reference's, operation for operation:

1. **dequeue** the ``B`` highest-priority states from the device pool;
2. **result insertion** into the top-k result set (:func:`merge_topk`);
3. **pruning** against the k-th result key (dequeued states and children);
4. **targeted expansion** — ``score_children`` over the ``[B, A]`` grid,
   greedy parent admission under the materialization budget ``M``, the
   ``M`` selected children materialized (by the computation's
   ``materialize_selected`` where it has one: the clique computation's is
   one kernel that writes the ``[M, S]`` block);
5. **insert** — pool ∪ children ∪ deferred parents merge-sorted by
   priority; the top ``C`` stay on the device, the rest spill to the
   virtual priority queue.

Every answer and counter is byte-identical to the reference, which decides
how each selection is written here: ``jax.lax.top_k`` and
``jnp.argsort(descending=True)`` break ties by lower index, and
``torch.topk`` does not, so every selection is a stable descending
``torch.sort`` followed by a slice.

At ``steps_per_sync=1`` the host reads one small stats tensor per step (one
device-to-host sync) and ships only the valid prefix of the overflow block
to the queue.

Macro-steps (``steps_per_sync=T > 1``, the reference's DESIGN.md §13): one
:meth:`Engine.step` enqueues ``T`` super-steps with no host read between
them (:meth:`Engine._macro_flat`) and reads their stats once.  The
reference leaves its ``lax.while_loop`` early, at the first step after
which host work is due (:meth:`Engine._cont_flag`); a host loop cannot
leave on a device value without reading it, so here every one of the
``T`` steps is launched and a device flag, ``active``, turns each step
after the exit into an exact no-op (nothing dequeued, the pool and the
result set kept).  Answers, counters and ``host_syncs`` are the
reference's at the same ``T``; the no-op steps cost device time, which is
the price of the single read.  Each step's overflow block lands at the
valid-entry watermark ``w`` of an accumulator allocated once per engine.

With ``observe`` on, each pass of a super-step is timed as a window
(``pass.dequeue``, ``pass.score``, ``pass.select``, ``pass.materialize``,
``pass.insert``; ``pass.accumulate`` in macro-steps, ``pass.refill`` when a
refill runs): on a card the device's own stream time between two events,
put on the host's clock by an anchor event a step
(:mod:`repro_torch.obs.windows`), on the CPU a host span.  No operation
moves and no synchronisation is added.

Durable runs (the reference's DESIGN.md §15): with ``checkpoint_every``
and ``checkpoint_dir`` set, :meth:`Engine.run` saves the whole state —
pool, result set, counters, spill queue — through
:class:`~repro_torch.checkpoint.manager.CheckpointManager` at the first
host read every ``checkpoint_every`` steps, and :meth:`Engine.resume`
rebuilds it; the layout, leaf names and manifest are the reference's, so
either package resumes the other's checkpoint.  Under macro-steps the save
follows the macro-step's one host read, as in the reference; the no-op
steps a macro-step launches after its loop's exit leave the saved state
as it was.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .api import NEG, SubgraphComputation, resolve_device
from .vpq import VirtualPriorityQueue
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs import NOOP, Observability, pass_windows

#: EngineState counters checkpointed verbatim (the reference's tuple;
#: ``repro_torch.carry.STATE_SCALARS`` names this one)
_CKPT_SCALARS = ("steps", "candidates", "expanded", "pruned", "refilled",
                 "syncs", "host_syncs", "threshold", "pool_occupancy",
                 "done")

_STAT_NAMES = ("expanded", "created", "pruned", "pool_occupancy",
               "threshold", "overflow")
#: what one macro-step reports, in one tensor (one host read)
_MACRO_STAT_NAMES = ("steps", "expanded", "created", "pruned",
                     "spill_count", "pool_occupancy", "threshold")


@dataclasses.dataclass
class EngineConfig:
    """The reference's ``EngineConfig``, field for field, so a config can be
    carried across.  :class:`Engine` runs one device at any
    ``steps_per_sync`` and, as the reference's does, does not read
    ``shards``, ``sync_every``, ``record_bound_trace`` or ``use_pallas``;
    ``repro_torch.distributed.ShardedEngine`` reads the first three."""
    k: int = 1                    # result set size
    batch: int = 64               # B: states dequeued per super-step
    pool_capacity: int = 4096     # C: device-resident priority pool slots
    max_children: Optional[int] = None  # M: materialization budget (>= A)
    max_steps: int = 100_000
    spill: str = "host"           # VPQ backing: "host" | "disk" | "none"
    spill_dir: Optional[str] = None
    shards: int = 1               # ShardedEngine's shard count
    steps_per_sync: int = 1       # T: super-steps per host read
    overflow_accum: Optional[int] = None   # macro-step accumulator rows
    sync_every: int = 1           # K: inner steps per bound exchange
    record_bound_trace: bool = False       # sharded test hook: bound traces
    checkpoint_every: int = 0     # durable runs: Engine.run saves every N
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
    host_syncs: int = 0           # host-device round-trips, one a step()
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


#: elements of one tile of merge_topk's row comparison (a byte each)
RANK_BUDGET = 1 << 27


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
    that precede it.  The comparison runs over tiles of ``T`` rows against
    all ``R``, a ``[T, R, S]`` block at a time with ``T·R·S`` at most
    ``RANK_BUDGET`` (one row a tile at least), so its memory grows with
    ``R·S`` and not with ``R²·S``; the main path's ``R = k + B = 67`` at
    ``S = 2,050`` is one tile.
    """
    r, s = states.shape
    idx = torch.arange(r, device=states.device)
    rows = max(1, RANK_BUDGET // (r * s))
    rank = None
    for lo in range(0, r, rows):
        si, ii = states[lo:lo + rows, None, :], idx[lo:lo + rows, None]
        differ = si != states[None, :, :]                       # [T, R, S]
        first = torch.argmax(differ.view(torch.uint8), dim=-1, keepdim=True)
        wi = torch.take_along_dim(si, first, dim=-1)[..., 0]
        wj = torch.take_along_dim(states[None, :, :], first, dim=-1)[..., 0]
        ki = keys[lo:lo + rows, None]
        by_key = (ki < keys) | ((ki == keys) & (ii < idx))
        before = torch.where(wi != wj, wi < wj, by_key)        # i before j
        part = before.sum(dim=0)                # rows of the tile preceding j
        rank = part if rank is None else rank + part
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


def sharded_bound(result_states: torch.Tensor, result_keys: torch.Tensor,
                  k: int) -> torch.Tensor:
    """The sharded engine's bound exchange (the reference's
    ``make_sharded_bound_sync``): the k-th best key over every shard's k
    result rows, ``[shards·k, S]`` and ``[shards·k]``, with identical
    (state, key) pairs counted once; ``NEG`` while fewer than k distinct
    rows exist.  A deferred parent that the rebalancer moves can put its
    key into two shards' result sets; counted twice, it would tighten the
    threshold past the true k-th best and prune true results."""
    return merge_topk(result_states, result_keys, k)[1][k - 1]


def stale_bound(last_exchanged: torch.Tensor, result_keys: torch.Tensor,
                k: int) -> torch.Tensor:
    """The bound a shard prunes with between two exchanges (the reference's
    ``make_stale_bound_sync``, DESIGN.md §14): the larger of the last
    exchanged bound and the shard's own k-th key (``NEG``, the least
    int32, in an empty slot).  Both are lower bounds on the fresh
    exchange's value — result sets only improve, and one shard's rows are
    a subset of all — so pruning with it is at worst looser, never
    unsound, and complete runs keep their answer at any ``sync_every``."""
    return torch.maximum(last_exchanged, result_keys[k - 1])


class Engine:
    """Runs one :class:`SubgraphComputation` to completion (or stepwise) on
    the computation's device."""

    def __init__(self, comp: SubgraphComputation, config: EngineConfig):
        # shards, sync_every, record_bound_trace and use_pallas are not read
        # here, as in the reference's Engine: the sharded engine and the
        # computations read them
        if config.interpret is not None:
            raise NotImplementedError(
                "EngineConfig: interpret has no meaning here: the kernel "
                "path follows the tensors' device (ROADMAP Queue 1, item 3)")
        self.comp = comp
        self.cfg = config
        self.device = resolve_device(comp.device)
        a = comp.num_actions
        self.M = max(config.max_children or 0, a)
        self.B = config.batch
        # the reference's lax.top_k raises these at its first step
        if config.batch > config.pool_capacity:
            raise ValueError(
                f"EngineConfig: batch ({config.batch}) exceeds pool_capacity "
                f"({config.pool_capacity}): a step dequeues batch states "
                f"from the pool")
        if self.M > self.B * a:
            raise ValueError(
                f"EngineConfig: max_children ({config.max_children}) exceeds "
                f"batch * num_actions ({self.B} * {a}): a step selects "
                f"max_children of that many children")
        self.C = config.pool_capacity
        self.S = comp.state_width
        self.k = config.k
        self.T = max(1, config.steps_per_sync)
        # overflow-accumulator capacity: one super-step's overflow block is
        # exactly B + M rows (the insert over C + M + B rows keeps C), so T
        # blocks never overflow the default sizing
        self.acc_cap = max(config.overflow_accum or self.T * (self.B + self.M),
                           self.B + self.M)
        self._acc = None          # [acc_cap + B + M] rows, made at first use
        if config.observe:
            self.obs = config.observability or Observability()
        else:
            self.obs = NOOP
        obs = self.obs
        self._span = obs.tracer.span
        # one window a pass and super-step (pass.*): on the device's clock
        # on a card, a host span on the CPU, NULL_SPAN when off
        self._pass, self._windows = pass_windows(obs, self.device)
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
                   result_states, result_keys, active=None):
        """One super-step; returns the new pool and result set, the overflow
        block (sorted by descending priority, so its valid rows are a
        prefix) and the step's stats as one int64 tensor.

        ``active`` (a bool tensor on the device; None outside a macro-step)
        false makes the step a no-op: nothing is dequeued, so nothing is
        expanded, pruned or spilled, and the pool and result set come back
        as they went in; its stats read zero but for occupancy and
        threshold, which are unchanged."""
        (pool_states, pool_prio, pool_ub, result_states, result_keys,
         batch) = self._dequeue_merge(pool_states, pool_prio, pool_ub,
                                      result_states, result_keys, active)
        # 3. dominance threshold: the k-th entry (NEG while R not full)
        return self._expand_insert(pool_states, pool_prio, pool_ub,
                                   result_states, result_keys, batch,
                                   result_keys[self.k - 1], active)

    def _dequeue_merge(self, pool_states, pool_prio, pool_ub,
                       result_states, result_keys, active=None):
        """Steps 1-2 of a super-step: dequeue the top ``B`` and merge them
        into the result set.  Returns the pool (the dequeued slots
        emptied), the new result set and the dequeued batch ``(states,
        prio, ub, valid)``."""
        comp, B, k = self.comp, self.B, self.k

        with self._pass("pass.dequeue"):
            # 1. dequeue top-B
            idx_b = _desc_order(pool_prio)[:B]
            prio_b = pool_prio[idx_b]
            valid_b = prio_b > NEG
            if active is not None:
                valid_b = valid_b & active
            states_b = pool_states[idx_b]
            ub_b = pool_ub[idx_b]
            # the dequeued slots empty (the others among the B are empty
            # already)
            pool_prio = pool_prio.index_put((idx_b,),
                                            torch.where(valid_b, NEG, prio_b))

            # 2. result insertion (Alg. 1 lines 6-10), canonical tie-break
            rkey_b = torch.where(valid_b, comp.result_key(states_b), NEG)
            merged = merge_topk(torch.cat([result_states, states_b]),
                                torch.cat([result_keys, rkey_b]), k)
            if active is not None:
                merged = [torch.where(active, new, old) for new, old in
                          zip(merged, (result_states, result_keys))]
            result_states, result_keys = merged

        return (pool_states, pool_prio, pool_ub, result_states, result_keys,
                (states_b, prio_b, ub_b, valid_b))

    def _expand_insert(self, pool_states, pool_prio, pool_ub, result_states,
                       result_keys, batch, threshold, active=None):
        """Steps 3-5 of a super-step against ``threshold`` (the local k-th
        key, or the sharded engine's exchanged bound): prune the dequeued
        batch, score and materialize its children, merge-sort insert.
        Returns what :meth:`_step_impl` returns."""
        comp, B, M = self.comp, self.B, self.M
        A = comp.num_actions
        states_b, prio_b, ub_b, valid_b = batch

        with self._pass("pass.score"):
            # 3. dominance pruning of the dequeued states
            expand_b = valid_b & (ub_b >= threshold)
            pruned = (valid_b & ~expand_b).sum()

            # 4. targeted expansion: score the [B, A] child grid
            child_prio, child_ub = comp.score_children(states_b)

        with self._pass("pass.select"):
            keep = expand_b[:, None] & (child_prio > NEG) & \
                (child_ub >= threshold)

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

        with self._pass("pass.materialize"):
            if comp.materialize_selected is not None:
                child_states = comp.materialize_selected(
                    states_b, sel_parent, sel_action, sel_valid)
            else:
                child_states = comp.materialize(states_b[sel_parent],
                                                sel_action)
                child_states = torch.where(sel_valid[:, None], child_states,
                                           0)
            child_ub_sel = torch.where(
                sel_valid, child_ub.reshape(B * A)[top_ci], NEG)

        with self._pass("pass.insert"):
            # 5. merge-sort insert: pool ∪ children ∪ deferred parents
            pool_states, pool_prio, pool_ub, *overflow = self._insert_impl(
                (pool_states, child_states, states_b),
                (pool_prio, top_cp, torch.where(deferred, prio_b, NEG)),
                (pool_ub, child_ub_sel, torch.where(deferred, ub_b, NEG)),
                active)

            stats = torch.stack([
                admitted.sum(), sel_valid.sum(), pruned,
                (pool_prio > NEG).sum(), threshold.long(),
                (overflow[1] > NEG).sum()])
        return (pool_states, pool_prio, pool_ub,
                result_states, result_keys, overflow, stats)

    # ------------------------------------------------------------ macro-step
    def _macro_impl(self, pool_states, pool_prio, pool_ub, result_states,
                    result_keys, t_max: int, vpq_nonempty: bool):
        """Up to ``t_max`` fused super-steps with no host read between them
        (the reference's DESIGN.md §13).  One device has no bound to
        exchange, so this is the reference's ``_macro_flat``;
        ``ShardedEngine._macro_impl`` is its ``_macro_segmented``."""
        return self._macro_flat(pool_states, pool_prio, pool_ub,
                                result_states, result_keys, t_max,
                                vpq_nonempty)

    def _accumulator(self):
        """The overflow accumulator ``(states, prio, ub)``: ``acc_cap`` rows
        plus one block of spare rows, so that a no-op step may write its
        block at any ``w <= acc_cap``.  Made once per engine; each
        macro-step writes its rows before the host reads them, so nothing
        is cleared between macro-steps."""
        if self._acc is None:
            rows, dev = self.acc_cap + self.B + self.M, self.device
            self._acc = (
                torch.zeros((rows, self.S), dtype=torch.int32, device=dev),
                torch.full((rows,), NEG, dtype=torch.int32, device=dev),
                torch.full((rows,), NEG, dtype=torch.int32, device=dev))
        return self._acc

    def _cont_flag(self, vpq_nonempty: bool, t_max: int, t, w, occ):
        """Whether the loop goes on after a step (the reference's decision,
        on the device): steps remain, the next overflow block is sure to
        fit, the pool is not empty, and no refill is due — the pool is at
        or above the ``C//2`` watermark, or nothing is spilled (the VPQ was
        empty at entry and the accumulator is empty)."""
        room = (w + (self.B + self.M)) <= self.acc_cap
        low = occ < (self.C // 2)
        refillable = (w > 0) | vpq_nonempty
        need_host = ~room | (low & refillable)
        return (t < t_max) & ~need_host & (occ > 0)

    def _fused_step(self, ps, pp, pu, rs, rk, w, sums, t, active,
                    t_max: int, vpq_nonempty: bool):
        """One inner super-step plus the accumulator write, the sums and
        the loop's decision after it.

        The block is written at the watermark ``w`` (the reference's
        ``dynamic_update_slice``) and its valid rows, which lead it, are
        kept by advancing ``w`` by their count.  The rows past ``w`` are
        never read, so a no-op step (count 0) may write there; the loop's
        room check keeps ``w <= acc_cap``, and the spare block past
        ``acc_cap`` holds the write."""
        ps, pp, pu, rs, rk, overflow, stats = self._step_impl(
            ps, pp, pu, rs, rk, active=active)
        with self._pass("pass.accumulate"):
            dst = w + torch.arange(self.B + self.M, device=self.device)
            for acc, block in zip(self._accumulator(), overflow):
                acc.index_copy_(0, dst, block)
            w, sums = w + stats[5], sums + stats[:3]
            t = t + active
            # a no-op step leaves occupancy and threshold as they were, so
            # the last step's are the last live step's
            active = active & self._cont_flag(vpq_nonempty, t_max, t, w,
                                              stats[3])
        return ps, pp, pu, rs, rk, w, sums, t, active, stats

    def _macro_flat(self, pool_states, pool_prio, pool_ub, result_states,
                    result_keys, t_max: int, vpq_nonempty: bool):
        """The macro loop: ``t_max`` steps launched, the first always live,
        each later one live while :meth:`_cont_flag` holds after its
        predecessor.  No host read in between.  Returns the pool, the
        result set and one int64 stats tensor (:data:`_MACRO_STAT_NAMES`);
        the overflow rows are ``self._acc[i][:spill_count]``."""
        dev = self.device
        active = torch.ones((), dtype=torch.bool, device=dev)
        t = torch.zeros((), dtype=torch.int64, device=dev)
        w = torch.zeros((), dtype=torch.int64, device=dev)
        sums = torch.zeros((3,), dtype=torch.int64, device=dev)
        ps, pp, pu, rs, rk = (pool_states, pool_prio, pool_ub,
                              result_states, result_keys)
        for _ in range(t_max):
            ps, pp, pu, rs, rk, w, sums, t, active, stats = \
                self._fused_step(ps, pp, pu, rs, rk, w, sums, t, active,
                                 t_max, vpq_nonempty)
        stats = torch.cat([t[None], sums, w[None], stats[3:5]])
        return ps, pp, pu, rs, rk, stats

    # ---------------------------------------------------------------- insert
    def _insert_impl(self, states, prio, ub, active=None):
        """Merge-sort insert over row blocks (the pool first): all rows by
        descending priority, ties in block order; the top C are the new
        pool, the rest the overflow block (its valid rows lead).  With
        ``active`` false the rows keep their order, so the pool comes back
        as it went in and the overflow is the (empty) rows after it."""
        C = self.C
        cat_states, cat_prio, cat_ub = (torch.cat(x) for x in (states, prio,
                                                                ub))
        order = _desc_order(cat_prio)
        if active is not None:
            order = torch.where(active, order, torch.arange(
                order.shape[0], device=order.device))
        keep, over = order[:C], order[C:]
        return (cat_states[keep], cat_prio[keep], cat_ub[keep],
                cat_states[over], cat_prio[over], cat_ub[over])

    def _pinned_rows(self):
        """The spill queue's staging on a card: a super-step's overflow
        block (B + M rows; a macro-step's larger blocks take pageable
        memory) and a refill (at most C rows)."""
        return (self.B + self.M, self.C) if self.device.type == "cuda" \
            else None

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
            obs=self.obs, pinned_rows=self._pinned_rows())

        with self._span("engine.start.frontier"):
            states0, prio0, ub0 = self.comp.init_frontier()
            n0 = states0.shape[0]
            if n0 > C:      # the seeds' read-back waits on the frontier
                prio0 = prio0.cpu().numpy()
                states0 = states0.cpu().numpy()
                ub0 = ub0.cpu().numpy()

        if n0 <= C:
            empty = torch.full((C,), NEG, dtype=torch.int32, device=dev)
            pool_states, pool_prio, pool_ub, os_, op_, ou_ = self._insert_impl(
                (torch.zeros((C, S), dtype=torch.int32, device=dev), states0),
                (empty, prio0), (empty, ub0))
            vpq.maybe_push(os_.cpu().numpy(), op_.cpu().numpy(),
                           ou_.cpu().numpy())
        else:  # more seeds than pool slots: top-C on device, rest spilled
            with self._span("engine.start.sort"):
                order = np.argsort(-prio0, kind="stable")
                states0, prio0, ub0 = states0[order], prio0[order], \
                    ub0[order]
            with self._span("engine.start.upload"):
                pool_states = self._to_device(states0[:C])
                pool_prio = self._to_device(prio0[:C])
                pool_ub = self._to_device(ub0[:C])
            with self._span("engine.start.push"):
                vpq.maybe_push(states0[C:], prio0[C:], ub0[C:])

        return EngineState(
            pool_states=pool_states, pool_prio=pool_prio, pool_ub=pool_ub,
            result_states=torch.zeros((k, S), dtype=torch.int32, device=dev),
            result_keys=torch.full((k,), NEG, dtype=torch.int32, device=dev),
            vpq=vpq, candidates=int(n0), pool_occupancy=min(int(n0), C))

    # ------------------------------------------------------------------ step
    def step(self, st: EngineState, max_inner: Optional[int] = None
             ) -> EngineState:
        """Advance one engine step — a single super-step at
        ``steps_per_sync == 1``, else one macro-step of up to
        ``min(steps_per_sync, max_inner)`` super-steps.  ``max_inner`` caps
        the fused count so that a step budget truncates at the same step
        for any ``steps_per_sync``.  Updates ``st`` in place and returns
        it."""
        if self.T > 1:
            t_cap = (self.T if max_inner is None
                     else max(1, min(self.T, int(max_inner))))
            return self._macro_step(st, t_cap)
        t0 = time.perf_counter() if self.obs.enabled else 0.0
        with self._span("engine.step"):
            self._windows.anchor()      # the device is idle here
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
            self._windows.collect()
            st.steps += 1
            st.host_syncs += 1
            st.expanded += stats["expanded"]
            st.candidates += stats["created"]
            st.pruned += stats["pruned"]
            st.threshold = stats["threshold"]
            n_over = stats["overflow"]
            if n_over:   # the valid rows lead the block; ship only those
                with self._span("engine.spill"):
                    st.vpq.push_from_device(*(x[:n_over] for x in overflow))
            self._refill(st, stats["pool_occupancy"])
        self._after_step(st, 1, stats, t0)
        return st

    def _macro_step(self, st: EngineState, t_cap: int) -> EngineState:
        """One macro-step of up to ``t_cap`` super-steps and one host read."""
        t0 = time.perf_counter() if self.obs.enabled else 0.0
        with self._span("engine.step"):
            self._windows.anchor()      # the device is idle here
            with self._span("engine.device_compute"):
                (st.pool_states, st.pool_prio, st.pool_ub,
                 st.result_states, st.result_keys, stats) = self._macro_impl(
                    st.pool_states, st.pool_prio, st.pool_ub,
                    st.result_states, st.result_keys, t_cap,
                    len(st.vpq) > 0)
            with self._span("engine.host_sync"):
                stats = dict(zip(_MACRO_STAT_NAMES, stats.tolist()))
            self._windows.collect()
            st.steps += stats["steps"]
            st.host_syncs += 1
            st.expanded += stats["expanded"]
            st.candidates += stats["created"]
            st.pruned += stats["pruned"]
            st.threshold = stats["threshold"]
            w = stats["spill_count"]
            if w:    # ship only the accumulator's valid prefix; none when dry
                with self._span("engine.spill"):
                    st.vpq.push_from_device(*(x[:w] for x in self._acc))
            self._refill(st, stats["pool_occupancy"])
        self._after_step(st, stats["steps"], stats, t0)
        return st

    def _after_step(self, st: EngineState, n_steps: int, stats: dict,
                    t0: float) -> None:
        """Record one step() call's metrics (no-op handles when off)."""
        self._m_steps.inc(n_steps)
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
                chunk = st.vpq.pop_chunk(C - occ, min_ub=st.threshold)
                if len(chunk[1]):
                    refilled_now = len(chunk[1])
                    st.refilled += refilled_now
                    self._m_refilled.inc(refilled_now)
                    # occ + refilled <= C live entries: all stay in the
                    # pool, and the insert's overflow rows are all empty
                    with self._pass("pass.refill"):
                        up_states, up_prio, up_ub = st.vpq.upload(
                            chunk, self.device)
                        (st.pool_states, st.pool_prio, st.pool_ub,
                         *_) = self._insert_impl(
                            (st.pool_states, up_states),
                            (st.pool_prio, up_prio), (st.pool_ub, up_ub))
        # refilled entries are live in the pool (their priorities are > NEG),
        # so a refill that drained the VPQ must not read as completion
        st.pool_occupancy = occ + refilled_now
        st.done = st.pool_occupancy == 0 and len(st.vpq) == 0

    # -------------------------------------------------------------- finalize
    def finalize(self, st: EngineState) -> EngineResult:
        """Close the VPQ and package the result set."""
        with self._span("engine.finalize"):
            st.vpq.close()
            res = EngineResult(
                result_states=st.result_states.cpu().numpy(),
                result_keys=st.result_keys.cpu().numpy(),
                steps=st.steps, candidates=st.candidates,
                expanded=st.expanded, pruned=st.pruned,
                spilled=st.vpq.total_spilled, refilled=st.refilled,
                late_pruned=st.vpq.total_late_pruned,
                syncs=st.syncs, host_syncs=st.host_syncs)
            self._windows.collect()     # the last refill's, after the read
            return res

    # ------------------------------------------------------- checkpointing
    def _ckpt_arrays(self, st: EngineState) -> dict:
        return dict(pool_states=st.pool_states, pool_prio=st.pool_prio,
                    pool_ub=st.pool_ub, result_states=st.result_states,
                    result_keys=st.result_keys)

    def save_checkpoint(self, mgr: CheckpointManager, st: EngineState,
                        blocking: bool = False) -> None:
        """Persist ``st`` through ``mgr``'s atomic-commit protocol.  The
        arrays are copied to the host and the VPQ captured (array
        snapshots, hardlinks of disk run files) before this returns, so
        the engine may step on — and delete exhausted spill runs — while
        the writer thread flushes.  Saving never changes the run."""
        scalars = {name: getattr(st, name) for name in _CKPT_SCALARS}

        def capture(tmp_dir: str) -> dict:
            vpq = st.vpq.snapshot(os.path.join(tmp_dir, "vpq"))
            return {"kind": "engine", "scalars": scalars, "vpq": vpq}

        mgr.save(st.steps, self._ckpt_arrays(st), blocking=blocking,
                 capture=capture)

    def resume(self, source, step: Optional[int] = None) -> EngineState:
        """Rebuild an :class:`EngineState` on this engine's device from a
        committed checkpoint (a directory or a :class:`CheckpointManager`;
        the newest step unless ``step`` is given), written by this package
        or by the reference.  Spill files the checkpoint references are
        linked into the live spill dir (``cfg.spill_dir`` or a fresh temp
        dir), so the checkpoint stays restorable any number of times."""
        mgr = (source if isinstance(source, CheckpointManager)
               else CheckpointManager(source, obs=self.obs))
        manifest = mgr.read_manifest(step)
        step = manifest["step"]
        extra = manifest["extra"]
        if extra is None or extra.get("kind") != "engine":
            raise ValueError(
                f"step {step} in {mgr.dir} is not an engine checkpoint")
        like = {leaf["name"]: np.zeros(
            [int(s) for s in leaf["shape"]], np.dtype(leaf["dtype"]))
            for leaf in manifest["leaves"]}
        tree = mgr.restore(like, step=step)
        vpq = VirtualPriorityQueue.restore(
            extra["vpq"], os.path.join(mgr.path(step), "vpq"),
            spill_dir=self.cfg.spill_dir, obs=self.obs,
            pinned_rows=self._pinned_rows())
        return EngineState(
            vpq=vpq, **{name: self._to_device(a) for name, a in tree.items()},
            **extra["scalars"])

    # ------------------------------------------------------------------- run
    def run(self, progress_every: int = 0,
            resume: bool = False) -> EngineResult:
        """Run to completion (or ``max_steps``).  With
        ``cfg.checkpoint_every > 0`` and a ``cfg.checkpoint_dir``, the
        state is saved at the first host read every ``checkpoint_every``
        steps after the last save, and once more at the end;
        ``resume=True`` continues from the newest committed step there (a
        fresh start when none is committed)."""
        mgr = None
        if self.cfg.checkpoint_dir and (self.cfg.checkpoint_every > 0
                                        or resume):
            mgr = CheckpointManager(self.cfg.checkpoint_dir, obs=self.obs)
        st = None
        if resume and mgr is not None and mgr.latest_step() is not None:
            st = self.resume(mgr)
        if st is None:
            st = self.start()
        every = self.cfg.checkpoint_every
        last_ckpt = st.steps
        while not st.done and st.steps < self.cfg.max_steps:
            self.step(st, max_inner=self.cfg.max_steps - st.steps)
            if progress_every and st.steps % progress_every == 0:
                print(f"[{self.comp.name}] step={st.steps} "
                      f"occ={st.pool_occupancy} vpq={len(st.vpq)} "
                      f"thr={st.threshold} cand={st.candidates}")
            if mgr is not None and every > 0 and \
                    st.steps - last_ckpt >= every:
                self.save_checkpoint(mgr, st)
                last_ckpt = st.steps
        if mgr is not None and every > 0 and st.steps > last_ckpt:
            self.save_checkpoint(mgr, st)   # the final state restores too
        if mgr is not None:
            mgr.wait()
        return self.finalize(st)
