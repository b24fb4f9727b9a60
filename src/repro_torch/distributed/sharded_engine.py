"""Sharded discovery engine (the reference's DESIGN.md §11, §13, §14), on
PyTorch.

The port of ``repro.distributed.sharded_engine``.  One query's frontier is
split over ``shards`` shards, each with its own device pool, result set and
spill queue, that share one pruning bound:

* **seed deal** — the initial frontier is dealt round-robin: shard ``i``
  gets seeds ``i, i + shards, ...``, ordered by priority with ties in
  *descending* index order (the reference's reversed stable ascending
  sort); seeds past a shard's pool go straight to its spill queue;
* **one super-step** — steps 1-2 of the single-device super-step
  (:meth:`Engine._dequeue_merge`) for every shard, then the bound exchange
  (:func:`~repro_torch.core.engine.sharded_bound`: the k-th best key over
  every shard's result rows, duplicates counted once), then steps 3-5
  (:meth:`Engine._expand_insert`) for every shard against that one bound.
  So ``masked_intersect`` launches once per shard per step, for a shard
  with an empty pool too, as in the reference's ``shard_map`` body;
* **macro-steps** (``steps_per_sync = T > 1``, DESIGN.md §13) — one
  :meth:`ShardedEngine.step` enqueues ``T`` super-steps with no host read
  between them (:meth:`ShardedEngine._macro_impl`), each shard's overflow
  landing in its own block of one accumulator at its own watermark, and
  reads their stats once.  The reference's loop exit is one vote over
  every shard; here it is a device flag ``active``, and the steps after it
  run as exact no-ops, as in :meth:`Engine._macro_flat`;
* **stale bounds** (``sync_every = K``, DESIGN.md §14) — the exchange
  runs at the first step of every K (a segment head); in the steps
  between, each shard prunes with
  :func:`~repro_torch.core.engine.stale_bound` (the head's bound or its
  own k-th key, whichever is larger), and the exit vote is taken once a
  segment.  ``syncs`` counts the exchanges, ``ceil(steps / K)`` a call;
  ``host_syncs`` counts the step() calls;
* **per-shard spill** — each shard's overflow goes to its own
  :class:`~repro_torch.core.vpq.VirtualPriorityQueue`
  (``spill_dir/shard{i}`` on disk), only its valid prefix copied to the
  host; refills prune late against the exchanged bound;
* **host rebalancer** — after the refills, a shard below the ``C/2``
  watermark whose own queue is empty pulls spilled work from the
  most-loaded queues, in priority order.

The pools and result sets keep the reference's global layout (``[shards·C,
S]``, ``[shards·k, S]``); shard ``i`` works on its slice.  Answers, every
``EngineResult`` counter and every ``per_shard`` list (the bound traces of
``record_bound_trace`` among them) are the reference's, byte for byte, at
any shard count, ``steps_per_sync`` and ``sync_every``.

Decisions that differ from the reference: the shard axis is a Python loop
over slices of tensors on the computation's one device, so any ``shards >=
1`` runs (the reference needs that many JAX devices and raises beyond
them), and ``shard_map_compat`` has no counterpart.  ``shards < 1`` is a
``ValueError``, as in the reference.

Checkpoints (:meth:`ShardedEngine.save_checkpoint`, :meth:`~ShardedEngine.
resume`, ``run(resume=...)``) keep the reference's manifest, leaf names and
file layout, so either package resumes a sharded checkpoint that the other
wrote.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.api import NEG, SubgraphComputation
from repro_torch.core.engine import (_STAT_NAMES, Engine, EngineConfig,
                                     EngineResult, merge_topk, sharded_bound,
                                     stale_bound)
from repro_torch.core.vpq import VirtualPriorityQueue

#: ShardedEngineState counters checkpointed verbatim (the reference's
#: tuple); ``pool_occupancy`` is saved beside them as a list of ints
_CKPT_SCALARS = ("steps", "candidates", "expanded", "pruned", "refilled",
                 "rebalanced", "syncs", "host_syncs", "threshold", "done")


@dataclasses.dataclass
class ShardedEngineState:
    """Resumable sharded search state.  The tensors live on the engine's
    device in the reference's global layout (shard ``i`` owns rows ``i·C``
    to ``(i+1)·C`` of the pool, ``i·k`` to ``(i+1)·k`` of the result set);
    the queues and counters are on the host."""

    pool_states: torch.Tensor     # [shards*C, S]
    pool_prio: torch.Tensor       # [shards*C]
    pool_ub: torch.Tensor         # [shards*C]
    result_states: torch.Tensor   # [shards*k, S] (per-shard local top-k)
    result_keys: torch.Tensor     # [shards*k]
    vpqs: List[VirtualPriorityQueue]
    pool_occupancy: np.ndarray    # [shards] int64
    steps: int = 0
    candidates: int = 0
    expanded: int = 0
    pruned: int = 0
    refilled: int = 0
    rebalanced: int = 0
    syncs: int = 0                # bound exchanges run so far
    host_syncs: int = 0           # host-device round-trips taken so far
    threshold: int = int(NEG)
    done: bool = False            # every shard pool and queue drained
    # record_bound_trace: one [shards, inner steps] array a macro-step of
    # the bound each shard pruned with, and of the fresh exchange's value
    bound_used: List[np.ndarray] = dataclasses.field(default_factory=list)
    bound_fresh: List[np.ndarray] = dataclasses.field(default_factory=list)


class ShardedEngine:
    """Runs one :class:`SubgraphComputation` over ``config.shards`` shards
    on the computation's device, with :class:`Engine`'s interface
    (``start`` / ``step`` / ``finalize`` / ``run``).  ``config.batch``,
    ``pool_capacity`` and ``max_children`` are per-shard shapes."""

    def __init__(self, comp: SubgraphComputation, config: EngineConfig):
        self.comp = comp
        self.cfg = config
        self.shards = config.shards
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if config.sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1, got {config.sync_every}")
        # the reference's schedule: K clamped so that one segment's
        # overflow blocks fit the accumulator, steps_per_sync raised to a
        # multiple of K (every macro-step ends on a segment's end), and to
        # 2 under bound traces (they ride the macro path only)
        blk = config.batch + max(config.max_children or 0, comp.num_actions)
        K = config.sync_every
        if config.overflow_accum:
            K = max(1, min(K, config.overflow_accum // blk))
        self.K = K
        T = max(1, config.steps_per_sync)
        if K > 1:
            T = -(-max(T, K) // K) * K
        if config.record_bound_trace:
            T = max(T, 2)
        self.T = T

        # the per-shard engine: the super-step's two halves, the insert,
        # the per-shard shapes and the accumulator's capacity
        self._eng = Engine(comp, dataclasses.replace(
            config, shards=1, steps_per_sync=T, sync_every=1))
        self.device = self._eng.device
        self.C, self.S, self.k = self._eng.C, self._eng.S, config.k
        self._acc = None    # [shards, acc_cap + B + M] rows, at first use

        # observability: the inner engine's instance, so sharded and
        # per-shard telemetry land in one registry
        self.obs = self._eng.obs
        self._span = self.obs.tracer.span
        # the inner engine's pass windows: its halves record them, and
        # each step here anchors and collects them
        self._pass, self._windows = self._eng._pass, self._eng._windows
        self._m_rebalanced = self.obs.counter(
            "engine_rebalanced_total",
            "spilled entries moved across shards")
        self._m_syncs = self.obs.counter(
            "engine_syncs_total", "bound-exchange collectives run")

    def _slices(self, i: int):
        """Shard ``i``'s rows of the pool and of the result set."""
        C, k = self.C, self.k
        return slice(i * C, (i + 1) * C), slice(i * k, (i + 1) * k)

    # ----------------------------------------------------------------- start
    def start(self) -> ShardedEngineState:
        """Deal the seeds over the shards and return a resumable state."""
        with self._span("engine.start"):
            return self._start_impl()

    def _start_impl(self) -> ShardedEngineState:
        cfg, S, C, k, dev = self.cfg, self.S, self.C, self.k, self.device
        shards = self.shards
        vpqs = [VirtualPriorityQueue(
            state_width=S, backend=cfg.spill,
            spill_dir=(os.path.join(cfg.spill_dir, f"shard{i}")
                       if cfg.spill_dir is not None else None),
            obs=self.obs) for i in range(shards)]

        states0, prio0, ub0 = self.comp.init_frontier()
        n0 = states0.shape[0]
        prio_host = prio0.cpu().numpy()

        pool_states = torch.zeros((shards * C, S), dtype=torch.int32,
                                  device=dev)
        pool_prio = torch.full((shards * C,), NEG, dtype=torch.int32,
                               device=dev)
        pool_ub = torch.full((shards * C,), NEG, dtype=torch.int32,
                             device=dev)
        occ = np.zeros(shards, np.int64)
        for i in range(shards):
            # round-robin seed deal: shard i gets seeds i, i+shards, ...,
            # by priority, ties in descending index order (the reference's
            # reversed stable ascending sort)
            idx = np.arange(i, n0, shards)
            order = idx[np.argsort(prio_host[idx].astype(np.int64),
                                   kind="stable")[::-1]]
            take = torch.from_numpy(order).to(dev)
            s_i, p_i, u_i = states0[take], prio0[take], ub0[take]
            m = min(len(order), C)
            rows = slice(i * C, i * C + m)
            pool_states[rows], pool_prio[rows], pool_ub[rows] = \
                s_i[:m], p_i[:m], u_i[:m]
            occ[i] = m
            if len(order) > m:   # more seeds than per-shard pool slots
                vpqs[i].maybe_push(*(x[m:].cpu().numpy()
                                     for x in (s_i, p_i, u_i)))

        return ShardedEngineState(
            pool_states=pool_states, pool_prio=pool_prio, pool_ub=pool_ub,
            result_states=torch.zeros((shards * k, S), dtype=torch.int32,
                                      device=dev),
            result_keys=torch.full((shards * k,), NEG, dtype=torch.int32,
                                   device=dev),
            vpqs=vpqs, pool_occupancy=occ, candidates=int(n0))

    # ------------------------------------------------------------------ step
    def _super_step(self, st: ShardedEngineState, active=None, stale=None,
                    trace: bool = False):
        """One super-step of every shard, enqueued with no host read: steps
        1-2 for each shard, the bound, steps 3-5 for each against it.
        With ``stale`` None (a segment head, every step at ``sync_every =
        1``) every shard prunes with the fresh exchange over all their
        result rows; else (a segment's later step) shard ``i`` prunes with
        :func:`stale_bound` of ``stale`` and its own k-th key.  ``active``
        false makes the step a no-op (:meth:`Engine._step_impl`).  Updates
        the pools and result sets in ``st``; returns each shard's overflow
        block, the stats as one ``[shards, 6]`` int64 tensor, the fresh
        exchange (None in a later step unless ``trace``) and each shard's
        bound."""
        eng = self._eng
        heads = []
        for i in range(self.shards):
            p, r = self._slices(i)
            heads.append(eng._dequeue_merge(
                st.pool_states[p], st.pool_prio[p], st.pool_ub[p],
                st.result_states[r], st.result_keys[r], active))
        st.result_states = torch.cat([h[3] for h in heads])
        st.result_keys = torch.cat([h[4] for h in heads])
        fresh = None
        if stale is None or trace:
            fresh = sharded_bound(st.result_states, st.result_keys, self.k)
        bounds = ([fresh] * self.shards if stale is None else
                  [stale_bound(stale, h[4], self.k) for h in heads])
        overflow, stats = [], []
        for i, (head, bound) in enumerate(zip(heads, bounds)):
            ps, pp, pu, _, _, over, stat = eng._expand_insert(*head, bound,
                                                              active)
            p, _ = self._slices(i)
            st.pool_states[p], st.pool_prio[p], st.pool_ub[p] = ps, pp, pu
            overflow.append(over)
            stats.append(stat)
        return overflow, torch.stack(stats), fresh, bounds

    def step(self, st: ShardedEngineState,
             max_inner: Optional[int] = None) -> ShardedEngineState:
        """Advance every shard one super-step, or at ``steps_per_sync > 1``
        one macro-step of up to ``min(T, max_inner)`` super-steps; then
        spill, refill, rebalance.  ``max_inner`` caps the inner steps so
        that a step budget cuts at the same step for any ``steps_per_sync``
        and ``sync_every``.  Updates ``st`` in place and returns it."""
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
                overflow, stats, _, _ = self._super_step(st)
            with self._span("engine.host_sync"):
                # each name -> one value a shard
                stats = dict(zip(_STAT_NAMES, zip(*stats.tolist())))
            self._windows.collect()
            st.steps += 1
            st.syncs += 1          # one bound exchange a step
            st.host_syncs += 1
            st.expanded += sum(stats["expanded"])
            st.candidates += sum(stats["created"])
            st.pruned += sum(stats["pruned"])
            st.threshold = stats["threshold"][0]   # the same on every shard
            with self._span("engine.spill"):
                for vpq, block, n in zip(st.vpqs, overflow,
                                         stats["overflow"]):
                    if n:   # the valid rows lead the block; ship only those
                        vpq.maybe_push(*(x[:n].cpu().numpy() for x in block))
            self._refill_rebalance(
                st, np.asarray(stats["pool_occupancy"], np.int64))
        self._after_step(st, 1, 1, stats, t0)
        return st

    # ------------------------------------------------------------ macro-step
    def _accumulator(self):
        """The overflow accumulators ``(states, prio, ub)``, one block of
        ``acc_cap`` rows plus one spare ``[B + M]`` block a shard
        (:meth:`Engine._accumulator`'s layout, stacked).  Made once per
        engine."""
        if self._acc is None:
            eng, dev = self._eng, self.device
            shape = (self.shards, eng.acc_cap + eng.B + eng.M)
            self._acc = (
                torch.zeros(shape + (self.S,), dtype=torch.int32, device=dev),
                torch.full(shape, NEG, dtype=torch.int32, device=dev),
                torch.full(shape, NEG, dtype=torch.int32, device=dev))
        return self._acc

    def _cont_flag(self, vpq_nonempty: bool, t_max: int, t, w, occ):
        """The reference's global exit vote (``_cont_flag`` with
        ``any_reduce``), on the device, after a segment: go on while steps
        remain, no shard needs the host — shard ``i`` does when its next
        segment's ``K`` blocks might not fit (``w_i + K·(B+M) > acc_cap``),
        or when it is below the ``C//2`` watermark while any queue held
        work at entry or any accumulator holds some (the rebalancer can
        move any shard's spill) — and some shard's pool is not empty."""
        eng = self._eng
        room = (w + self.K * (eng.B + eng.M)) <= eng.acc_cap
        low = occ < (self.C // 2)
        refillable = (w > 0).any() | vpq_nonempty
        need_host = (~room | (low & refillable)).any()
        return (t < t_max) & ~need_host & (occ > 0).any()

    def _macro_impl(self, st: ShardedEngineState, t_max: int,
                    vpq_nonempty: bool) -> torch.Tensor:
        """``t_max`` super-steps of every shard enqueued with no host read:
        the reference's ``_macro_segmented`` and, at ``sync_every = 1``
        (every step a head, a vote after each), its ``_macro_flat``.

        The schedule is static: step ``j`` is a segment head when ``j % K
        == 0``; the vote is taken after a segment's last step (or
        ``t_max``'s).  The first segment always runs, and a live segment
        runs to its end for every shard (a drained shard's steps are
        natural no-ops); after a vote to stop, ``active`` is false and
        every step left is an exact no-op.  Each shard's overflow block
        goes into its accumulator at its own watermark ``w_i``.  The
        threshold reported is the last live head's exchange (gated by
        ``active``, so a head after the exit does not move it), the
        host's late-pruning cutoff.  Updates the pools and result sets in
        ``st``; returns one int64 tensor, a row a shard: steps, expanded,
        created, pruned, ``w_i``, occupancy, threshold, then under
        ``record_bound_trace`` the ``T`` bounds used and the ``T`` fresh
        exchanges (a step past the live ones reads ``NEG``)."""
        eng, dev, shards, K = self._eng, self.device, self.shards, self.K
        acc = self._accumulator()
        trace = bool(self.cfg.record_bound_trace)
        rows = torch.arange(eng.B + eng.M, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        t = torch.zeros((), dtype=torch.int64, device=dev)
        w = torch.zeros((shards,), dtype=torch.int64, device=dev)
        sums = torch.zeros((shards, 3), dtype=torch.int64, device=dev)
        stale = torch.full((), NEG, dtype=torch.int32, device=dev)
        used = torch.full((shards, self.T), NEG, dtype=torch.int32,
                          device=dev)
        fresh_tr = used.clone()
        for j in range(t_max):
            head = j % K == 0
            overflow, stats, fresh, bounds = self._super_step(
                st, active, None if head else stale, trace)
            with self._pass("pass.accumulate"):
                if head:
                    stale = torch.where(active, fresh, stale)
                for i, block in enumerate(overflow):
                    dst = w[i] + rows
                    for a, x in zip(acc, block):
                        a[i].index_copy_(0, dst, x)
                w = w + stats[:, 5]
                sums = sums + stats[:, :3]
                t = t + active
                if trace:
                    used[:, j] = torch.stack(bounds)
                    fresh_tr[:, j] = fresh
                if (j + 1) % K == 0 or j + 1 == t_max:
                    # a no-op step leaves occupancy as it was, so the last
                    # step's is the last live step's
                    active = active & self._cont_flag(
                        vpq_nonempty, t_max, t, w, stats[:, 3])
        cols = [t.expand(shards)[:, None], sums, w[:, None], stats[:, 3:4],
                stale.long().expand(shards)[:, None]]
        if trace:
            cols += [used.long(), fresh_tr.long()]
        return torch.cat(cols, dim=1)

    def _macro_step(self, st: ShardedEngineState,
                    t_cap: int) -> ShardedEngineState:
        """One macro-step of up to ``t_cap`` super-steps and one host read;
        then each shard's accumulator prefix to its queue, refill and
        rebalance."""
        t0 = time.perf_counter() if self.obs.enabled else 0.0
        with self._span("engine.step"):
            self._windows.anchor()      # the device is idle here
            with self._span("engine.device_compute"):
                out = self._macro_impl(st, t_cap,
                                       any(len(v) for v in st.vpqs))
            with self._span("engine.host_sync"):
                out = np.asarray(out.tolist(), np.int64)
            self._windows.collect()
            n = int(out[0, 0])            # one exit vote: every shard's
            syncs = -(-n // self.K)       # one exchange a segment begun
            st.steps += n
            st.syncs += syncs
            st.host_syncs += 1
            stats = dict(expanded=out[:, 1], created=out[:, 2],
                         pruned=out[:, 3])
            st.expanded += int(stats["expanded"].sum())
            st.candidates += int(stats["created"].sum())
            st.pruned += int(stats["pruned"].sum())
            st.threshold = int(out[0, 6])
            if self.cfg.record_bound_trace:
                T = self.T
                st.bound_used.append(out[:, 7:7 + n])
                st.bound_fresh.append(out[:, 7 + T:7 + T + n])
            if out[:, 4].any():   # ship each shard's valid prefix
                with self._span("engine.spill"):
                    for i, (vpq, w) in enumerate(zip(st.vpqs, out[:, 4])):
                        if w:
                            vpq.push_from_device(*(a[i, :w]
                                                   for a in self._acc))
            self._refill_rebalance(st, out[:, 5].copy())
        self._after_step(st, n, syncs, stats, t0)
        return st

    def _after_step(self, st: ShardedEngineState, n_steps: int,
                    n_syncs: int, stats: dict, t0: float) -> None:
        """Record one step() call's metrics (no-op handles when off)."""
        eng = self._eng
        eng._m_steps.inc(n_steps)
        eng._m_host_syncs.inc()
        self._m_syncs.inc(n_syncs)
        eng._m_expanded.inc(int(sum(stats["expanded"])))
        eng._m_candidates.inc(int(sum(stats["created"])))
        eng._m_pruned.inc(int(sum(stats["pruned"])))
        eng._g_occupancy.set(int(st.pool_occupancy.sum()))
        eng._g_threshold.set(st.threshold)
        if self.obs.enabled:
            eng._h_step.observe(time.perf_counter() - t0)

    # ----------------------------------------------------- refill/rebalance
    def _refill_rebalance(self, st: ShardedEngineState,
                          occ: np.ndarray) -> None:
        """Refill each shard below the ``C/2`` watermark from its own queue,
        then move spilled work to the shards that cannot refill themselves,
        and insert what each shard got; sets ``pool_occupancy`` and
        ``done``."""
        shards, C = self.shards, self.C
        blocks = [[] for _ in range(shards)]   # (states, prio, ub) pops
        fill = np.zeros(shards, np.int64)
        # refill: per shard, below the C/2 watermark, from its own queue
        if any(occ[i] < C // 2 and len(st.vpqs[i]) for i in range(shards)):
            with self._span("engine.refill"):
                for i in range(shards):
                    if occ[i] < C // 2 and len(st.vpqs[i]):
                        chunk = st.vpqs[i].pop_chunk(
                            C - int(occ[i]), min_ub=st.threshold)
                        r = len(chunk[1])
                        if r:
                            blocks[i].append(chunk)
                            fill[i] = r
                            st.refilled += r
                            self._eng._m_refilled.inc(r)

        # rebalance: shards that cannot refill themselves pull spilled work
        # from the most-loaded queues (the donor pop is a sorted k-way
        # merge, the insert a merge-sort: priority order is kept)
        needy = [i for i in range(shards)
                 if occ[i] + fill[i] < C // 2 and len(st.vpqs[i]) == 0]
        if needy:
            with self._span("engine.rebalance"):
                donors = sorted(
                    (i for i in range(shards) if len(st.vpqs[i])),
                    key=lambda i: -len(st.vpqs[i]))
                for i in needy:
                    for d in donors:
                        room = C // 2 - int(occ[i] + fill[i])
                        if room <= 0:
                            break
                        if not len(st.vpqs[d]):
                            continue
                        chunk = st.vpqs[d].pop_chunk(
                            min(room, len(st.vpqs[d])), min_ub=st.threshold)
                        m = len(chunk[1])
                        if m:
                            blocks[i].append(chunk)
                            fill[i] += m
                            st.rebalanced += m
                            self._m_rebalanced.inc(m)

        if fill.any():
            with self._pass("pass.refill"):
                self._insert_blocks(st, blocks)
        st.pool_occupancy = occ + fill
        st.done = bool((st.pool_occupancy == 0).all()
                       and all(len(v) == 0 for v in st.vpqs))

    def _insert_blocks(self, st: ShardedEngineState, blocks: list) -> None:
        """Merge-sort each shard's popped rows into its pool.  The reference
        inserts one ``[C]``-row block into every shard, its empty rows after
        the popped ones; here only the popped rows are uploaded, and a
        shard with none is left alone.  Both give the same pools, byte for
        byte: a pool is always sorted (the deal fills it in order, and the
        step and the insert leave the top ``C`` of a stable sort), so the
        block's empty rows sort after the pool's own, re-sorting a pool
        changes nothing, and the insert's overflow holds only empty rows,
        since occupancy + fill <= C."""
        eng = self._eng
        for i, chunks in enumerate(blocks):
            if not chunks:
                continue
            p, _ = self._slices(i)
            ps, pp, pu, *_ = eng._insert_impl(
                *((pool[p], eng._to_device(np.concatenate(parts)))
                  for pool, parts in zip(
                      (st.pool_states, st.pool_prio, st.pool_ub),
                      zip(*chunks))))
            st.pool_states[p], st.pool_prio[p], st.pool_ub[p] = ps, pp, pu

    # -------------------------------------------------------------- finalize
    def finalize(self, st: ShardedEngineState) -> EngineResult:
        """Merge the shards' result sets canonically, close the queues and
        package the result."""
        with self._span("engine.finalize"):
            res = self._finalize_impl(st)
            self._windows.collect()     # the last refill's, after the read
            return res

    def _finalize_impl(self, st: ShardedEngineState) -> EngineResult:
        result_states, result_keys = merge_topk(
            st.result_states, st.result_keys, self.k)
        per_shard = dict(
            spilled=[int(v.total_spilled) for v in st.vpqs],
            late_pruned=[int(v.total_late_pruned) for v in st.vpqs],
            vpq_backlog=[len(v) for v in st.vpqs],
            pool_occupancy=[int(x) for x in st.pool_occupancy])
        if self.cfg.record_bound_trace:
            # [shards, inner steps] traces as one list of ints a shard
            for name in ("bound_used", "bound_fresh"):
                parts = getattr(st, name)
                trace = (np.concatenate(parts, axis=1) if parts
                         else np.zeros((self.shards, 0), np.int64))
                per_shard[name] = [[int(x) for x in row] for row in trace]
        for v in st.vpqs:
            v.close()
        return EngineResult(
            result_states=result_states.cpu().numpy(),
            result_keys=result_keys.cpu().numpy(),
            steps=st.steps, candidates=st.candidates, expanded=st.expanded,
            pruned=st.pruned,
            spilled=sum(per_shard["spilled"]), refilled=st.refilled,
            rebalanced=st.rebalanced,
            late_pruned=sum(per_shard["late_pruned"]), syncs=st.syncs,
            host_syncs=st.host_syncs, per_shard=per_shard)

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, mgr: CheckpointManager, st: ShardedEngineState,
                        blocking: bool = False) -> None:
        """Persist ``st`` through ``mgr``'s atomic-commit protocol: one
        manifest covers every shard, each shard's queue snapshot goes under
        ``vpq/shard{i}`` of the step directory (the reference's DESIGN.md
        §15).  The pools and result sets are copied to the host, in the
        global layout, before this returns.  Not checkpointed, as in the
        reference: the ``record_bound_trace`` journals (a resumed run's
        ``per_shard`` traces cover only the steps after the resume) and the
        macro-step accumulator, which belongs to the engine."""
        scalars = {name: getattr(st, name) for name in _CKPT_SCALARS}
        scalars["pool_occupancy"] = [int(x) for x in st.pool_occupancy]

        def capture(tmp_dir: str) -> dict:
            vpqs = [v.snapshot(os.path.join(tmp_dir, "vpq", f"shard{i}"))
                    for i, v in enumerate(st.vpqs)]
            return {"kind": "sharded_engine", "shards": self.shards,
                    "scalars": scalars, "vpqs": vpqs}

        mgr.save(st.steps, self._eng._ckpt_arrays(st), blocking=blocking,
                 capture=capture)

    def resume(self, source,
               step: Optional[int] = None) -> ShardedEngineState:
        """Rebuild a :class:`ShardedEngineState` on this engine's device
        from a committed checkpoint (a directory or a
        :class:`CheckpointManager`; the newest step unless ``step`` is
        given), written by this package or by the reference at the same
        shard count.  Each shard's spill files are linked into
        ``cfg.spill_dir/shard{i}`` (a fresh temp dir when ``spill_dir`` is
        None)."""
        mgr = (source if isinstance(source, CheckpointManager)
               else CheckpointManager(source, obs=self.obs))
        manifest = mgr.read_manifest(step)
        step = manifest["step"]
        extra = manifest["extra"]
        if extra is None or extra.get("kind") != "sharded_engine":
            raise ValueError(
                f"step {step} in {mgr.dir} is not a sharded-engine "
                f"checkpoint")
        if extra["shards"] != self.shards:
            raise ValueError(
                f"checkpoint written at shards={extra['shards']}, engine "
                f"configured with shards={self.shards}")
        like = {leaf["name"]: np.zeros(
            [int(s) for s in leaf["shape"]], np.dtype(leaf["dtype"]))
            for leaf in manifest["leaves"]}
        tree = mgr.restore(like, step=step)
        vpqs = [VirtualPriorityQueue.restore(
            vman, os.path.join(mgr.path(step), "vpq", f"shard{i}"),
            spill_dir=(os.path.join(self.cfg.spill_dir, f"shard{i}")
                       if self.cfg.spill_dir is not None else None),
            obs=self.obs) for i, vman in enumerate(extra["vpqs"])]
        scalars = dict(extra["scalars"])
        occ = np.asarray(scalars.pop("pool_occupancy"), np.int64)
        return ShardedEngineState(
            vpqs=vpqs, pool_occupancy=occ,
            **{name: self._eng._to_device(a) for name, a in tree.items()},
            **scalars)

    # ------------------------------------------------------------------- run
    def run(self, progress_every: int = 0,
            resume: bool = False) -> EngineResult:
        """Run to completion (or ``max_steps``), with
        :meth:`Engine.run`'s checkpoint contract: with
        ``cfg.checkpoint_every > 0`` and a ``cfg.checkpoint_dir``, the
        state is saved at the first host read every ``checkpoint_every``
        steps after the last save (between macro-steps at ``steps_per_sync
        > 1``), and once more at the end; ``resume=True`` continues from
        the newest committed step there (a fresh start when none is
        committed)."""
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
                print(f"[{self.comp.name}/x{self.shards}] step={st.steps} "
                      f"occ={st.pool_occupancy.tolist()} "
                      f"vpq={[len(v) for v in st.vpqs]} "
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
