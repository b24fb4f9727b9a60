"""Virtual priority queue — the paper's on-disk subgraph management (§5).

A numpy copy of ``repro.core.vpq`` with the same merge order, so spill and
refill are byte-identical to the reference.  The checkpoint snapshot and
restore of the reference queue are not here yet (ROADMAP Queue 1, item 9).

The device pool (HBM) holds the high-priority states; when it overflows,
the lowest-priority entries exit the engine step as a block and are
spilled here as **sorted runs** — exactly the paper's design:

* spill creates a run sorted in decreasing priority ("stores the others on
  disk in order of decreasing priority");
* dequeue/refill performs a **buffered k-way merge** over run heads
  (external-merge-sort style, "a small number of disk seeks"):
  each run keeps an in-memory block buffer; a blockwise merge over the
  buffers yields the globally highest entries.  The merge is vectorized
  (DESIGN.md §13): instead of one heap pop per entry, every live run's
  buffered block is pulled at once, concatenated, and stably argsorted by
  descending priority; the *safe prefix* — entries no unbuffered tail can
  outrank — is consumed in bulk and per-run cursors advance by block.  The
  emitted order is byte-identical to the entry-at-a-time heap merge
  (priority descending, ties by run index then within-run position).

Backends: ``host`` (numpy arrays in host DRAM — the HBM:DRAM ratio of an
accelerator host mirrors the paper's DRAM:disk ratio) and ``disk`` (memory-mapped ``.npy``
runs with block reads — the literal reproduction used by
``benchmarks/bench_vpq.py`` for Figure 19).

Refill also applies **late dominance pruning**: entries whose stored upper
bound has fallen below the current k-th-result threshold are dropped during
the merge instead of being shipped back to the device; drops are counted in
:attr:`VirtualPriorityQueue.total_late_pruned` so pruning effectiveness
(a paper metric) is auditable end to end (``EngineResult.late_pruned``,
service response ``stats``).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np

from repro_torch.obs import NOOP

NEG = np.iinfo(np.int32).min


class _Run:
    """One sorted spill run with buffered sequential reads."""

    def __init__(self, states, prio, ub, backend: str, spill_dir: str,
                 run_id: int, buffer_size: int, obs=NOOP):
        self.n = len(prio)
        self.cursor = 0
        self.buffer_size = buffer_size
        self._buf_start = 0
        self._obs = obs
        if backend == "disk":
            t0 = time.perf_counter() if obs.enabled else 0.0
            self._paths = {}
            for name, arr in (("states", states), ("prio", prio), ("ub", ub)):
                path = os.path.join(spill_dir, f"run{run_id}_{name}.npy")
                np.save(path, arr)
                self._paths[name] = path
            if obs.enabled:
                obs.counter("vpq_disk_write_seconds_total").inc(
                    time.perf_counter() - t0)
            self._states = np.load(self._paths["states"], mmap_mode="r")
            self._prio = np.load(self._paths["prio"], mmap_mode="r")
            self._ub = np.load(self._paths["ub"], mmap_mode="r")
        else:
            self._paths = None
            self._states, self._prio, self._ub = states, prio, ub
        self._fill_buffer()

    def _fill_buffer(self):
        s, e = self.cursor, min(self.cursor + self.buffer_size, self.n)
        self._buf_start = s
        # one sequential block read per refill (the paper's buffering)
        time_it = self._paths is not None and self._obs.enabled
        t0 = time.perf_counter() if time_it else 0.0
        self._bstates = np.array(self._states[s:e])
        self._bprio = np.array(self._prio[s:e])
        self._bub = np.array(self._ub[s:e])
        if time_it:
            self._obs.counter("vpq_disk_read_seconds_total").inc(
                time.perf_counter() - t0)

    # ------------------------------------------------- blockwise merge API
    def buffered(self):
        """The not-yet-consumed slice of the current buffer block
        (states, prio, ub) — sorted in decreasing priority like the run."""
        i = self.cursor - self._buf_start
        return self._bstates[i:], self._bprio[i:], self._bub[i:]

    @property
    def has_unbuffered(self) -> bool:
        """True when entries exist beyond the current buffer block."""
        return self._buf_start + len(self._bprio) < self.n

    @property
    def tail_prio(self) -> int:
        """Priority of the last (smallest) buffered entry — an upper bound
        on every unbuffered entry of this run (the run is sorted)."""
        return int(self._bprio[-1])

    def consume(self, c: int):
        """Advance the cursor by ``c`` consumed entries; refill the buffer
        with the next sequential block when the current one is spent."""
        self.cursor += c
        if self.cursor < self.n and self.cursor - self._buf_start >= \
                len(self._bprio):
            self._fill_buffer()

    @property
    def exhausted(self) -> bool:
        return self.cursor >= self.n

    def close(self):
        if self._paths:
            for p in self._paths.values():
                try:
                    os.remove(p)
                except OSError:
                    pass

class VirtualPriorityQueue:
    def __init__(self, state_width: int, backend: str = "host",
                 spill_dir: Optional[str] = None,
                 buffer_size: int = 8192,
                 run_flush_size: int = 1 << 15,
                 obs=None):
        assert backend in ("host", "disk", "none")
        self.state_width = state_width
        self.backend = backend
        self.buffer_size = buffer_size
        self.run_flush_size = run_flush_size
        # observability handles, resolved once (DESIGN.md §16)
        self.obs = obs if obs is not None else NOOP
        self._m_spilled = self.obs.counter(
            "vpq_spilled_entries_total", "entries spilled off-device")
        self._m_spill_bytes = self.obs.counter(
            "vpq_spill_bytes_total", "bytes pushed into spill runs")
        self._m_refill_bytes = self.obs.counter(
            "vpq_refill_bytes_total", "bytes returned by pop_chunk")
        self._m_late_pruned = self.obs.counter(
            "vpq_late_pruned_total", "dominated entries dropped on refill")
        self.runs: List[_Run] = []
        self._pending: List[tuple] = []   # (states, prio, ub) awaiting a run
        self._pending_n = 0
        self._run_id = 0
        self.total_spilled = 0
        self.total_late_pruned = 0        # dominated entries dropped on refill
        self._own_dir = spill_dir is None and backend == "disk"
        self.spill_dir = (tempfile.mkdtemp(prefix="nuri_vpq_")
                          if self._own_dir else spill_dir)
        if backend == "disk" and not self._own_dir:
            os.makedirs(self.spill_dir, exist_ok=True)

    def __len__(self) -> int:
        return self._pending_n + sum(r.n - r.cursor for r in self.runs)

    # ------------------------------------------------------------------ push
    def maybe_push(self, states: np.ndarray, prio: np.ndarray,
                   ub: np.ndarray):
        """Spill the valid (prio > NEG) entries of an overflow block."""
        mask = prio > NEG
        if not mask.any():
            return
        if self.backend == "none":
            raise RuntimeError(
                "priority pool overflow with spill disabled; raise "
                "pool_capacity or enable the virtual priority queue")
        states, prio, ub = states[mask], prio[mask], ub[mask]
        self.total_spilled += len(prio)
        self._m_spilled.inc(len(prio))
        self._m_spill_bytes.inc(states.nbytes + prio.nbytes + ub.nbytes)
        self._pending.append((states, prio, ub))
        self._pending_n += len(prio)
        if self._pending_n >= self.run_flush_size:
            self._flush_pending()

    def _flush_pending(self):
        if not self._pending:
            return
        states = np.concatenate([p[0] for p in self._pending])
        prio = np.concatenate([p[1] for p in self._pending])
        ub = np.concatenate([p[2] for p in self._pending])
        order = np.argsort(prio, kind="stable")[::-1]  # decreasing priority
        self.runs.append(_Run(
            np.ascontiguousarray(states[order]), prio[order], ub[order],
            self.backend, self.spill_dir, self._run_id, self.buffer_size,
            obs=self.obs))
        self._run_id += 1
        self._pending, self._pending_n = [], 0

    # ------------------------------------------------------------------- pop
    def pop_chunk(self, n: int, min_ub: int = NEG):
        """Return the globally top-``n`` surviving spilled entries
        (blockwise k-way run merge), dropping — and counting in
        ``total_late_pruned`` — entries whose upper bound is dominated by
        ``min_ub``.

        Vectorized merge: each round concatenates every live run's buffered
        block and stably argsorts by descending priority, so the global
        order is (priority desc, run index asc, within-run position asc) —
        exactly the order an entry-at-a-time heap merge with run-index
        tie-break produces.  An entry is *safe* to emit when no run's
        unbuffered tail could outrank it: with ``bar`` the largest buffered
        tail among runs that still have unbuffered data and ``rmin`` the
        smallest such run index at ``bar``, the safe region is
        ``prio > bar`` plus ``prio == bar`` from runs ``<= rmin`` (ties
        resolve by run index, and unbuffered entries of run ``r`` sort
        after its buffered ones).  That region is a prefix of the merged
        order and always contains the ``bar`` run's own buffered block, so
        every round either emits entries or exhausts a run — no per-entry
        Python loop, cursors advance in bulk.

        Consumption stops as soon as ``n`` entries survive pruning, leaving
        later entries (dominated or not) in their runs.
        """
        self._flush_pending()
        out_s, out_p, out_u = [], [], []
        need = n
        late_pruned0 = self.total_late_pruned
        live = [r for r in self.runs if not r.exhausted]
        while need > 0 and live:
            blocks = [r.buffered() for r in live]
            prio = np.concatenate([b[1] for b in blocks]).astype(np.int64)
            run_of = np.concatenate(
                [np.full(len(b[1]), j, np.int64)
                 for j, b in enumerate(blocks)])
            order = np.argsort(-prio, kind="stable")

            bar, rmin = None, None
            for j, r in enumerate(live):
                if r.has_unbuffered:
                    t = r.tail_prio
                    if bar is None or t > bar:
                        bar, rmin = t, j
            if bar is None:
                n_safe = len(order)
            else:
                p_sorted = prio[order]
                safe = (p_sorted > bar) | ((p_sorted == bar)
                                           & (run_of[order] <= rmin))
                # monotone prefix of the merged order; never empty — the
                # bar run's own buffered block is entirely inside it
                n_safe = int(np.searchsorted(~safe, True))
            take = order[:n_safe]

            ub = np.concatenate([b[2] for b in blocks])
            keep = ub[take] >= min_ub            # late dominance pruning
            cum = np.cumsum(keep)
            kept_total = int(cum[-1]) if n_safe else 0
            if kept_total >= need:               # stop at the need-th keeper
                stop = int(np.searchsorted(cum, need)) + 1
            else:
                stop = n_safe
            sel = take[:stop]
            kmask = keep[:stop]
            kept = sel[kmask]
            self.total_late_pruned += int(stop - kmask.sum())

            if len(kept):
                states = np.concatenate([b[0] for b in blocks])
                out_s.append(states[kept])
                out_p.append(prio[kept].astype(np.int32))
                out_u.append(ub[kept])
                need -= len(kept)
            for j, c in enumerate(np.bincount(run_of[sel],
                                              minlength=len(live))):
                if c:
                    live[j].consume(int(c))
            live = [r for r in live if not r.exhausted]
        # close exhausted runs as they drop out so the disk backend's .npy
        # run files are deleted immediately instead of leaking until close()
        keep_runs = []
        for r in self.runs:
            if r.exhausted:
                r.close()
            else:
                keep_runs.append(r)
        self.runs = keep_runs
        self._m_late_pruned.inc(self.total_late_pruned - late_pruned0)
        if not out_p:
            return (np.zeros((0, self.state_width), np.int32),
                    np.zeros((0,), np.int32), np.zeros((0,), np.int32))
        out = (np.concatenate(out_s).astype(np.int32),
               np.concatenate(out_p),
               np.concatenate(out_u).astype(np.int32))
        self._m_refill_bytes.inc(sum(a.nbytes for a in out))
        return out

    def close(self):
        for r in self.runs:
            r.close()
        self.runs = []
        if self._own_dir and self.spill_dir and os.path.isdir(self.spill_dir):
            shutil.rmtree(self.spill_dir, ignore_errors=True)
