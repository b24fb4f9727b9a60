"""Virtual priority queue — the paper's on-disk subgraph management (§5).

A numpy copy of ``repro.core.vpq`` with the same merge order, so spill and
refill are byte-identical to the reference, and with its checkpoint
:meth:`~VirtualPriorityQueue.snapshot` / :meth:`~VirtualPriorityQueue.restore`
under the same manifest keys and file names, so a queue that the reference
checkpointed restores here and the other way round.

The device pool (HBM) holds the high-priority states; when it overflows,
the lowest-priority entries exit the engine step as a block and are
spilled here as **sorted runs** — exactly the paper's design:

* spill creates a run sorted in decreasing priority ("stores the others on
  disk in order of decreasing priority");
* dequeue/refill performs a **buffered k-way merge** over run heads
  (external-merge-sort style, "a small number of disk seeks"):
  each run keeps an in-memory block buffer; a blockwise merge over the
  buffers yields the globally highest entries.  The merge is vectorized
  (DESIGN.md §13): instead of one heap pop per entry, the priorities of
  every live run's buffered block are pulled at once, concatenated, and
  stably argsorted by descending priority; the *safe prefix* — entries no unbuffered tail can
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

On a card, a queue given ``pinned_rows`` stages its device traffic through
page-locked host rows (:class:`PinnedRows`): :meth:`~VirtualPriorityQueue.
push_from_device` copies an overflow block into them after the pending
blocks, where it stays until its run is written, and :meth:`~
VirtualPriorityQueue.pop_chunk` writes a refill into them for
:meth:`~VirtualPriorityQueue.upload`.  A queue borrows its rows at first use
and gives them back at :meth:`~VirtualPriorityQueue.close`; the process
keeps at most one set that no queue holds, so the page-locked memory is one
set a spilling query at once, plus one.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import NOOP

NEG = np.iinfo(np.int32).min


def _link_or_copy(src: str, dst: str) -> None:
    """Reference ``src`` at ``dst`` without copying data: a hardlink where
    the filesystem allows it (same device — the normal case for a
    checkpoint dir next to the spill dir), byte copy as the fallback.
    Spill-run ``.npy`` files are write-once immutable, so a link is as
    good as a copy — and deleting either name leaves the other readable.
    """
    if os.path.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


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
        # one sequential block read per refill (the paper's buffering); a
        # host run is in memory already and never written, so its block is
        # a view
        time_it = self._paths is not None and self._obs.enabled
        t0 = time.perf_counter() if time_it else 0.0
        read = np.asarray if self._paths is None else np.array
        self._bstates = read(self._states[s:e])
        self._bprio = read(self._prio[s:e])
        self._bub = read(self._ub[s:e])
        if time_it:
            self._obs.counter("vpq_disk_read_seconds_total").inc(
                time.perf_counter() - t0)

    def head_prio(self) -> int:
        return int(self._bprio[self.cursor - self._buf_start])

    def pop(self):
        i = self.cursor - self._buf_start
        out = (self._bstates[i], int(self._bprio[i]), int(self._bub[i]))
        self.cursor += 1
        if self.cursor < self.n and self.cursor - self._buf_start >= \
                len(self._bprio):
            self._fill_buffer()
        return out

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

    @classmethod
    def _restore(cls, n: int, cursor: int, buffer_size: int,
                 arrays=None, paths=None, obs=NOOP) -> "_Run":
        """Rebuild a run from checkpointed data: host arrays (already
        sliced to the unconsumed remainder, cursor 0) or disk file paths
        (full run files, cursor preserved).  Byte parity needs only the
        unconsumed suffix in original order — consumed entries are never
        compared again, and the blockwise merge's emitted order and
        consumption stop point are invariant to buffer alignment."""
        run = cls.__new__(cls)
        run.n = n
        run.cursor = cursor
        run.buffer_size = buffer_size
        run._buf_start = 0
        run._obs = obs
        if paths is not None:
            run._paths = dict(paths)
            run._states = np.load(paths["states"], mmap_mode="r")
            run._prio = np.load(paths["prio"], mmap_mode="r")
            run._ub = np.load(paths["ub"], mmap_mode="r")
        else:
            run._paths = None
            run._states, run._prio, run._ub = arrays
        run._fill_buffer()
        return run


def _pinned_empty(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, pin_memory=True)


class PinnedRows:
    """Page-locked host rows of one queue: ``spill``, ``[rows, S]`` states
    and ``[rows]`` priorities and bounds that overflow blocks are copied
    into from the card, and ``refill``, ``[refill_rows]`` of each that a
    refill is popped into and uploaded from."""

    def __init__(self, rows: int, refill_rows: int, state_width: int):
        self.shape = (rows, refill_rows, state_width)
        self.spill, self.refill = (
            tuple(_pinned_empty(s) for s in ((r, state_width), (r,), (r,)))
            for r in (rows, refill_rows))


_IDLE: List[PinnedRows] = []      # at most one: the last given back
_IDLE_LOCK = threading.Lock()


def _borrow(shape: tuple) -> PinnedRows:
    with _IDLE_LOCK:
        if _IDLE and _IDLE[0].shape == shape:
            return _IDLE.pop()
    return PinnedRows(*shape)


def _give_back(rows: PinnedRows) -> None:
    with _IDLE_LOCK:
        _IDLE[:] = [rows]


class VirtualPriorityQueue:
    def __init__(self, state_width: int, backend: str = "host",
                 spill_dir: Optional[str] = None,
                 buffer_size: int = 8192,
                 run_flush_size: int = 1 << 15,
                 obs=None, pinned_rows: Optional[Tuple[int, int]] = None):
        """``pinned_rows``: on a card, the most rows that one
        :meth:`push_from_device` and one :meth:`pop_chunk` carry; the queue
        then stages them through page-locked rows (:class:`PinnedRows`)."""
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
        self.pinned_rows = pinned_rows
        self._pinned: Optional[PinnedRows] = None   # borrowed at first use
        self._popped_pinned = 0     # rows the last pop wrote into them
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

    def _staging(self) -> Optional[PinnedRows]:
        if self.pinned_rows is None or self.backend == "none":
            return None
        if self._pinned is None:
            block, refill = self.pinned_rows
            self._pinned = _borrow((self.run_flush_size + block, refill,
                                    self.state_width))
        return self._pinned

    # ------------------------------------------------------------------ push
    def maybe_push(self, states: np.ndarray, prio: np.ndarray,
                   ub: np.ndarray):
        """Spill the valid (prio > NEG) entries of an overflow block.

        A block whose every entry is valid is kept as it is, not copied,
        until its run is written: the caller hands it over and does not
        write into it again."""
        mask = prio > NEG
        if not mask.any():
            return
        if self.backend == "none":
            raise RuntimeError(
                "priority pool overflow with spill disabled; raise "
                "pool_capacity or enable the virtual priority queue")
        if not mask.all():
            states, prio, ub = states[mask], prio[mask], ub[mask]
        self.total_spilled += len(prio)
        self._m_spilled.inc(len(prio))
        self._m_spill_bytes.inc(states.nbytes + prio.nbytes + ub.nbytes)
        self._pending.append((states, prio, ub))
        self._pending_n += len(prio)
        if self._pending_n >= self.run_flush_size:
            self._flush_pending()

    def push_from_device(self, states: torch.Tensor, prio: torch.Tensor,
                         ub: torch.Tensor):
        """:meth:`maybe_push` of a block of tensors: with ``pinned_rows``,
        copied into the page-locked rows right after the pending entries
        (fewer than ``run_flush_size`` between pushes, so a block of the
        size given fits), where an all-valid block stays until its run is
        written, so the rows from the pending count on are always free;
        else, or where the block is larger, copied to host memory of its
        own."""
        block, n = (states, prio, ub), prio.shape[0]
        pinned, at = self._staging(), self._pending_n
        if pinned is not None and at + n <= pinned.shape[0]:
            self.maybe_push(*(dst[at:at + n].copy_(src).numpy()
                              for dst, src in zip(pinned.spill, block)))
        else:       # numpy() of a CPU tensor is a view: copy
            self.maybe_push(*(x.numpy().copy() if x.device.type == "cpu"
                              else x.cpu().numpy() for x in block))

    def _flush_pending(self):
        """Write the pending blocks as one run in decreasing priority: the
        pending entries in the order of a reversed stable argsort, each
        block's state rows scattered once into the run's array."""
        if not self._pending:
            return
        prio = np.concatenate([p[1] for p in self._pending])
        ub = np.concatenate([p[2] for p in self._pending])
        order = np.argsort(prio, kind="stable")[::-1]  # decreasing priority
        where = np.empty(len(order), np.int64)         # entry -> run row
        where[order] = np.arange(len(order))
        states = np.empty((len(order), self.state_width),
                          np.result_type(*(p[0] for p in self._pending)))
        at = 0
        for block, _, _ in self._pending:
            states[where[at:at + len(block)]] = block
            at += len(block)
        self.runs.append(_Run(
            states, prio[order], ub[order],
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

        Vectorized merge: each round concatenates the priorities of every
        live run's buffered block and stably argsorts them descending, so the global
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
        later entries (dominated or not) in their runs.  Only the kept
        entries' state rows are copied, each once from its run's block
        into the output: with ``pinned_rows``, the page-locked refill rows
        where ``n`` fits (valid until the next pop; :meth:`upload`), else
        arrays of their own.
        """
        self._flush_pending()
        pinned = self._staging()
        self._popped_pinned = 0
        if pinned is not None and n <= pinned.shape[1]:
            out_s, out_p, out_u = (t.numpy() for t in pinned.refill)
        else:
            out_s = np.empty((max(n, 0), self.state_width), np.int32)
            out_p = np.empty(max(n, 0), np.int32)
            out_u = np.empty(max(n, 0), np.int32)
        got = 0
        need = n
        late_pruned0 = self.total_late_pruned
        live = [r for r in self.runs if not r.exhausted]
        while need > 0 and live:
            blocks = [r.buffered() for r in live]
            sizes = np.array([len(b[1]) for b in blocks], np.int64)
            prio = np.concatenate([b[1] for b in blocks]).astype(np.int64)
            run_of = np.repeat(np.arange(len(live), dtype=np.int64), sizes)
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
                end = got + len(kept)
                kept_run = run_of[kept]
                row = kept - (np.cumsum(sizes) - sizes)[kept_run]
                for j in np.unique(kept_run):
                    at = np.flatnonzero(kept_run == j)
                    out_s[got + at] = blocks[j][0][row[at]]
                out_p[got:end] = prio[kept]
                out_u[got:end] = ub[kept]
                got = end
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
        out = (out_s[:got], out_p[:got], out_u[:got])
        if pinned is not None and n <= pinned.shape[1]:
            self._popped_pinned = got
        self._m_refill_bytes.inc(sum(a.nbytes for a in out))
        return out

    def upload(self, chunk: tuple, device) -> List[torch.Tensor]:
        """``chunk``, what :meth:`pop_chunk` last returned, as tensors on
        ``device``: from the page-locked rows it was popped into, each copy
        blocking so that the next pop may write them again, or else from
        its own arrays."""
        n = len(chunk[1])
        if n and n == self._popped_pinned:
            return [t[:n].to(device, copy=True) for t in self._pinned.refill]
        return [torch.from_numpy(a).to(device) for a in chunk]

    def close(self):
        """Drop the runs and the pending entries (some of them views of
        the page-locked rows, which go back to the process here)."""
        for r in self.runs:
            r.close()
        self.runs = []
        self._pending, self._pending_n = [], 0
        if self._pinned is not None:
            _give_back(self._pinned)
            self._pinned = None
        if self._own_dir and self.spill_dir and os.path.isdir(self.spill_dir):
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    # ------------------------------------------------------ snapshot/restore
    def snapshot(self, out_dir: str) -> dict:
        """Checkpoint the queue into ``out_dir``; returns the JSON manifest
        :meth:`restore` rebuilds from (DESIGN.md §15).

        Disk runs are *referenced, not copied*: the write-once ``.npy`` run
        files are hardlinked into ``out_dir``, so the snapshot costs no
        data movement and survives the live engine deleting its own link
        when the run exhausts.  Host runs save only the unconsumed
        ``[cursor:]`` suffix.  Pending (unflushed) fragments are saved as
        one concatenated triple — ``_flush_pending`` concatenates before
        sorting anyway, so the restored queue flushes to an identical run.
        Crucially the snapshot never flushes pending itself: forcing a run
        boundary here would change merge tie order versus the
        uninterrupted trajectory.
        """
        os.makedirs(out_dir, exist_ok=True)
        runs = []
        for j, r in enumerate(self.runs):
            if r._paths is not None:          # disk: link full files
                files = {}
                for name, src in r._paths.items():
                    fname = f"run{j}_{name}.npy"
                    _link_or_copy(src, os.path.join(out_dir, fname))
                    files[name] = fname
                runs.append({"kind": "disk", "n": int(r.n),
                             "cursor": int(r.cursor), "files": files})
            else:                             # host: save the remainder
                files = {}
                for name, arr in (("states", r._states), ("prio", r._prio),
                                  ("ub", r._ub)):
                    fname = f"run{j}_{name}.npy"
                    np.save(os.path.join(out_dir, fname),
                            np.asarray(arr[r.cursor:]))
                    files[name] = fname
                runs.append({"kind": "host", "n": int(r.n - r.cursor),
                             "cursor": 0, "files": files})
        pending = None
        if self._pending:
            pending = {}
            for i, name in enumerate(("states", "prio", "ub")):
                fname = f"pending_{name}.npy"
                np.save(os.path.join(out_dir, fname),
                        np.concatenate([p[i] for p in self._pending]))
                pending[name] = fname
        return {"state_width": self.state_width, "backend": self.backend,
                "buffer_size": self.buffer_size,
                "run_flush_size": self.run_flush_size,
                "run_id": self._run_id,
                "total_spilled": self.total_spilled,
                "total_late_pruned": self.total_late_pruned,
                "runs": runs, "pending": pending}

    @classmethod
    def restore(cls, manifest: dict, src_dir: str,
                spill_dir: Optional[str] = None, obs=None,
                pinned_rows: Optional[Tuple[int, int]] = None
                ) -> "VirtualPriorityQueue":
        """Rebuild a queue from :meth:`snapshot` output.

        Disk runs are re-linked from the checkpoint into the *live* spill
        dir under fresh run ids and re-opened memory-mapped read-only; the
        restored queue owns (and deletes, on exhaust/close) its live
        links, while the checkpoint's own files stay intact — so the same
        step restores any number of times.
        """
        vpq = cls(state_width=int(manifest["state_width"]),
                  backend=manifest["backend"], spill_dir=spill_dir,
                  buffer_size=int(manifest["buffer_size"]),
                  run_flush_size=int(manifest["run_flush_size"]),
                  obs=obs, pinned_rows=pinned_rows)
        vpq.total_spilled = int(manifest["total_spilled"])
        vpq.total_late_pruned = int(manifest["total_late_pruned"])
        vpq._run_id = int(manifest["run_id"])
        for entry in manifest["runs"]:
            if entry["kind"] == "disk":
                rid = vpq._run_id
                vpq._run_id += 1
                paths = {}
                for name, fname in entry["files"].items():
                    dst = os.path.join(vpq.spill_dir, f"run{rid}_{name}.npy")
                    _link_or_copy(os.path.join(src_dir, fname), dst)
                    paths[name] = dst
                vpq.runs.append(_Run._restore(
                    int(entry["n"]), int(entry["cursor"]),
                    vpq.buffer_size, paths=paths, obs=vpq.obs))
            else:
                arrays = tuple(
                    np.load(os.path.join(src_dir, entry["files"][name]))
                    for name in ("states", "prio", "ub"))
                vpq.runs.append(_Run._restore(
                    int(entry["n"]), int(entry["cursor"]),
                    vpq.buffer_size, arrays=arrays, obs=vpq.obs))
        if manifest.get("pending"):
            arrays = tuple(
                np.load(os.path.join(src_dir, manifest["pending"][name]))
                for name in ("states", "prio", "ub"))
            if len(arrays[1]):
                vpq._pending.append(arrays)
                vpq._pending_n = len(arrays[1])
        return vpq
