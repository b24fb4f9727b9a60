"""The spill queue's copies (``repro_torch.core.vpq``): ``maybe_push``
keeps an all-valid block as it is, ``_flush_pending`` writes a run with one
scatter a block, ``pop_chunk`` copies only the kept rows and a host run's
buffer is a view.  Against a copy of the earlier logic (masked copy on
every push; concatenate then reorder on flush; every buffered block
concatenated each merge round), the runs and every pop are byte for byte
the same, over many runs, late pruning and heavy ties."""
import numpy as np
import pytest

from repro_torch.core import vpq

NEG = vpq.NEG


class EarlierQueue(vpq.VirtualPriorityQueue):
    """The queue with the earlier ``maybe_push``, ``_flush_pending`` and
    ``pop_chunk``, verbatim."""

    def maybe_push(self, states, prio, ub):
        mask = prio > NEG
        if not mask.any():
            return
        states, prio, ub = states[mask], prio[mask], ub[mask]
        self.total_spilled += len(prio)
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
        order = np.argsort(prio, kind="stable")[::-1]
        self.runs.append(vpq._Run(
            np.ascontiguousarray(states[order]), prio[order], ub[order],
            self.backend, self.spill_dir, self._run_id, self.buffer_size,
            obs=self.obs))
        self._run_id += 1
        self._pending, self._pending_n = [], 0

    def pop_chunk(self, n, min_ub=NEG):
        self._flush_pending()
        out_s, out_p, out_u = [], [], []
        need = n
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
                n_safe = int(np.searchsorted(~safe, True))
            take = order[:n_safe]
            ub = np.concatenate([b[2] for b in blocks])
            keep = ub[take] >= min_ub
            cum = np.cumsum(keep)
            kept_total = int(cum[-1]) if n_safe else 0
            if kept_total >= need:
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
        self.runs = [r for r in self.runs if not r.exhausted]
        if not out_p:
            return (np.zeros((0, self.state_width), np.int32),
                    np.zeros((0,), np.int32), np.zeros((0,), np.int32))
        return (np.concatenate(out_s).astype(np.int32),
                np.concatenate(out_p),
                np.concatenate(out_u).astype(np.int32))


def _blocks(seed, width, steps):
    """Overflow blocks as the engines push them: some with invalid rows
    (NEG priorities) among the valid, some all valid (the valid prefix),
    some empty; priorities from a narrow range, so ties are many."""
    rng = np.random.default_rng(seed)
    for t in range(steps):
        m = int(rng.integers(0, 40))
        prio = rng.integers(50, 70, m).astype(np.int32)
        if t % 3:
            prio[rng.random(m) < 0.3] = NEG
        states = rng.integers(-2 ** 31, 2 ** 31, (m, width),
                              dtype=np.int64).astype(np.int32)
        ub = (prio + rng.integers(0, 8, m)).astype(np.int32)
        ub[prio == NEG] = NEG
        yield t, states, prio, ub


def _drive(cls, seed, width, buffer_size, flush, steps=300):
    q = cls(width, buffer_size=buffer_size, run_flush_size=flush)
    record = []
    threshold = 50
    for t, states, prio, ub in _blocks(seed, width, steps):
        # the queue is handed its own arrays: the engines' host copies
        q.maybe_push(states.copy(), prio.copy(), ub.copy())
        if t % 11 == 10:
            threshold += 1            # late pruning grows with the bound
            record.append(_popped(q.pop_chunk(int(t % 37) + 5, threshold)))
            record.append([(r.n, r.cursor, r._states.tobytes(),
                            r._prio.tobytes(), r._ub.tobytes())
                           for r in q.runs])
    while len(q):
        record.append(_popped(q.pop_chunk(17, threshold)))
    return record, q.total_spilled, q.total_late_pruned, q._run_id


def _popped(out):
    return [(a.dtype.str, a.shape, a.tobytes()) for a in out]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("buffer_size,flush", [(4, 16), (7, 50), (64, 8)])
def test_runs_and_pops_equal_the_earlier_logic(seed, buffer_size, flush):
    want = _drive(EarlierQueue, seed, 5, buffer_size, flush)
    got = _drive(vpq.VirtualPriorityQueue, seed, 5, buffer_size, flush)
    assert got == want
    assert got[2] > 0 and got[3] > 3       # late pruning, many runs


def test_an_all_valid_block_is_kept_and_a_masked_one_copied():
    q = vpq.VirtualPriorityQueue(2, run_flush_size=100)
    states = np.arange(6, dtype=np.int32).reshape(3, 2)
    prio = np.array([5, 4, 3], np.int32)
    q.maybe_push(states, prio, prio)
    assert q._pending[0][0] is states
    prio2 = np.array([5, NEG, 3], np.int32)
    q.maybe_push(states, prio2, prio2)
    assert q._pending[1][0] is not states and len(q._pending[1][0]) == 2


def test_a_host_runs_buffer_is_a_view_and_a_disk_runs_a_copy(tmp_path):
    states = np.arange(40, dtype=np.int32).reshape(20, 2)
    prio = np.arange(20, 0, -1).astype(np.int32)
    for backend, view in (("host", True), ("disk", False)):
        q = vpq.VirtualPriorityQueue(2, backend=backend, buffer_size=8,
                                     spill_dir=str(tmp_path / backend))
        q.maybe_push(states.copy(), prio.copy(), prio.copy())
        q._flush_pending()
        run = q.runs[0]
        assert np.shares_memory(run._bstates, run._states) == view
        popped = q.pop_chunk(20)
        assert popped[0].tobytes() == states.tobytes()
        q.close()


def test_pop_of_nothing_has_the_earlier_shapes():
    q = vpq.VirtualPriorityQueue(3)
    for a, b in zip(q.pop_chunk(5), EarlierQueue(3).pop_chunk(5)):
        assert a.dtype == b.dtype and a.shape == b.shape


# ------------------------------------------------- the page-locked rows
@pytest.fixture
def unpinned(monkeypatch):
    """The queue's page-locked rows as plain CPU rows, and a process pool
    of its own: the staging logic on a machine without a card."""
    import torch
    monkeypatch.setattr(vpq, "_pinned_empty", lambda shape: torch.empty(
        shape, dtype=torch.int32))
    monkeypatch.setattr(vpq, "_IDLE", [])
    return vpq._IDLE


def _tensor_blocks(rng, width, steps, big):
    import torch
    for t in range(steps):
        n = int(rng.integers(1, 30) if t % 9 else rng.integers(big // 2, big))
        states = rng.integers(-2 ** 31, 2 ** 31, (n, width),
                              dtype=np.int64).astype(np.int32)
        prio = rng.integers(5, 9, n).astype(np.int32)
        yield t, [torch.from_numpy(x) for x in (states, prio, prio + 2)]


def test_the_pinned_rows_keep_the_queues_runs_and_pops(unpinned):
    """Blocks pushed from tensors through the staging rows (each copied in
    after the pending rows; blocks that do not fit go as copies of their
    own) and pops written into the refill rows and uploaded give the runs
    and pops of a queue handed plain copies, byte for byte; an upload is a
    copy the next pop does not touch."""
    width, block, refill = 6, 30, 12
    q = vpq.VirtualPriorityQueue(width, run_flush_size=40, buffer_size=8,
                                 pinned_rows=(block, refill))
    plain = vpq.VirtualPriorityQueue(width, run_flush_size=40,
                                     buffer_size=8)
    rows = q.run_flush_size + block
    staged = 0
    uploads = []
    for t, tensors in _tensor_blocks(np.random.default_rng(0), width, 60,
                                     2 * rows):                # some too large
        at, n = q._pending_n, len(tensors[1])
        q.push_from_device(*tensors)
        plain.maybe_push(*(x.numpy().copy() for x in tensors))
        in_rows = q._pending_n == 0 or np.shares_memory(   # 0: a run
            q._pending[-1][0], q._pinned.spill[0].numpy())
        staged += at + n <= rows
        assert in_rows or at + n > rows
        assert q._pending_n == 0 or in_rows == (at + n <= rows)
        if t % 7 == 6:
            n_pop = 9 if t % 2 else 25                # fits refill / not
            chunk = q.pop_chunk(n_pop, 8)
            assert _popped(chunk) == _popped(plain.pop_chunk(n_pop, 8))
            assert np.shares_memory(chunk[0], q._pinned.refill[0].numpy()) \
                == (n_pop <= refill)
            up = q.upload(chunk, "cpu")
            assert [u.numpy().tobytes() for u in up] == \
                [c.tobytes() for c in chunk]
            uploads.append((up, [u.clone() for u in up]))
    assert 10 < staged < 60
    while len(plain):
        assert _popped(q.pop_chunk(9, 9)) == _popped(plain.pop_chunk(9, 9))
    assert q.total_late_pruned == plain.total_late_pruned > 0
    assert all(all(map(torch_equal, *u)) for u in uploads)


def torch_equal(a, b):
    return bool((a == b).all())


def test_the_pinned_rows_are_borrowed_and_given_back(unpinned):
    """Each queue borrows its rows at first use; two queues at once hold
    two sets; ``close`` drops the pending entries (views of the rows) and
    gives the rows back; the process keeps one set that no queue holds,
    which the next queue of its shape takes; a queue without
    ``pinned_rows`` takes none."""
    import torch
    idle = unpinned
    one = torch.ones(3, dtype=torch.int32)
    block = (torch.zeros((3, 4), dtype=torch.int32), one, one)
    a, b = (vpq.VirtualPriorityQueue(4, run_flush_size=10,
                                     pinned_rows=(5, 6)) for _ in range(2))
    assert a._pinned is None
    a.push_from_device(*block)
    b.push_from_device(*block)
    assert a._pinned is not b._pinned and idle == []
    held = a._pinned
    a.close()
    assert idle == [held] and a._pinned is None
    assert a._pending == [] and a._pending_n == 0 and len(a) == 0
    last = b._pinned
    b.close()
    assert idle == [last]                     # one idle set at most
    c = vpq.VirtualPriorityQueue(4, run_flush_size=10, pinned_rows=(5, 6))
    c.pop_chunk(3)
    assert c._pinned is last and idle == []
    d = vpq.VirtualPriorityQueue(4, run_flush_size=10, pinned_rows=(7, 6))
    d.push_from_device(*block)
    assert d._pinned.shape == (17, 6, 4)
    c.close()
    d.close()
    assert len(idle) == 1
    e = vpq.VirtualPriorityQueue(4)
    e.push_from_device(*block)
    assert e._pinned is None and len(e) == 3


@pytest.mark.parametrize("steps_per_sync", [1, 4])
def test_an_engine_staging_its_spill_runs_as_without(unpinned, monkeypatch,
                                                     steps_per_sync):
    """A whole engine run whose spill queue stages through the rows (the
    card's path, here on the CPU) equals one without, byte for byte and in
    every counter; each query gives its rows back, and the next takes
    them."""
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data import synthetic_graphs as gen

    comp = make_clique_computation(gen.densifying_graph(120, 1500, 3),
                                   device="cpu")
    cfg = EngineConfig(k=3, batch=8, pool_capacity=48,
                       steps_per_sync=steps_per_sync)
    want = Engine(comp, cfg).run()
    eng = Engine(comp, cfg)
    monkeypatch.setattr(eng, "_pinned_rows", lambda: (eng.B + eng.M,
                                                      eng.C))
    got = eng.run()
    assert want.spilled > 0 and want.refilled > 0
    for name in ("result_keys", "result_states"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()
    for name in ("steps", "candidates", "expanded", "pruned", "spilled",
                 "refilled", "late_pruned"):
        assert getattr(got, name) == getattr(want, name), name
    assert len(unpinned) == 1
    held = unpinned[0]
    again = eng.run()
    assert again.result_keys.tobytes() == want.result_keys.tobytes()
    assert unpinned == [held]
