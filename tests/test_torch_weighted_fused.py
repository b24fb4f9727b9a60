"""The maximum-weight clique's fused computation (``repro_torch.core.clique``
with ``weights``: the weighted AND-popcount by weight bit planes, the
weighted child rows) against its pointwise form
(``make_pointwise_weighted_clique_computation``, the plain path):
scores, bounds, seeds, child rows and whole engine runs at T 1 and 16 on
seeded graphs and weights, on the CPU; and the wrappers' kernel branches up
to the launch."""
import numpy as np
import pytest
import torch

from repro_torch.core import bitset, engine
from repro_torch.core.weighted_clique import (
    make_pointwise_weighted_clique_computation,
    make_weighted_clique_computation)
from repro_torch.data import synthetic_graphs as gen
from repro_torch.kernels import clique_children as cc
from repro_torch.kernels import masked_intersect as mi
from repro_torch.kernels import weighted_intersect as wi

torch.set_num_threads(2)

COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "syncs", "host_syncs")


def _case(seed, n=120, m=700, top=256):
    g = gen.densifying_graph(n, m, seed=seed)
    weights = np.random.default_rng([seed, 7]).integers(1, top, g.n)
    return g, weights


def _both(seed, **kw):
    g, weights = _case(seed, **kw)
    return (make_weighted_clique_computation(g, weights, device="cpu"),
            make_pointwise_weighted_clique_computation(g, weights,
                                                       device="cpu"),
            g, weights)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_callbacks_equal_the_pointwise_ones(seed):
    fused, plain, g, _ = _both(seed)
    for a, b in zip(fused.init_frontier(), plain.init_frontier()):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    states = fused.init_frontier()[0]
    rng = np.random.default_rng(seed)
    # seeds, then their children: P narrower than a seed's
    kids = plain.materialize(states[:40], torch.from_numpy(
        rng.integers(0, g.n, 40)))
    for batch in (states[::5], kids, torch.zeros_like(states[:3])):
        for a, b in zip(fused.score_children(batch),
                        plain.score_children(batch)):
            assert torch.equal(a, b)
        assert torch.equal(fused.result_key(batch), plain.result_key(batch))
        assert torch.equal(fused.upper_bound(batch),
                           plain.upper_bound(batch))
        acts = torch.from_numpy(rng.integers(0, g.n, batch.shape[0]))
        assert torch.equal(fused.materialize(batch, acts),
                           plain.materialize(batch, acts))


@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("pool", [64, 4096], ids=["spill", "roomy"])
def test_fused_engine_run_equals_the_pointwise_one(seed, t, pool):
    fused, plain, _, _ = _both(seed)
    cfg = engine.EngineConfig(k=4, batch=8, pool_capacity=pool,
                              steps_per_sync=t)
    got = engine.Engine(fused, cfg).run()
    want = engine.Engine(plain, cfg).run()
    assert got.result_keys.tobytes() == want.result_keys.tobytes()
    assert got.result_states.tobytes() == want.result_states.tobytes()
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    if pool == 64:
        assert got.spilled > 0 and got.late_pruned > 0


@pytest.mark.parametrize("valid_rows", [0, 5, 40],
                         ids=["none", "prefix", "all"])
@pytest.mark.parametrize("n", [70, 100], ids=["W3", "W4"])
def test_weighted_child_rows_equal_the_generic_materialize(n, valid_rows):
    """The plain weighted child rows (the fused computation's
    materialize_selected on the CPU) give the engine's generic expression
    with the pointwise materialize bit for bit, bit 31 of a word
    included."""
    fused, plain, g, _ = _both(n, n=n, m=4 * n)
    rng = np.random.default_rng(n)
    states_b = fused.init_frontier()[0][torch.from_numpy(
        rng.integers(0, n, 12))]
    parent = torch.from_numpy(rng.integers(0, 12, 40))
    action = torch.from_numpy(rng.integers(0, n, 40))
    action[:n // 32] = torch.arange(31, n, 32)[:40]
    valid = torch.arange(40) < valid_rows
    want = torch.where(valid[:, None],
                       plain.materialize(states_b[parent], action), 0)
    got = fused.materialize_selected(states_b, parent, action, valid)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("top", [2, 200, 1 << 20])
def test_weighted_intersect_equals_its_plain_version(top):
    rng = np.random.default_rng(top)
    n = 75
    w = bitset.num_words(n)
    weights = rng.integers(1, top, n)
    a = bitset.to_tensor(bitset.from_bool(rng.random((9, n)) < 0.5), "cpu")
    b = bitset.to_tensor(bitset.from_bool(rng.random((n, n)) < 0.3), "cpu")
    planes = wi.weight_planes(weights, "cpu")
    assert planes.shape == (max(1, int(weights.max()).bit_length()), w)
    want = wi.weighted_intersect_plain(a, b, torch.from_numpy(
        weights.astype(np.int32)))
    assert torch.equal(wi.weighted_intersect(a, b, planes), want)
    # the plain version's chunks of columns change nothing
    assert torch.equal(wi.weighted_intersect_plain(a, b, torch.from_numpy(
        weights.astype(np.int32)), max_elements=2 * n), want)
    assert torch.equal(wi.weighted_popcount(b, planes), torch.from_numpy(
        (bitset.to_bool(b, n).numpy() * weights).sum(1).astype(np.int32)))


def test_weight_planes_hold_each_weights_bits():
    weights = np.array([1, 2, 3, 255, 128, 7] * 7)
    planes = wi.weight_planes(weights, "cpu")
    got = bitset.to_bool(planes, len(weights)).numpy()
    assert got.shape == (8, len(weights))
    for k in range(8):
        assert (got[k] == ((weights >> k) & 1).astype(bool)).all()


def test_the_weighted_scoring_takes_the_mma_kernel_once():
    """At the benchmark's shape the K B rows are one call of the mma
    kernel (K 8, B 64: 512 rows, N = 46,336 columns)."""
    assert mi._plan(46336, 1448, True) == mi.mma_plan(1448, True)


def test_cpu_paths_do_not_count_launches():
    fused, _, g, _ = _both(0)
    states = fused.init_frontier()[0][:8]
    cc.reset_launches()
    wi.reset_launches()
    fused.score_children(states)
    fused.materialize_selected(states, torch.zeros(4, dtype=torch.int64),
                               torch.arange(4), torch.ones(4, dtype=bool))
    assert cc.launches == cc.weighted_launches == wi.launches == 0


def test_weights_are_checked():
    g, weights = _case(0)
    for bad in (np.zeros(g.n, int), np.ones(g.n - 1, int),
                np.full(g.n, 2 ** 30 // g.n + 1)):
        with pytest.raises(ValueError):
            make_weighted_clique_computation(g, bad, device="cpu")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper takes
    its kernel branch up to the launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _patch_launch(monkeypatch):
    launched = []
    monkeypatch.setattr(cc.build, "launch",
                        lambda name, argtypes, *args: launched.append(
                            (name, args)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    empty = torch.empty
    made = []
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        made.append(empty(*a, **kw)) or made[-1])
    return launched, made


def test_weighted_clique_children_hands_the_kernel_its_operands(monkeypatch):
    """One C call of the clique rows' entry: the five operands' pointers,
    the weights', the output's, then M, B, N and W; it counts as a weighted
    launch and not as a clique one."""
    launched, made = _patch_launch(monkeypatch)
    monkeypatch.setattr(cc, "launches", 0)
    monkeypatch.setattr(cc, "weighted_launches", 0)
    operands = (torch.zeros((5, 8), dtype=torch.int32),
                torch.zeros(7, dtype=torch.int64),
                torch.zeros(7, dtype=torch.int64),
                torch.zeros(7, dtype=torch.bool),
                torch.zeros((100, 3), dtype=torch.int32),
                torch.ones(100, dtype=torch.int32))
    out = cc.weighted_clique_children(*(t.as_subclass(_OnCard)
                                        for t in operands))
    ((name, args),) = launched
    assert name == "clique_children"
    assert (cc.launches, cc.weighted_launches) == (0, 1)
    assert out is made[0] and out.shape == (7, 8) and \
        out.dtype == torch.int32
    assert args == (*(t.data_ptr() for t in operands), out.data_ptr(), 7, 5,
                    100, 3, 0)


@pytest.mark.parametrize("bad", ["weights_dtype", "weights_length"])
def test_weighted_clique_children_rejects_bad_weights(bad):
    states_b = torch.zeros((4, 8), dtype=torch.int32)
    ext = torch.zeros((100, 3), dtype=torch.int32)
    parent = action = torch.zeros(6, dtype=torch.int64)
    valid = torch.ones(6, dtype=torch.bool)
    weights = torch.ones(100, dtype=torch.int32)
    if bad == "weights_dtype":
        weights = weights.to(torch.int64)
    else:
        weights = weights[:99]
    with pytest.raises((TypeError, ValueError)):
        cc.weighted_clique_children(states_b, parent, action, valid, ext,
                                    weights)


def test_weighted_intersect_makes_one_masked_intersect_call(monkeypatch):
    """On the card: one call of the 1-bit kernel over the K B rows, plane
    major, each row the batch's row ANDed with its plane, then counted as
    one launch."""
    calls = []

    def fake(rows, cols, mask=None):
        calls.append((rows, cols, mask))
        return torch.zeros((rows.shape[0], cols.shape[0]), dtype=torch.int32)
    monkeypatch.setattr(wi, "masked_intersect", fake)
    monkeypatch.setattr(wi, "launches", 0)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (6, 3),
                                      dtype=np.int64).astype(np.int32))
    cols = torch.zeros((70, 3), dtype=torch.int32)
    planes = wi.weight_planes(rng.integers(1, 20, 70), "cpu")
    wi.weighted_intersect(a.as_subclass(_OnCard), cols, planes)
    ((rows, got_cols, mask),) = calls
    assert mask is None and got_cols is cols and wi.launches == 1
    assert torch.equal(torch.Tensor(rows).view(planes.shape[0], 6, 3),
                       planes[:, None, :] & a[None])

