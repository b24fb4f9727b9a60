"""The port's masked_intersect / frontier_expand on the CPU (the plain
PyTorch version) against repro's pure-jnp oracle and its Pallas kernel in
interpret mode, on the shape sweeps of tests/test_kernels.py; the plain
clique_children against the engine's generic materialize and repro's.
Exact equality:
this is integer work.  The Hopper kernels themselves run only on the card
(chip_smoke.py holds them against the plain versions there)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bitset as ref_bitset
from repro.core.clique import make_clique_computation as ref_make_clique
from repro.data import synthetic_graphs as ref_gen
from repro.kernels import masked_intersect as ref_mi
from repro.kernels import ref
from repro_torch.core import bitset
from repro_torch.core.clique import make_clique_computation
from repro_torch.data import synthetic_graphs as gen
from repro_torch.kernels import clique_children as cc
from repro_torch.kernels import masked_intersect as mi
from repro_torch.kernels import ops, ref as port_ref

torch.set_num_threads(2)


def _words(rng, *shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _t(u32):
    return torch.from_numpy(u32.view(np.int32))


def _pallas(a, cols, mask=None):
    return np.asarray(ref_mi.masked_intersect(
        jnp.asarray(a), jnp.asarray(cols),
        None if mask is None else jnp.asarray(mask), interpret=True))


@pytest.mark.parametrize("b,n,w", [(1, 16, 1), (13, 100, 7), (32, 257, 4),
                                   (8, 128, 32)])
def test_frontier_expand(b, n, w):
    rng = np.random.default_rng(b * n + w)
    p, ext = _words(rng, b, w), _words(rng, n, w)
    got = ops.frontier_expand(_t(p), _t(ext))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    want = np.asarray(ref.frontier_expand_ref(jnp.asarray(p),
                                              jnp.asarray(ext)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _pallas(p, ext))
    np.testing.assert_array_equal(
        port_ref.frontier_expand_ref(_t(p), _t(ext)).numpy(), want)


# the row kernel's cut-over (columns); narrow calls up to it take the row
# kernel on the card, wider ones the tile
K = mi.ROWS_MAX_COLS


# ragged on purpose: W=1, B/N not multiples of any block size, N=1; then
# narrow calls around the cut-over at odd, ragged and probe widths
@pytest.mark.parametrize("b,n,w", [(1, 16, 1), (5, 257, 1), (13, 100, 7),
                                   (32, 300, 4), (7, 1, 2)] + [
    (5, n, w) for n in (1, 2, 3, K, K + 1) for w in (1, 7, 104, 256)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_intersect_matches_reference(b, n, w, with_mask):
    rng = np.random.default_rng(b * n * w + with_mask)
    a, cols = _words(rng, b, w), _words(rng, n, w)
    mask = _words(rng, b, w) if with_mask else None
    got = ops.masked_intersect(_t(a), _t(cols),
                               None if mask is None else _t(mask))
    want = np.asarray(ref.masked_intersect_ref(
        jnp.asarray(a), jnp.asarray(cols),
        None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _pallas(a, cols, mask))


def test_masked_intersect_membership_via_eye_table():
    """With one-hot columns the product is a batched membership probe:
    counts[r, v] = bit v of (a & mask)[r] (the iso candidate-grid case)."""
    rng = np.random.default_rng(7)
    n = 100
    a, mask = _words(rng, 9, 4), _words(rng, 9, 4)
    eye = bitset.to_tensor(bitset.eye_table(n), "cpu")
    member = ops.masked_intersect(_t(a), eye, _t(mask)) > 0
    want = np.asarray(ref_bitset.to_bool(jnp.asarray(a & mask), n))
    np.testing.assert_array_equal(member.numpy(), want)


@pytest.mark.parametrize("max_elements", [1, 50, 7 * 33 * 3])
def test_plain_version_chunks_rows(max_elements):
    """A tiny element budget forces one- and few-row chunks; the answer
    must not depend on the chunking."""
    rng = np.random.default_rng(max_elements)
    a, cols, mask = _words(rng, 11, 3), _words(rng, 33, 3), _words(rng, 11, 3)
    want = np.asarray(ref.masked_intersect_ref(
        jnp.asarray(a), jnp.asarray(cols), jnp.asarray(mask)))
    got = mi.masked_intersect_plain(_t(a), _t(cols), _t(mask),
                                    max_elements=max_elements)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_version_at_the_tall_probe_shape():
    """One column, one word and 2^22 + 1 rows with a row mask: a probe's
    shape past the 65,535 row tiles one CUDA grid dimension holds (the C
    entry launches one grid per 4,194,240 rows there; chip_smoke.py phase
    2 checks it on the card).  The plain version against numpy's bit count."""
    rng = np.random.default_rng(22)
    b = (1 << 22) + 1
    a, cols, mask = _words(rng, b, 1), _words(rng, 1, 1), _words(rng, b, 1)
    inter = (a & mask & cols[0])[:, 0]
    want = sum((inter >> np.uint32(i)) & np.uint32(1) for i in range(32))
    got = ops.masked_intersect(_t(a), _t(cols), _t(mask))
    assert got.shape == (b, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[:, 0], want.astype(np.int32))


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(1)
    mi.reset_launches()
    ops.masked_intersect(_t(_words(rng, 3, 2)), _t(_words(rng, 5, 2)))
    assert mi.launches == 0


# ------------------------------------------------------- clique_children
def _clique_step(n, b, m, valid_rows, seed):
    """A clique computation on the CPU over an n-vertex graph, a batch of
    b of its states (seeds and their children) and m selections: parents
    and actions at random, the bit-31 vertices among the actions, the
    first ``valid_rows`` selections valid."""
    comp = make_clique_computation(gen.densifying_graph(n, 4 * n, seed),
                                   device="cpu")
    rng = np.random.default_rng(seed)
    seeds = comp.init_frontier()[0]
    rows = torch.from_numpy(rng.integers(0, n, b))
    states_b = comp.materialize(seeds[rows], torch.from_numpy(
        rng.integers(0, n, b)))
    states_b[: b // 2] = seeds[rows[: b // 2]]
    parent = torch.from_numpy(rng.integers(0, b, m))
    action = torch.from_numpy(rng.integers(0, n, m))
    action[:n // 32] = torch.arange(31, n, 32)[:m]
    valid = torch.arange(m) < valid_rows
    return comp, states_b, parent, action, valid


@pytest.mark.parametrize("n", [70, 100], ids=["W3", "W4"])
@pytest.mark.parametrize("valid_rows", [0, 5, 40],
                         ids=["none", "prefix", "all"])
def test_clique_children_plain_equals_the_generic_materialize(n, valid_rows):
    """The clique computation's materialize_selected (on the CPU the plain
    clique_children) gives the engine's generic expression bit for bit:
    the parents gathered, materialize, the invalid rows zeroed; and with
    repro's materialize in its place; with W odd and even, a valid prefix,
    every row valid and none (a no-op step)."""
    comp, states_b, parent, action, valid = _clique_step(n, 12, 40,
                                                         valid_rows, n)
    want = torch.where(valid[:, None],
                       comp.materialize(states_b[parent], action), 0)
    got = comp.materialize_selected(states_b, parent, action, valid)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    # and repro's materialize (jnp) on the same parents and vertices
    ref = ref_make_clique(ref_gen.densifying_graph(n, 4 * n, n))
    ref_rows = np.asarray(ref.materialize(
        jnp.asarray(states_b[parent].numpy()), jnp.asarray(action.numpy())))
    np.testing.assert_array_equal(
        got.numpy(), np.where(valid.numpy()[:, None], ref_rows, 0))
    assert (got[valid_rows:] == 0).all()
    # the vertex's bit is set in each valid child, bit 31 included
    w = (n + 31) // 32
    assert bitset.get_bit(got[:valid_rows, :w], action[:valid_rows]).all()


def test_clique_children_cpu_path_does_not_count_launches():
    comp, states_b, parent, action, valid = _clique_step(70, 4, 8, 3, 0)
    cc.reset_launches()
    comp.materialize_selected(states_b, parent, action, valid)
    assert cc.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "width", "length",
                                 "device"])
def test_clique_children_rejects_what_the_kernel_does_not_take(bad):
    states_b = torch.zeros((4, 8), dtype=torch.int32)
    ext = torch.zeros((100, 3), dtype=torch.int32)
    parent = action = torch.zeros(6, dtype=torch.int64)
    valid = torch.ones(6, dtype=torch.bool)
    if bad == "dtype":
        states_b = states_b.to(torch.int64)
    elif bad == "index_dtype":
        action = action.to(torch.int32)
    elif bad == "width":
        ext = torch.zeros((100, 4), dtype=torch.int32)
    elif bad == "length":
        valid = valid[:5]
    else:   # neither cpu nor cuda: no plain fallback, it raises
        states_b, parent, action, valid, ext = (
            t.to("meta") for t in (states_b, parent, action, valid, ext))
    with pytest.raises((TypeError, ValueError)):
        cc.clique_children(states_b, parent, action, valid, ext)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper takes
    its kernel branch up to the launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_clique_children_hands_the_kernel_its_operands(monkeypatch):
    """On a CUDA tensor the wrapper makes one C call: the five operands'
    pointers in order, a null weights pointer, the output's, then M, B, N
    and W; the output is [M, S] int32 and the call counts as a launch."""
    launched = []
    monkeypatch.setattr(cc, "launches", 0)
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
    operands = (torch.zeros((5, 8), dtype=torch.int32),
                torch.zeros(7, dtype=torch.int64),
                torch.zeros(7, dtype=torch.int64),
                torch.zeros(7, dtype=torch.bool),
                torch.zeros((100, 3), dtype=torch.int32))
    out = cc.clique_children(*(t.as_subclass(_OnCard) for t in operands))
    ((name, args),) = launched
    assert name == "clique_children" and cc.launches == 1
    assert out is made[0] and out.shape == (7, 8) and \
        out.dtype == torch.int32
    assert args == (*(t.data_ptr() for t in operands), None, out.data_ptr(),
                    7, 5, 100, 3, 0)


@pytest.mark.parametrize("bad", ["dtype", "width", "mask_shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((4, 3), dtype=torch.int32)
    cols = torch.zeros((6, 3), dtype=torch.int32)
    mask = None
    if bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "width":
        cols = torch.zeros((6, 2), dtype=torch.int32)
    elif bad == "mask_shape":
        mask = torch.zeros((4, 2), dtype=torch.int32)
    else:   # neither cpu nor cuda: no plain fallback, it raises
        a, cols = a.to("meta"), cols.to("meta")
    with pytest.raises((TypeError, ValueError)):
        mi.masked_intersect(a, cols, mask)


# (lanes, vector, cols) the row kernel takes at each probe shape of
# chip_smoke.py phase 2, operands 16-byte aligned: (B, N, W) -> plan
PROBE_PLANS = {(8, 1, 1024): (32, True, 1), (1024, 1, 1024): (32, True, 1),
               (1024, 1, 256): (32, True, 1), (1000, 1, 104): (32, True, 1),
               ((1 << 22) + 1, 1, 1): (1, False, 1)}


def test_plan_takes_the_mma_kernel_for_the_clique_and_iso_shapes():
    """The main path's N = 32,768 (clique cross counts without a mask, iso
    membership against eye_table with one) takes the tensor-core mma
    kernel, 256 columns a block, 16-byte copies where the pointers allow;
    the 64 x 64 tile is reached only by asking for it (``plan=TILE``)."""
    assert mi._plan(32768, 1024, True) == mi.Plan("mma", 0, True, 256)
    assert mi._plan(32768, 1024, False) == mi.Plan("mma", 0, False, 256)
    assert mi.TILE not in {mi._plan(n, w, al) for n in (65, 32768)
                           for w in (1, 7, 1024, 1 << 20) for al in (0, 1)}


@pytest.mark.parametrize("shape", sorted(PROBE_PLANS))
def test_plan_takes_the_row_kernel_at_every_probe_shape(shape):
    _, n, w = shape
    assert mi._plan(n, w, True) == mi.Plan("rows", *PROBE_PLANS[shape])


@pytest.mark.parametrize("w,lanes", [(1, 1), (2, 2), (7, 8), (33, 32),
                                     (1023, 32)])
def test_plan_reads_one_word_a_load_at_a_width_not_of_four_words(w, lanes):
    plan = mi._plan(1, w, True)
    assert plan == mi.Plan("rows", lanes, False, 1)


def test_plan_reads_one_word_a_load_from_a_misaligned_pointer():
    """A view that starts one word into its storage is not 16-byte aligned:
    the row kernel then reads one word at a time, even at W = 1,024."""
    store = torch.zeros(1 + 8 * 1024, dtype=torch.int32)
    aligned = store[:8 * 1024].view(8, 1024)
    shifted = store[1:].view(8, 1024)
    ones = torch.full((1, 1024), -1, dtype=torch.int32)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    assert mi._aligned(aligned, ones, aligned)
    assert not mi._aligned(shifted, ones, aligned)
    assert not mi._aligned(aligned, ones, shifted)
    assert mi._plan(1, 1024, mi._aligned(shifted, ones)) == \
        mi.Plan("rows", 32, False, 1)
    assert mi._plan(1, 1024, mi._aligned(aligned, ones)) == \
        mi.Plan("rows", 32, True, 1)


@pytest.mark.parametrize("w", [1, 7, 104, 256, 1024])
def test_plan_cuts_over_at_k(w):
    """Up to K = 32 columns (where the row kernel beat the mma kernel in
    the smoke run's sweep) the row kernel, above it the mma kernel; the
    row kernel keeps at most 32 column sums a lane."""
    assert K == 32
    assert mi._plan(K, w, True).variant == "rows"
    assert mi._plan(K + 1, w, True) == mi.Plan("mma", 0, w % 4 == 0, 256)
    assert [mi._plan(n, w, True).cols for n in (1, 2, 3, 5, 17, K)] == \
        [1, 2, 4, 8, 32, 32]


# chip_smoke.py's ragged masked_intersect shapes (B, N, W), phase 2
RAGGED_SHAPES = ((1, 1, 1), (1, 16, 1), (5, 257, 1), (7, 1, 2),
                 (13, 100, 7), (32, 300, 4), (8, 128, 32), (67, 1000, 33))


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("shift", [0, 1])
def test_plan_at_the_ragged_shapes(shape, shift):
    """Above K columns the mma kernel with 16-byte copies only where W %
    4 == 0 and every operand starts on a 16-byte boundary (a view one word
    into its storage does not); up to K the row kernel, as before."""
    b, n, w = shape
    store = torch.zeros(1 + b * w, dtype=torch.int32)
    a = store[shift:shift + b * w].view(b, w)
    mask = torch.zeros((b, w), dtype=torch.int32)
    cols = torch.zeros((n, w), dtype=torch.int32)
    aligned = mi._aligned(a, cols, mask)
    assert aligned == (shift == 0)
    plan = mi._plan(n, w, aligned)
    if n <= K:
        assert plan == mi.rows_plan(n, w, aligned)
    else:
        assert plan == mi.Plan("mma", 0, aligned and w % 4 == 0, 256)


def _zero_one_product(a, cols, mask):
    """popcount as the plain 0/1 product: bit j of word w to k = 32 w + j,
    then one int32 product of the expanded a & mask and b."""
    rows = a if mask is None else a & mask
    shifts = torch.arange(32, dtype=torch.int64)

    def expand(words):
        bits = (words.long()[:, :, None] >> shifts) & 1
        return bits.reshape(words.shape[0], -1).int()
    return expand(rows) @ expand(cols).T


def _mma_steps(a, cols, mask):
    """The mma kernel's arithmetic: W zero-padded to whole k256 steps of 8
    words (one 1-bit wgmma each), the popcount of each step's AND, the
    steps summed in int32."""
    rows = a if mask is None else a & mask
    pad = -rows.shape[1] % 8
    rows = torch.nn.functional.pad(rows, (0, pad))
    cols = torch.nn.functional.pad(cols, (0, pad))
    steps = (rows.view(rows.shape[0], 1, -1, 8)
             & cols.view(1, cols.shape[0], -1, 8))
    return bitset.popcount(steps, axis=-1).sum(-1, dtype=torch.int32)


@pytest.mark.parametrize("w", [1, 7, 33])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("form", ["zero_one", "kernel"])
def test_mma_arithmetic_matches_reference(w, with_mask, form):
    """The mma kernel's arithmetic in plain torch (``form="kernel"``: W
    zero-padded to k256 steps of 8 words, each step's AND popcount, an
    int32 sum; ``"zero_one"``: the 0/1 product over the 32 W bits that
    the tensor cores' 1-bit form computes) against the Pallas kernel in
    interpret mode, exactly: random words, words with bit 31 set, all-ones
    words (count 32 W)."""
    rng = np.random.default_rng(100 * w + with_mask)
    a, cols = _words(rng, 6, w), _words(rng, 9, w)
    a[0] |= np.uint32(1 << 31)
    cols[0] |= np.uint32(1 << 31)
    a[1] = cols[1] = np.uint32(0xFFFFFFFF)
    mask = _words(rng, 6, w) if with_mask else None
    if mask is not None:
        mask[1] = np.uint32(0xFFFFFFFF)
    run = _mma_steps if form == "kernel" else _zero_one_product
    got = run(_t(a), _t(cols), None if mask is None else _t(mask))
    assert got.dtype == torch.int32
    want = _pallas(a, cols, mask)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 1] == 32 * w
