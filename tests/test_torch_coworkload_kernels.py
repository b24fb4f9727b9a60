"""The port's co-workload kernels — segment_matmul, embedding_bag,
flash_attention — on the CPU (their plain PyTorch versions) against
repro's pure-jnp oracles and its Pallas kernels in interpret mode, at the
shapes, dtypes and tolerances of tests/test_kernels.py; then the slice as
a whole, from each package's data pipeline through its kernels.  Inputs
are made with numpy from a seed; bf16 inputs are rounded from the same
fp32 arrays by JAX and carried across bit for bit.  The Hopper kernels
themselves run only on the card (chip_smoke.py holds each against its
plain version there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.data.synthetic_graphs import densifying_graph as ref_densifying
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.carry import tensor_from_array
from repro_torch.data import pipeline
from repro_torch.data.synthetic_graphs import densifying_graph
from repro_torch.kernels import embedding_bag, flash_attention, ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import segment_matmul

torch.set_num_threads(2)

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shape, dtype="float32"):
    """The same numbers on both sides: a JAX array (rounded to ``dtype``
    from numpy fp32) and its tensor."""
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    a = jnp.asarray(x).astype(DTYPES[dtype])
    return a, tensor_from_array(np.asarray(a), "cpu")


def _close(got: torch.Tensor, want, tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------- segment_matmul
@pytest.mark.parametrize("e,n,d", [(64, 16, 8), (300, 50, 16),
                                   (1024, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_matmul_matches_reference(e, n, d, dtype):
    msg_j, msg = _normal(e + n, e, d, dtype=dtype)
    dst = np.random.default_rng(1).integers(0, n, e, dtype=np.int32)
    got = ops.segment_matmul(msg, torch.from_numpy(dst), n)
    assert got.shape == (n, d)
    tol = 1e-5 if dtype == "float32" else 5e-2
    _close(got, ref.segment_matmul_ref(msg_j, jnp.asarray(dst), n), tol)
    _close(got, ref_ops.segment_matmul(msg_j, jnp.asarray(dst), num_nodes=n,
                                       block_n=32, block_e=128,
                                       interpret=True), tol)


def test_segment_matmul_drops_out_of_range_destinations():
    n = 10
    msg_j, msg = _normal(3, 40, 8)
    dst = np.random.default_rng(2).integers(0, n, 40, dtype=np.int32)
    dst[::5] = -1
    dst[1::7] = n
    dst[2::9] = n + 1
    got = ops.segment_matmul(msg, torch.from_numpy(dst), n)
    _close(got, ref.segment_matmul_ref(msg_j, jnp.asarray(dst), n), 1e-5)
    _close(got, ref_ops.segment_matmul(msg_j, jnp.asarray(dst), num_nodes=n,
                                       block_n=8, block_e=16,
                                       interpret=True), 1e-5)
    keep = (dst >= 0) & (dst < n)
    _close(got, ops.segment_matmul(msg[torch.from_numpy(keep)],
                                   torch.from_numpy(dst[keep]), n), 0)


def test_edges_by_node_is_a_stable_csr_of_the_kept_edges():
    """The kernel's input, built by the wrapper: node v's edges are
    order[ptr[v]:ptr[v+1]], in edge order; dropped edges come after."""
    n = 7
    dst = np.random.default_rng(5).integers(-2, n + 2, 200, dtype=np.int32)
    order, ptr = segment_matmul.edges_by_node(torch.from_numpy(dst), n)
    assert order.dtype == ptr.dtype == torch.int32
    assert ptr.shape == (n + 1,) and int(ptr[0]) == 0
    order, ptr = order.numpy(), ptr.numpy()
    for v in range(n):
        np.testing.assert_array_equal(order[ptr[v]:ptr[v + 1]],
                                      np.nonzero(dst == v)[0])
    dropped = np.nonzero((dst < 0) | (dst >= n))[0]
    np.testing.assert_array_equal(order[ptr[n]:], dropped)


def _dst_case(case, e, n):
    """``dst`` for the CSR cases: random (some out of range), sorted, every
    edge on one node, every edge dropped."""
    rng = np.random.default_rng(e + n)
    if case == "random":
        return rng.integers(-1, n + 1, e, dtype=np.int32)
    if case == "sorted":
        return np.sort(rng.integers(0, n, e, dtype=np.int32))
    if case == "one_node":
        return np.full(e, n // 2, np.int32)
    return rng.choice(np.array([-3, -1, n, n + 7], np.int32), e)


def _assert_stable_csr(order, ptr, dst, n):
    """Node v's edges are order[ptr[v]:ptr[v+1]], in edge order; dropped
    edges come after, in edge order."""
    assert order.dtype == ptr.dtype == torch.int32
    assert order.shape == dst.shape and ptr.shape == (n + 1,)
    order, ptr = order.numpy(), ptr.numpy()
    assert ptr[0] == 0
    for v in np.unique(dst[(dst >= 0) & (dst < n)]):
        np.testing.assert_array_equal(order[ptr[v]:ptr[v + 1]],
                                      np.nonzero(dst == v)[0])
    np.testing.assert_array_equal(np.diff(ptr),
                                  np.bincount(dst[(dst >= 0) & (dst < n)],
                                              minlength=n))
    np.testing.assert_array_equal(order[ptr[n]:],
                                  np.nonzero((dst < 0) | (dst >= n))[0])


@pytest.mark.parametrize("case,e,n", [("sorted", 500, 40),
                                      ("one_node", 140_800, 141_313),
                                      ("dropped", 300, 20)])
def test_edges_by_node_on_sorted_one_node_and_dropped_dst(case, e, n):
    """What the card's csr_by_node is held to, on the inputs its kernels
    treat apart: sorted keys (no radix pass), a single node's segment as
    long as the GraphSAGE cell's E, no kept edge."""
    dst = _dst_case(case, e, n)
    order, ptr = segment_matmul.edges_by_node(torch.from_numpy(dst), n)
    _assert_stable_csr(order, ptr, dst, n)
    if case != "random":
        assert int(ptr[n]) == (0 if case == "dropped" else e)


CSR_SHAPES = [(64, 16), (300, 50), (1024, 128), (1, 1), (999, 77),
              (5000, 3000), (9000, 70_000), (4099, 2 ** 24)]


@pytest.mark.parametrize("case", ["random", "sorted", "one_node", "dropped"])
@pytest.mark.parametrize("e,n", CSR_SHAPES)
def test_csr_radix_scheme_equals_edges_by_node(case, e, n):
    """The kernels' CSR build in plain PyTorch (flag, counts and scan, LSD
    radix passes over 8-bit digits and 2,048-edge tiles): one to three
    passes, one to five tiles, the last one ragged."""
    dst = torch.from_numpy(_dst_case(case, e, n))
    got = segment_matmul.csr_radix_plain(dst, n)
    want = segment_matmul.edges_by_node(dst, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_csr_by_node_on_cpu_runs_the_radix_scheme():
    dst = torch.from_numpy(_dst_case("random", 3000, 600))
    order, ptr = segment_matmul.csr_by_node(dst, 600)
    _assert_stable_csr(order, ptr, dst.numpy(), 600)
    with pytest.raises(TypeError):
        segment_matmul.csr_by_node(dst.long(), 600)


@pytest.mark.parametrize("case", ["random", "sorted"])
@pytest.mark.parametrize("n", [200, 60_000, 1_000_000, 2 ** 24])
@pytest.mark.parametrize("e", [segment_matmul.RADIX_TILE - 1,
                               segment_matmul.RADIX_TILE,
                               segment_matmul.RADIX_TILE + 1])
def test_csr_radix_scheme_around_the_tile(case, e, n):
    """The scheme at one edge below, at and above a radix tile, with N
    needing one to four 8-bit passes (200; 60,000; 1,000,000; 2^24)."""
    dst = torch.from_numpy(_dst_case(case, e, n))
    assert segment_matmul._csr_layout(e, n).passes == \
        [200, 60_000, 1_000_000, 2 ** 24].index(n) + 1
    got = segment_matmul.csr_radix_plain(dst, n)
    want = segment_matmul.edges_by_node(dst, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("e,n", [(0, 1), (1, 1), (2048, 7), (140_800,
                                                             141_313),
                                 (4099, 2 ** 24)])
def test_csr_layout_keeps_flag_and_counters_apart_from_ptr_and_order(e, n):
    """ptr, the per-tile sortedness flags, the words the launch clears
    before it counts into them (key counts, scan tiles' sums, digit
    totals), the per-tile digit counts, order and the radix buffers lie one
    after the other, none overlapping: the flags and the cleared words are
    disjoint from ptr and order.  No word of the grid barrier is in the
    buffer (the cooperative launch keeps its own)."""
    lay = segment_matmul._csr_layout(e, n)
    regions = [("ptr", 0, n + 1), ("flags", lay.flags, lay.tiles),
               ("counts", lay.counts, n + 1),
               ("tile_sums", lay.tile_sums, lay.scan_tiles),
               ("totals", lay.totals, lay.passes * 256),
               ("hist", lay.hist, lay.passes * 256 * lay.tiles),
               ("order", lay.order, e), ("keys_a", lay.keys_a, e),
               ("vals_a", lay.vals_a, e), ("keys_b", lay.keys_b, e),
               ("vals_b", lay.vals_b, e)]
    at = 0
    for name, start, size in regions:     # in order, back to back
        assert start == at, name
        at = start + size
    assert at == lay.total
    assert (lay.counts, lay.zeroed) == (regions[2][1], regions[5][1])
    assert lay.flags >= n + 1 and lay.counts >= lay.flags + lay.tiles
    assert lay.order >= lay.zeroed
    assert lay.scan_tiles * segment_matmul.SCAN_TILE >= n + 1
    assert lay.tiles * segment_matmul.RADIX_TILE >= e


def _warp_split(ptr: torch.Tensor, warps: int):
    """The sum's split of the work among the launch's ``warps`` warps, as
    ``csrc/segment_matmul.cu``'s ``warp_split`` makes it, in two passes:
    ``(rows, zeros)``, each int64 ``[warps, 2]``.  In the rows pass warp g
    sums the nodes with edges among ``[rows[g, 0], rows[g, 1])``: from the
    smallest n with ``ptr[n] >= R * g // warps`` to that of g + 1, R =
    ``ptr[N]`` the kept edges, so each warp reads about R / warps rows.  In
    the zeros pass it zeroes the empty nodes among ``[zeros[g, 0],
    zeros[g, 1])`` = ``[N * g // warps, N * (g + 1) // warps)``."""
    n = ptr.shape[0] - 1
    g = torch.arange(warps + 1)
    bounds = torch.searchsorted(ptr.long(), int(ptr[n]) * g // warps)
    rows = torch.stack([bounds[:-1], bounds[1:]], dim=1)
    zero = n * g // warps
    return rows, torch.stack([zero[:-1], zero[1:]], dim=1)


@pytest.mark.parametrize("case,e,n", [("random", 999, 77),
                                      ("sorted", 5000, 3000),
                                      ("one_node", 3000, 40),
                                      ("dropped", 300, 20),
                                      ("sorted", 140_800, 141_313)])
@pytest.mark.parametrize("warps", [1, 37, 2112])
def test_warp_split_covers_every_node_once_and_evenly(case, e, n, warps):
    """The sum's split: the rows pass's ranges run from node 0 without gap
    or overlap, past every node with edges, each warp's rows at most its
    share plus one node's (the node its share ends in); the zeros pass's
    ranges tile [0, N) in equal parts."""
    dst = torch.from_numpy(_dst_case(case, e, n))
    _, ptr = segment_matmul.csr_radix_plain(dst, n)
    rows, zeros = _warp_split(ptr, warps)
    assert rows.shape == zeros.shape == (warps, 2)
    assert int(rows[0, 0]) == 0 and int(zeros[0, 0]) == 0
    assert torch.equal(rows[1:, 0], rows[:-1, 1])
    assert torch.equal(zeros[1:, 0], zeros[:-1, 1])
    assert int(zeros[-1, 1]) == n
    ptr = ptr.long()
    edges = ptr[1:] - ptr[:-1]
    last = int(rows[-1, 1])
    assert not bool((edges[last:] > 0).any())
    share = -(-int(ptr[n]) // warps)
    widest = int(edges.max()) if n else 0
    for lo, hi in rows.tolist():
        assert hi >= lo and int(ptr[hi] - ptr[lo]) <= share + widest
    assert int((zeros[:, 1] - zeros[:, 0]).max()) <= -(-n // warps)


@pytest.mark.parametrize("case", ["random", "sorted", "dropped"])
@pytest.mark.parametrize("d", [8, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sum_warp_by_warp_is_the_plain_version_bit_for_bit(case, d, dtype):
    """The kernel's arithmetic: the rows pass (the split above), each
    node's rows in CSR order added into fp32 from zero one by one, then the
    zeros pass over the empty nodes; equal bit for bit to the plain version
    (and so, on the card, any launch equals the last)."""
    e, n = 700, 90
    _, msg = _normal(e, e, d, dtype=dtype)
    dst = torch.from_numpy(_dst_case(case, e, n))
    order, ptr = segment_matmul.csr_radix_plain(dst, n)
    rows = msg.float()
    out = torch.empty((n, d))
    by_rows, by_nodes = _warp_split(ptr, 16)
    for lo, hi in by_rows.tolist():
        for v in range(lo, hi):
            if ptr[v] < ptr[v + 1]:
                acc = torch.zeros(d)
                for i in range(int(ptr[v]), int(ptr[v + 1])):
                    acc = acc + rows[int(order[i])]
                out[v] = acc
    for lo, hi in by_nodes.tolist():
        for v in range(lo, hi):
            if ptr[v] == ptr[v + 1]:
                out[v] = 0.0
    want = segment_matmul.segment_matmul_plain(msg, dst, n)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# ----------------------------------------------------------- embedding_bag
@pytest.mark.parametrize("f,v,d,b", [(5, 37, 8, 9), (40, 1000, 32, 16),
                                     (1, 8, 128, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_matches_reference(f, v, d, b, dtype):
    table_j, table = _normal(f * v, f, v, d, dtype=dtype)
    ids = np.random.default_rng(2).integers(0, v, (b, f), dtype=np.int32)
    got = ops.embedding_bag(table, torch.from_numpy(ids))
    assert got.shape == (b, f * d)
    _close(got, ref.embedding_bag_ref(table_j, jnp.asarray(ids)), 1e-6)
    _close(got, ref_ops.embedding_bag(table_j, jnp.asarray(ids),
                                      interpret=True), 1e-6)


def test_embedding_bag_reads_out_of_range_ids_like_the_reference():
    """Outside the contract (ids in [0, V)) the ids are read as the
    reference's gather reads them: negative from the end, then clamped."""
    table_j, table = _normal(5, 3, 7, 4)
    ids = np.array([[0, -1, 6], [7, -7, 100], [-8, 3, -100]], np.int32)
    got = ops.embedding_bag(table, torch.from_numpy(ids))
    _close(got, ref.embedding_bag_ref(table_j, jnp.asarray(ids)), 0)


# --------------------------------------------------------- flash_attention
@pytest.mark.parametrize("h,s,d", [(2, 128, 32), (4, 256, 64), (1, 512, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(h, s, d, causal, dtype):
    (q_j, q), (k_j, k), (v_j, v) = (_normal(h * s + i, h, s, d, dtype=dtype)
                                    for i in range(3))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == (h, s, d)
    tol = 2e-4 if dtype == "float32" else 3e-2
    _close(got, ref.flash_attention_ref(q_j, k_j, v_j, causal=causal), tol)
    _close(got, ref_ops.flash_attention(q_j, k_j, v_j, causal=causal,
                                        block_q=64, block_k=64,
                                        interpret=True), tol)


# ------------------------------------------------- the wrappers' contract
KERNELS = [
    (segment_matmul, lambda: (torch.ones(6, 4),
                              torch.tensor([0, 1, 1, 2, 0, 2],
                                           dtype=torch.int32), 3)),
    (embedding_bag, lambda: (torch.ones(2, 5, 4),
                             torch.zeros(3, 2, dtype=torch.int32))),
    (flash_attention, lambda: tuple(torch.ones(2, 8, 4) for _ in range(3))),
]
NAMES = ["segment_matmul", "embedding_bag", "flash_attention"]


@pytest.mark.parametrize("mod,args", KERNELS, ids=NAMES)
def test_cpu_path_counts_no_launches(mod, args):
    mod.reset_launches()
    fn = getattr(ops, mod.__name__.rsplit(".", 1)[1])
    out = fn(*args())
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert mod.launches == 0


@pytest.mark.parametrize("mod,args", KERNELS, ids=NAMES)
def test_wrapper_rejects_what_the_kernel_does_not_take(mod, args):
    fn = getattr(ops, mod.__name__.rsplit(".", 1)[1])
    good = args()
    wrong_dtype = (good[0].double(),) + good[1:]
    wrong_rank = (good[0][None],) + good[1:]
    with pytest.raises(TypeError):
        fn(*wrong_dtype)
    with pytest.raises((TypeError, ValueError)):
        fn(*wrong_rank)
    on_meta = tuple(t.to("meta") if isinstance(t, torch.Tensor) else t
                    for t in good)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(*on_meta)
    mixed = (good[0].to("meta"),) + good[1:]
    with pytest.raises(ValueError):
        fn(*mixed)


def test_plain_versions_are_the_ref_names():
    assert port_ref.segment_matmul_ref is segment_matmul.segment_matmul_plain
    assert port_ref.embedding_bag_ref is embedding_bag.embedding_bag_plain
    assert port_ref.flash_attention_ref is \
        flash_attention.flash_attention_plain


# ------------------------------------------------------- the whole slice
def test_coworkload_slice_matches_reference_end_to_end():
    """Each package's pipeline through its own kernels: a GraphSAGE 2-hop
    sample's message sum, a molecule batch's per-graph readout, a recsys
    batch's embedding gather and attention over a token batch."""
    # GraphSAGE: messages = features[edge_src], summed into edge_dst
    kw = dict(batch_nodes=16, fanout=(5, 3), d_feat=16, seed=0)
    sub = pipeline.NeighborSampler(densifying_graph(300, 1200, seed=0),
                                   **kw).sample(1)
    ref_sub = ref_pipeline.NeighborSampler(
        ref_densifying(300, 1200, seed=0), **kw).sample(1)
    n_pad = len(sub.features)
    feats = torch.from_numpy(sub.features)
    got = ops.segment_matmul(feats[torch.from_numpy(sub.edge_src).long()],
                             torch.from_numpy(sub.edge_dst), n_pad)
    want = ref_ops.segment_matmul(
        jnp.asarray(ref_sub.features)[jnp.asarray(ref_sub.edge_src)],
        jnp.asarray(ref_sub.edge_dst), num_nodes=n_pad, interpret=True)
    _close(got, want, 1e-5)
    assert float(got[:16].abs().sum()) > 0          # seeds got messages

    # molecules: the sum readout of atom features per graph
    kw = dict(batch=4, n_atoms=9, n_edges=12, d_feat=8, seed=3, step=2)
    mol, ref_mol = pipeline.molecule_batch(**kw), \
        ref_pipeline.molecule_batch(**kw)
    got = ops.segment_matmul(torch.from_numpy(mol["features"]),
                             torch.from_numpy(mol["graph_ids"]),
                             mol["num_graphs"])
    want = ref_ops.segment_matmul(jnp.asarray(ref_mol["features"]),
                                  jnp.asarray(ref_mol["graph_ids"]),
                                  num_nodes=ref_mol["num_graphs"],
                                  interpret=True)
    _close(got, want, 1e-5)

    # recsys: per-field gather of the sparse ids from a seeded table
    kw = dict(n_sparse=6, n_dense=4, vocab=50, batch=12, seed=2)
    ids = pipeline.RecsysStream(**kw).batch_at(3)["sparse_ids"]
    ref_ids = ref_pipeline.RecsysStream(**kw).batch_at(3)["sparse_ids"]
    table_j, table = _normal(9, 6, 50, 8)
    _close(ops.embedding_bag(table, torch.from_numpy(ids)),
           ref_ops.embedding_bag(table_j, jnp.asarray(ref_ids),
                                 interpret=True), 1e-6)

    # tokens: embedded, projected to q/k/v, causal attention
    kw = dict(vocab=64, batch=1, seq=128, seed=1)
    tok = pipeline.TokenStream(**kw).batch_at(0)["tokens"][0]
    ref_tok = ref_pipeline.TokenStream(**kw).batch_at(0)["tokens"][0]
    rng = np.random.default_rng(4)
    embed = rng.standard_normal((64, 32), np.float32)
    w = rng.standard_normal((3, 32, 2 * 16), np.float32) \
        / np.float32(32 ** 0.5)

    def heads(x):                                    # [S, 2*16] -> [2, S, 16]
        return x.reshape(128, 2, 16).transpose(1, 0, 2)

    q, k, v = (heads(embed[tok] @ w[i]) for i in range(3))
    rq, rk, rv = (heads(embed[ref_tok] @ w[i]) for i in range(3))
    got = ops.flash_attention(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (q, k, v)))
    want = ref_ops.flash_attention(jnp.asarray(rq), jnp.asarray(rk),
                                   jnp.asarray(rv), block_q=64, block_k=64,
                                   interpret=True)
    _close(got, want, 2e-4)
