"""The port's masked_intersect / frontier_expand on the CPU (the plain
PyTorch version) against repro's pure-jnp oracle and its Pallas kernel in
interpret mode, on the shape sweeps of tests/test_kernels.py.  Exact
equality: this is integer work.  The Hopper kernel itself runs only on the
card (chip_smoke.py holds it against the plain version there)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bitset as ref_bitset
from repro.kernels import masked_intersect as ref_mi
from repro.kernels import ref
from repro_torch.core import bitset
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


# ragged on purpose: W=1, B/N not multiples of any block size, N=1
@pytest.mark.parametrize("b,n,w", [(1, 16, 1), (5, 257, 1), (13, 100, 7),
                                   (32, 300, 4), (7, 1, 2)])
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


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(1)
    mi.reset_launches()
    ops.masked_intersect(_t(_words(rng, 3, 2)), _t(_words(rng, 5, 2)))
    assert mi.launches == 0


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
