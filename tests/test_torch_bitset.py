"""repro_torch.core.bitset against repro.core.bitset, bit for bit.

The port keeps words as int32 (the reference as uint32), so every case
feeds both packages the same numpy words — including bit 31, the port's
sign bit — and compares bytes.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bitset as ref
from repro_torch.core import bitset as bs

torch.set_num_threads(2)


def _words(rng, *shape):
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    w.flat[0] |= np.uint32(1 << 31)          # bit 31 set at least once
    return w


def _t(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


def _same(port: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = port.numpy()
    assert got.shape == want.shape
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100, 1024])
def test_num_words(n):
    assert bs.num_words(n) == ref.num_words(n)


def test_i32_u32_views_match_bitcast():
    u = _words(np.random.default_rng(0), 5, 3)
    np.testing.assert_array_equal(bs.to_i32(u), np.asarray(ref.to_i32(
        jnp.asarray(u))))
    np.testing.assert_array_equal(bs.to_u32(bs.to_i32(u)), u)
    assert bs.to_tensor(u, "cpu").dtype == torch.int32
    _same(bs.to_tensor(u, "cpu"), u)


def test_zeros():
    z = bs.zeros((3, 2), 70)
    assert z.dtype == torch.int32
    _same(z, ref.zeros((3, 2), 70))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 257])
def test_host_tables(n):
    np.testing.assert_array_equal(bs.lt_mask_table(n), ref.lt_mask_table(n))
    np.testing.assert_array_equal(bs.eye_table(n), ref.eye_table(n))
    rng = np.random.default_rng(n)
    idx = rng.choice(n, size=min(n, 7), replace=False)
    np.testing.assert_array_equal(bs.from_indices(idx, n),
                                  ref.from_indices(idx, n))
    mask = rng.random((4, n)) < 0.5
    np.testing.assert_array_equal(bs.from_bool(mask), ref.from_bool(mask))


@pytest.mark.parametrize("shape,n_bits", [((6, 1), 32), ((6, 4), 100),
                                          ((3, 5, 2), 64)])
def test_to_bool(shape, n_bits):
    u = _words(np.random.default_rng(1), *shape)
    _same(bs.to_bool(_t(u), n_bits), ref.to_bool(jnp.asarray(u), n_bits))


@pytest.mark.parametrize("axis", [-1, 0])
def test_popcount(axis):
    u = _words(np.random.default_rng(2), 9, 7)
    u[0] = np.uint32(0xFFFFFFFF)
    u[1] = 0
    u[2] = np.uint32(1 << 31)
    got = bs.popcount(_t(u), axis=axis)
    assert got.dtype == torch.int32
    _same(got, ref.popcount(jnp.asarray(u), axis=axis))


def test_get_bit():
    rng = np.random.default_rng(3)
    u = _words(rng, 8, 3)
    idx = np.array([0, 31, 32, 63, 64, 95, 5, 40], np.int32)
    _same(bs.get_bit(_t(u), torch.from_numpy(idx)),
          ref.get_bit(jnp.asarray(u), jnp.asarray(idx)))


@pytest.mark.parametrize("bit", [0, 31, 32, 63])
def test_set_bit(bit):
    u = _words(np.random.default_rng(4), 5, 2)
    u[:, :] &= np.uint32(0x7FFF7FFE)        # make room for the bit to show
    idx = np.full((5,), bit, np.int32)
    _same(bs.set_bit(_t(u), torch.from_numpy(idx)),
          ref.set_bit(jnp.asarray(u), jnp.asarray(idx)))


def test_set_bit_batched_indices():
    u = np.zeros((4, 3), np.uint32)
    idx = np.array([0, 31, 32, 95], np.int32)
    got = bs.set_bit(_t(u), torch.from_numpy(idx))
    _same(got, ref.set_bit(jnp.asarray(u), jnp.asarray(idx)))
    assert got[1, 0].item() == torch.iinfo(torch.int32).min   # the sign bit


def test_first_set_bit():
    rng = np.random.default_rng(5)
    u = _words(rng, 7, 3)
    u[0] = 0                                    # empty -> -1
    u[1] = [0, np.uint32(1 << 31), 1]           # bit 63
    u[2] = [np.uint32(1 << 31), 0, 0]           # bit 31
    u[3] = [0, 0, 4]                            # bit 66
    _same(bs.first_set_bit(_t(u)), ref.first_set_bit(jnp.asarray(u)))
