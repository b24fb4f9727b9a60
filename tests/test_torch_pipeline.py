"""The port's data pipeline (repro_torch.data.pipeline) against
repro.data.pipeline: at the same arguments every batch is byte-equal —
the same RNG calls in the same order.  The arguments are those of
tests/test_substrate.py, plus shards and a deeper GraphSAGE fanout.  Also
the carry of a JAX bfloat16 array into a tensor, bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.data.synthetic_graphs import densifying_graph as ref_densifying
from repro_torch.carry import tensor_from_array
from repro_torch.data import pipeline
from repro_torch.data.synthetic_graphs import densifying_graph


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            assert got[key].shape == value.shape, key
            assert got[key].tobytes() == value.tobytes(), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("kw,step", [
    (dict(vocab=1000, batch=8, seq=64, seed=1), 17),
    (dict(vocab=1000, batch=8, seq=64, seed=1, shard=0, num_shards=2), 0),
    (dict(vocab=1000, batch=8, seq=64, seed=1, shard=1, num_shards=2), 0),
    (dict(vocab=50, batch=3, seq=7, seed=5), 2),     # odd seq: copy pattern
])
def test_token_stream_byte_equal(kw, step):
    _assert_same(pipeline.TokenStream(**kw).batch_at(step),
                 ref_pipeline.TokenStream(**kw).batch_at(step))


def test_token_stream_iterates_like_reference():
    kw = dict(vocab=300, batch=2, seq=16, seed=4)
    for got, want, _ in zip(pipeline.TokenStream(**kw),
                            ref_pipeline.TokenStream(**kw), range(3)):
        _assert_same(got, want)


@pytest.mark.parametrize("kw,step", [
    (dict(n_sparse=8, n_dense=4, vocab=100, batch=16, seed=2), 3),
    (dict(n_sparse=26, n_dense=13, vocab=1_000_000, batch=32, seed=0,
          shard=1, num_shards=2), 5),
])
def test_recsys_stream_byte_equal(kw, step):
    _assert_same(pipeline.RecsysStream(**kw).batch_at(step),
                 ref_pipeline.RecsysStream(**kw).batch_at(step))


@pytest.mark.parametrize("kw,step", [
    (dict(batch_nodes=16, fanout=(4, 3), d_feat=8, d_out=2, seed=0), 0),
    (dict(batch_nodes=16, fanout=(4, 3), d_feat=8, d_out=2, seed=0,
          shard=1, num_shards=2), 1),
    (dict(batch_nodes=32, fanout=(25, 10), d_feat=16, seed=3), 2),
])
def test_neighbor_sampler_byte_equal(kw, step):
    got_sampler = pipeline.NeighborSampler(
        densifying_graph(300, 1200, seed=0), **kw)
    want_sampler = ref_pipeline.NeighborSampler(
        ref_densifying(300, 1200, seed=0), **kw)
    assert (got_sampler.n_pad, got_sampler.e_pad) == \
        (want_sampler.n_pad, want_sampler.e_pad)
    _assert_same(dataclasses.asdict(got_sampler.sample(step)),
                 dataclasses.asdict(want_sampler.sample(step)))


def test_molecule_batch_byte_equal():
    kw = dict(batch=4, n_atoms=9, n_edges=12, d_feat=8, seed=3, step=2)
    _assert_same(pipeline.molecule_batch(**kw),
                 ref_pipeline.molecule_batch(**kw))


def test_tensor_from_array_carries_bfloat16_bit_for_bit():
    x = np.random.default_rng(0).standard_normal((3, 5), np.float32)
    a = np.asarray(jnp.asarray(x, jnp.bfloat16))
    assert a.dtype.name == "bfloat16"
    t = tensor_from_array(a, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (3, 5)
    assert t.view(torch.int16).numpy().tobytes() == a.tobytes()
    # and back: the same bits come out of the tensor
    back = t.view(torch.int16).numpy().view(np.uint16).view(a.dtype)
    np.testing.assert_array_equal(back, a)
    # the float32 values agree with JAX's own widening
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(jnp.asarray(a).astype(jnp.float32)))


def test_tensor_from_array_casts_and_copies():
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = tensor_from_array(a, "cpu", torch.int32)
    assert t.dtype == torch.int32 and t.tolist() == a.tolist()
    f = np.ones(4, np.float32)
    u = tensor_from_array(f, "cpu")
    u += 1                            # the caller's array is not shared
    assert f.tolist() == [1.0] * 4
