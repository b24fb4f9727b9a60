"""The fp32 flash_attention kernel's arithmetic and layout, on the CPU.

On the card an fp32 product q.k or p.v becomes three tf32 tensor-core
products: each operand x is split into hi = tf32(x) and lo = tf32(x - hi),
and the product is hi.hi + hi.lo + lo.hi (lo.lo dropped).  The kernel's
split pass writes those operands (``flash_attention._split_operands`` is
the same in plain PyTorch): q and k rows padded to the kernel's width
(``_fp32_plan``), v transposed with its keys in ``KEY_ORDER`` within each 8,
since a tf32 wgmma reads both operands K-major and the score accumulator
holds keys 2t, 2t + 1 where the A fragment wants k-indices t, t + 4.

These tests emulate that arithmetic in plain PyTorch and hold it against
the plain version and repro's jnp oracle at the tolerances the card's
smoke run uses (2e-4 absolute, 1e-4 relative per head), show that one
tf32 product alone misses them, and check the plan, the key order, the
split's error and the wrapper's launch arguments.  The kernel itself runs
only on the card (``chip_smoke.py`` phases 2 and 6)."""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

RAGGED = list(chip_smoke.FLASH_RAGGED)
RAGGED_IDS = [f"H{h}-S{s}-D{d}" for h, s, d in RAGGED]
LLAMA = (chip_smoke.LLAMA["heads"], chip_smoke.LLAMA["seq"],
         chip_smoke.LLAMA["head_dim"])
ABS_TOL = chip_smoke.TOLERANCE["flash_attention"]["fp32"]
REL_TOL = chip_smoke.FLASH_REL_TOLERANCE["fp32"]


def _inputs(h, s, d, seed=None):
    rng = np.random.default_rng(h * s + d if seed is None else seed)
    return [rng.standard_normal((h, s, d), np.float32) for _ in range(3)]


def _masked_scores(scores, causal):
    s = scores.shape[-1]
    if causal:
        scores = scores.masked_fill(
            torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    return scores


def _attention_3xtf32(q, k, v, causal):
    """The kernel's arithmetic: the split pass's operands, q.k and p.v as
    three tf32 products each, softmax in fp32, p split in registers and
    put in key order."""
    h, s, d = q.shape
    dp, _ = fa._fp32_plan(d)
    q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo = fa._split_operands(q, k, v, dp)
    kt_hi, kt_lo = k_hi.transpose(1, 2), k_lo.transpose(1, 2)
    scores = q_hi @ kt_hi + q_lo @ kt_hi + q_hi @ kt_lo
    scores = _masked_scores(scores / math.sqrt(d), causal)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    s8 = vt_hi.shape[-1]
    p = torch.nn.functional.pad(p, (0, s8 - s))[..., fa._key_order(s8)]
    p_hi, p_lo = fa._split(p)
    v_hi, v_lo = vt_hi.transpose(1, 2), vt_lo.transpose(1, 2)
    out = p_hi @ v_hi + p_lo @ v_hi + p_hi @ v_lo
    return (out / l)[..., :d]


def _attention_1xtf32(q, k, v, causal):
    """The same with one tf32 product each (operands rounded to tf32)."""
    d = q.shape[-1]
    t = fa._tf32
    scores = _masked_scores(t(q) @ t(k).transpose(1, 2) / math.sqrt(d),
                            causal)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    return (t(p) @ t(v)) / p.sum(-1, keepdim=True)


def _head_rel_err(got, want):
    return float(((got - want).flatten(1).norm(dim=1)
                  / want.flatten(1).norm(dim=1)).max())


@pytest.mark.parametrize("h,s,d", RAGGED, ids=RAGGED_IDS)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_split_within_tolerance(h, s, d, causal):
    arrays = _inputs(h, s, d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = _attention_3xtf32(q, k, v, causal)
    assert got.shape == (h, s, d) and bool(torch.isfinite(got).all())
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    oracle = torch.from_numpy(np.array(ref.flash_attention_ref(
        *(jnp.asarray(a) for a in arrays), causal=causal), np.float32))
    for want in (plain, oracle):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ABS_TOL,
                                   atol=ABS_TOL)
        assert _head_rel_err(got, want) <= REL_TOL
    # far inside the limits: about 1e-6 of a head, as 3 * 2^-22 per product
    assert _head_rel_err(got, plain) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_single_tf32_misses_the_head_tolerance(causal):
    h, s, d = 3, 100, 128
    q, k, v = (torch.from_numpy(a) for a in _inputs(h, s, d, seed=7))
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    one = _attention_1xtf32(q, k, v, causal)
    three = _attention_3xtf32(q, k, v, causal)
    assert _head_rel_err(one, plain) > REL_TOL
    assert _head_rel_err(three, plain) <= REL_TOL


@pytest.mark.parametrize("h,s,d", RAGGED + [LLAMA],
                         ids=RAGGED_IDS + ["H32-S8192-D128"])
def test_fp32_plan_picks_the_kernel_width(h, s, d):
    dp, pad = fa._fp32_plan(d)
    assert dp in fa.FP32_WIDTHS and pad == dp - d >= 0
    assert dp % 32 == 0        # whole 128-byte TMA panels, 8-column k-steps
    assert all(w < d for w in fa.FP32_WIDTHS if w < dp)
    if d in fa.FP32_WIDTHS:
        assert pad == 0


def test_fp32_plan_pads_nothing_at_the_llama_shape():
    assert fa._fp32_plan(LLAMA[2]) == (128, 0)


@pytest.mark.parametrize("s", [1, 8, 13, 64, 100])
def test_key_order_gives_the_same_pv(s):
    rng = np.random.default_rng(s)
    p = torch.from_numpy(rng.random((16, s), np.float32))
    v = torch.from_numpy(rng.standard_normal((s, 24), np.float32))
    s8 = -(-s // 8) * 8
    order = fa._key_order(s8)
    assert sorted(order.tolist()) == list(range(s8))
    p8 = torch.nn.functional.pad(p, (0, s8 - s))
    v8 = torch.nn.functional.pad(v, (0, 0, 0, s8 - s))
    permuted = p8[:, order].double() @ v8[order].double()
    np.testing.assert_allclose(permuted.numpy(), (p.double() @ v.double())
                               .numpy(), rtol=1e-12, atol=1e-12)


def test_key_order_matches_the_fragments():
    # the A fragment's k-index t (t + 4) at position t (t + 4) of a group of
    # 8 is the accumulator's key 2t (2t + 1)
    for t in range(4):
        assert fa.KEY_ORDER[t] == 2 * t
        assert fa.KEY_ORDER[t + 4] == 2 * t + 1


def test_split_error_and_rounding():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096, np.float32),
        rng.standard_normal(4096, np.float32) * 1e-30,
        rng.standard_normal(4096, np.float32) * 1e30]))
    hi, lo = fa._split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # to nearest, ties away from zero: 1 + 2^-11 (a tie) rounds up
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12],
                       dtype=torch.float32)
    assert fa._tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("h,s,d", [(2, 100, 13), (1, 64, 40), (2, 37, 128)])
def test_split_operands_layout(h, s, d):
    q, k, v = (torch.from_numpy(a) for a in _inputs(h, s, d))
    dp, _ = fa._fp32_plan(d)
    s8 = -(-s // 8) * 8
    parts = fa._split_operands(q, k, v, dp)
    assert [tuple(p.shape) for p in parts] == [(h, s, dp)] * 4 + [
        (h, dp, s8)] * 2
    assert sum(p.numel() for p in parts) == fa._fp32_work_elems(h, s, dp)
    q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo = parts
    for x, (hi, lo) in ((q, (q_hi, q_lo)), (k, (k_hi, k_lo))):
        assert not hi[..., d:].any() and not lo[..., d:].any()
        assert bool(((hi[..., :d] + lo[..., :d] - x).abs()
                     <= 2.0 ** -21 * x.abs()).all())
    assert not vt_hi[:, d:].any() and not vt_lo[:, d:].any()
    natural = (vt_hi + vt_lo)[..., torch.argsort(fa._key_order(s8))]
    np.testing.assert_allclose(natural[:, :d, :s].transpose(1, 2).numpy(),
                               v.numpy(), rtol=2.0 ** -21, atol=0)
    assert not natural[..., s:].any()


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper takes
    its kernel branch up to the launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("h,s,d", RAGGED, ids=RAGGED_IDS)
def test_wrapper_hands_the_kernel_true_d_width_and_work(monkeypatch, h, s, d):
    launched = []
    monkeypatch.setattr(fa, "launches", fa.launches)     # restored after
    monkeypatch.setattr(fa.build, "launch",
                        lambda name, argtypes, *args: launched.append(args))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    sizes = []
    empty = torch.empty

    def fake_empty(*a, device=None, **kw):
        sizes.append(a[0])
        return empty(*a, **kw)
    monkeypatch.setattr(torch, "empty", fake_empty)
    q = torch.zeros((h, s, d), dtype=torch.float32).as_subclass(_OnCard)
    fa.flash_attention(q, q, q, causal=True)
    (args,) = launched
    dp = fa._fp32_plan(d)[0]
    assert args[5:] == (h, s, d, dp, 1, fa.DTYPES[torch.float32], 0)
    assert args[4] is not None
    assert sizes[0] == fa._fp32_work_elems(h, s, dp)
