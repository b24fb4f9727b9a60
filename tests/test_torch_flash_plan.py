"""The bf16 flash_attention wrapper's side of the Hopper kernel, on the CPU.

The bf16 kernel reads rows of 64, 128 or 256 columns through TMA; the
wrapper picks that width (``_bf16_plan``) and zero-pads narrower q/k/v to
it (``_tma_rows``), passing the true D for the scale and the stored
columns.  These tests hold the plan for every shape ``chip_smoke.py``
sweeps on the card and for the Llama-3-8B shape, and show that attention
over the padded rows, computed here in fp32 with the true D and cropped,
equals the plain version on the unpadded inputs and repro's jnp oracle,
and that the wrapper hands the kernel the true D beside the planned
width (for fp32 inputs ``_fp32_plan``'s; ``test_torch_flash_fp32.py``
has the rest of the fp32 side).  The kernel itself runs only on the card
(``chip_smoke.py`` phase 2)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.carry import tensor_from_array
from repro_torch.kernels import flash_attention

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LLAMA = (chip_smoke.LLAMA["heads"], chip_smoke.LLAMA["seq"],
         chip_smoke.LLAMA["head_dim"])
SHAPES = list(chip_smoke.FLASH_RAGGED) + [LLAMA]
IDS = [f"H{h}-S{s}-D{d}" for h, s, d in SHAPES]


@pytest.mark.parametrize("h,s,d", SHAPES, ids=IDS)
def test_bf16_plan_picks_the_kernel_width(h, s, d):
    dp, pad = flash_attention._bf16_plan(d)
    assert dp in flash_attention.BF16_WIDTHS
    assert pad == dp - d >= 0
    # the narrowest template that holds d: no wider rows than needed
    assert all(w < d for w in flash_attention.BF16_WIDTHS if w < dp)
    if d in flash_attention.BF16_WIDTHS:
        assert pad == 0


def test_bf16_plan_pads_nothing_at_the_llama_shape():
    assert flash_attention._bf16_plan(LLAMA[2]) == (128, 0)


def test_tma_rows_pads_with_zeros_and_aligns():
    x = torch.arange(2 * 3 * 13, dtype=torch.float32).view(2, 3, 13)
    x = x.to(torch.bfloat16)
    padded = flash_attention._tma_rows(x, 51)
    assert padded.shape == (2, 3, 64) and padded.is_contiguous()
    assert torch.equal(padded[..., :13], x)
    assert not padded[..., 13:].any()
    aligned = torch.zeros(4 * 64, dtype=torch.bfloat16).view(4, 64)
    assert flash_attention._tma_rows(aligned, 0) is aligned
    shifted = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(1, 64, 64)
    assert shifted.data_ptr() % 16 != 0
    moved = flash_attention._tma_rows(shifted, 0)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, shifted)


@pytest.mark.parametrize("h,s,d", chip_smoke.FLASH_RAGGED,
                         ids=IDS[:len(chip_smoke.FLASH_RAGGED)])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_rows_change_nothing(h, s, d, causal):
    rng = np.random.default_rng(h * s + d)
    arrays = [jnp.asarray(rng.standard_normal((h, s, d), np.float32))
              .astype(jnp.bfloat16) for _ in range(3)]
    q, k, v = (tensor_from_array(np.asarray(a), "cpu") for a in arrays)
    _, pad = flash_attention._bf16_plan(d)
    qp, kp, vp = (flash_attention._tma_rows(t, pad).float()
                  for t in (q, k, v))
    scores = qp @ kp.transpose(1, 2) / np.sqrt(d)   # the true D's scale
    if causal:
        scores.masked_fill_(torch.ones(s, s, dtype=torch.bool).triu_(1),
                            float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vp
    assert not out[..., d:].any()
    got = out[..., :d]
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    oracle = ref.flash_attention_ref(*arrays, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle, np.float32),
                               rtol=2e-4, atol=2e-4)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper takes
    its kernel branch up to the launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", sorted({d for _, _, d in SHAPES}))
def test_wrapper_passes_true_d_and_width(monkeypatch, dtype, d):
    launched = []
    monkeypatch.setattr(flash_attention, "launches",
                        flash_attention.launches)     # restored after
    monkeypatch.setattr(flash_attention.build, "launch",
                        lambda name, argtypes, *args: launched.append(args))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **kw: empty(*a, **kw))
    q = torch.zeros((2, 3, d), dtype=dtype).as_subclass(_OnCard)
    flash_attention.flash_attention(q, q, q, causal=False)
    (args,) = launched
    bf16 = dtype == torch.bfloat16
    plan = flash_attention._bf16_plan if bf16 else flash_attention._fp32_plan
    assert args[5:] == (2, 3, d, plan(d)[0], 0,
                        flash_attention.DTYPES[dtype], 0)
    # the fp32 kernel's split operands go to a work buffer; bf16 has none
    assert (args[4] is None) == bf16
