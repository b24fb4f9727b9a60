#!/usr/bin/env python3
"""Another revision against this one for the ``flash_attention`` kernel
of one dtype (bf16 by default, or fp32), on one NVIDIA card, in one
process.

    git archive <revision> | tar -x -C artifacts/other
    python3 scripts/flash_ab.py --other artifacts/other [--dtype fp32]

``--other`` is the root of a checkout of another revision of this repo (any
from the one that added ``src/repro_torch/kernels/flash_attention.py`` on).
Its ``repro_torch`` package is loaded under another name, so its wrapper
builds its own kernel source into its own ``build/`` directory and calls
its own C entry, whatever that entry's arguments.  The two wrappers are
timed at the co-workload's Llama-3-8B shape, H=32 S=8192 D=128, causal,
on the same seeded inputs of the chosen dtype.  They take turns (other,
this, this, other), each turn the median of ``REPS`` calls timed with CUDA
events, as ``chip_smoke.py`` times a kernel.  Both outputs are held
against the plain version with ``chip_smoke.py``'s limits for that dtype
first.  Prints the card's
name and power limit, one line per turn, and last a JSON line with every
turn's time, each kernel's mean of its two turns and the TFLOP/s of each
(4*H*D*S(S+1)/2 flops).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (cuda_ms, nvidia_smi, errors, fail)

H, S, D = 32, 8192, 128
FLOPS = 4 * H * D * S * (S + 1) / 2
REPS = 20
OTHER = "other_repro_torch"


def load_other(root: Path):
    """The other checkout's ``repro_torch.kernels.flash_attention``, as
    ``other_repro_torch.kernels.flash_attention`` (the kernel modules
    import each other relatively)."""
    package = root.resolve() / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, package / "__init__.py",
        submodule_search_locations=[str(package)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{OTHER}.kernels.flash_attention")


def main() -> int:
    import torch
    from repro_torch.kernels import flash_attention as fa

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of a checkout of another revision")
    parser.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                        help="q/k/v dtype (default bf16)")
    args = parser.parse_args()
    dtype = chip_smoke.torch_dtypes()[args.dtype]
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    other = load_other(args.other)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn((H, S, D), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))

    def run_other():
        return other.flash_attention(q, k, v)

    def run_this():
        return fa.flash_attention(q, k, v)

    want = fa.flash_attention_plain(q, k, v)
    for what, run in (("other", run_other), ("this", run_this)):
        errs = chip_smoke.errors("flash_attention", args.dtype, run(), want,
                                 what)
        print(f"{what}: max abs err {errs['max_abs_err']:.3g}, of a head "
              f"relative {errs['max_rel_err']:.3g}")
    del want

    turns = []
    for what in ("other", "this", "this", "other"):
        ms = chip_smoke.cuda_ms(run_other if what == "other" else run_this,
                                REPS)
        turns.append((what, ms))
        print(f"{what}: {ms:.4f} ms, {FLOPS / ms / 1e9:.1f} TFLOP/s")
    mean = {w: statistics.mean(ms for t, ms in turns if t == w)
            for w in ("other", "this")}
    print(json.dumps({
        "shape": {"H": H, "S": S, "D": D, "causal": True},
        "dtype": args.dtype,
        "turns": [{"kernel": w, "ms": ms} for w, ms in turns],
        "mean_ms": mean,
        "tflop_s": {w: FLOPS / ms / 1e9 for w, ms in mean.items()},
        "speedup": mean["other"] / mean["this"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
