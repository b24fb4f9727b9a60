#!/usr/bin/env python3
"""Another revision against this one for one kernel's wrapper, on one
NVIDIA card, in one process: ``flash_attention`` (the default, in one
dtype), ``segment_matmul`` (in each dtype) or ``masked_intersect`` (at
each of its timed shapes).

    git archive <revision> | tar -x -C build/other
    python3 scripts/flash_ab.py --other build/other [--dtype fp32]
    python3 scripts/flash_ab.py --other build/other --kernel segment_matmul
    python3 scripts/flash_ab.py --other build/other --kernel masked_intersect

``--other`` is the root of a checkout of another revision of this repo (any
from the one that added ``src/repro_torch/kernels/flash_attention.py`` on).
Its ``repro_torch`` package is loaded under another name, so its wrapper
builds its own kernel source into its own ``build/`` directory and calls
its own C entry, whatever that entry's arguments.  The two wrappers are
timed on the same seeded inputs:

- ``flash_attention`` at the co-workload's Llama-3-8B shape, H=32 S=8192
  D=128, causal, in the chosen dtype (``--dtype``, bf16 by default);
- ``segment_matmul`` at the co-workload's GraphSAGE shape: messages
  ``features[edge_src]`` and ``edge_dst`` of
  ``NeighborSampler(planted_clique_graph(32768, 354000, 32, seed=0),
  batch_nodes=512, fanout=(25, 10), d_feat=256)``'s first sample (E =
  140,800, N = 141,313, D = 256), in fp32 and bf16 (or the one
  ``--dtype`` names), with ``dst`` as the sampler gives it (sorted) and
  with the edges shuffled (``torch.randperm`` from seed 0, messages and
  ``dst`` alike); after each turn the wrapper's output is kept, and the
  four must agree bit for bit;
- ``masked_intersect`` on seeded random words at ``chip_smoke.py``'s
  timed shapes: the clique path's (B=64 N=32768 W=1024) without and with
  a row mask, and the pattern probe's (1,024 rows, one all-ones column,
  masked) at phase 10a's width of 1,024 words and phase 10b's of 256.

They take turns (other, this, this, other), each turn the median of
``REPS`` calls timed with CUDA events, as ``chip_smoke.py`` times a
kernel (``masked_intersect``: its device work alone, behind a queued
spin kernel, ``chip_smoke.queued_ms``).  Both outputs are held against
the plain version with ``chip_smoke.py``'s limits for that kernel and
dtype first (``masked_intersect``: exactly).  Prints the card's name and
power limit, one line per turn, and last a JSON line with every turn's
time and each wrapper's mean of its two turns (for attention also the
TFLOP/s of each, 4*H*D*S(S+1)/2 flops).
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

import chip_smoke  # noqa: E402  (cuda_ms, nvidia_smi, errors, fail, ...)

H, S, D = 32, 8192, 128
FLOPS = 4 * H * D * S * (S + 1) / 2
REPS = 20
OTHER = "other_repro_torch"


def load_other(root: Path, kernel: str):
    """The other checkout's ``repro_torch.kernels.<kernel>``, as
    ``other_repro_torch.kernels.<kernel>`` (the kernel modules import each
    other relatively)."""
    package = root.resolve() / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, package / "__init__.py",
        submodule_search_locations=[str(package)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{OTHER}.kernels.{kernel}")


def attention_inputs(dtype):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return tuple(torch.randn((H, S, D), generator=gen, device="cuda")
                 .to(dtype) for _ in range(3))


def segment_inputs():
    """The GraphSAGE cell's first sample: fp32 features, edge sources and
    destinations on the card, and the padded node count."""
    from repro_torch.data.pipeline import NeighborSampler
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    sampler = NeighborSampler(planted_clique_graph(**chip_smoke.FULL_GRAPH),
                              **chip_smoke.SAGE, seed=0)
    return (*chip_smoke.sage_batch(sampler, 0), sampler.n_pad)


def take_turns(kernel: str, dt: str, run_other, run_this, want,
               bitwise: bool = False) -> dict:
    """Check both outputs, then time other, this, this, other; with
    ``bitwise`` the output after each turn must equal the first's bit for
    bit."""
    import torch
    for what, run in (("other", run_other), ("this", run_this)):
        if kernel == "masked_intersect":
            if not torch.equal(run(), want):
                chip_smoke.fail(f"{kernel} {dt} {what}: differs from the "
                                f"plain version")
            print(f"{kernel} {dt} {what}: exact")
            continue
        errs = chip_smoke.errors(kernel, dt.split()[0], run(), want, what)
        rel = (f", of a head relative {errs['max_rel_err']:.3g}"
               if "max_rel_err" in errs else "")
        print(f"{kernel} {dt} {what}: max abs err "
              f"{errs['max_abs_err']:.3g}{rel}")
    turns, first = [], None
    for what in ("other", "this", "this", "other"):
        run = run_other if what == "other" else run_this
        ms = chip_smoke.queued_ms(run, REPS) \
            if kernel == "masked_intersect" else chip_smoke.cuda_ms(run, REPS)
        turns.append((what, ms))
        if bitwise:
            out = run().view(torch.int32)
            if first is None:
                first = out
            elif not torch.equal(out, first):
                chip_smoke.fail(f"{kernel} {dt}: the {what} turn's output "
                                f"differs from the first turn's (other) "
                                f"bit for bit")
        rate = (f", {FLOPS / ms / 1e9:.1f} TFLOP/s"
                if kernel == "flash_attention" else "")
        print(f"{kernel} {dt} {what}: {ms:.4f} ms{rate}")
    mean = {w: statistics.mean(ms for t, ms in turns if t == w)
            for w in ("other", "this")}
    out = {"dtype": dt, "turns": [{"kernel": w, "ms": ms} for w, ms in turns],
           "mean_ms": mean, "speedup": mean["other"] / mean["this"]}
    if kernel == "flash_attention":
        out["tflop_s"] = {w: FLOPS / ms / 1e9 for w, ms in mean.items()}
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of a checkout of another revision")
    parser.add_argument("--kernel", default="flash_attention",
                        choices=("flash_attention", "segment_matmul",
                                 "masked_intersect"),
                        help="the wrapper to time (default flash_attention)")
    parser.add_argument("--dtype", choices=("bf16", "fp32"),
                        help="attention's q/k/v dtype (default bf16); for "
                             "segment_matmul the messages' (default both)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    other = load_other(args.other, args.kernel)
    dtypes = chip_smoke.torch_dtypes()

    if args.kernel == "flash_attention":
        from repro_torch.kernels import flash_attention as fa
        dt = args.dtype or "bf16"
        q, k, v = attention_inputs(dtypes[dt])
        results = [take_turns(
            "flash_attention", dt, lambda: other.flash_attention(q, k, v),
            lambda: fa.flash_attention(q, k, v),
            fa.flash_attention_plain(q, k, v))]
        shape = {"H": H, "S": S, "D": D, "causal": True}
    elif args.kernel == "masked_intersect":
        from repro_torch.kernels import masked_intersect as mi
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)

        def words(*shape):
            return torch.randint(-2**31, 2**31, shape, generator=gen,
                                 dtype=torch.int64, device="cuda").int()
        results, shape = [], {}
        for name, (b, n, w), masked in (
                ("clique", chip_smoke.MAIN_SHAPE, False),
                ("clique masked", chip_smoke.MAIN_SHAPE, True),
                *((f"pattern probe W={shape[2]}", shape, True)
                  for shape in chip_smoke.TIMED_PROBE_SHAPES)):
            a = words(b, w)
            cols = torch.full((n, w), -1, dtype=torch.int32, device="cuda") \
                if name.startswith("pattern probe") else words(n, w)
            mask = words(b, w) if masked else None
            results.append(take_turns(
                "masked_intersect", name,
                lambda: other.masked_intersect(a, cols, mask),
                lambda: mi.masked_intersect(a, cols, mask),
                mi.masked_intersect_plain(a, cols, mask)))
            shape[name] = {"B": b, "N": n, "W": w, "masked": masked}
    else:
        from repro_torch.kernels import segment_matmul as sm
        feats, src, dst, n = segment_inputs()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        perm = torch.randperm(dst.numel(), generator=gen, device="cuda")
        results = []
        for dt in ([args.dtype] if args.dtype else ["fp32", "bf16"]):
            for edges in ("sorted", "shuffled"):
                msg = feats.to(dtypes[dt])[src]
                d = dst
                if edges == "shuffled":
                    msg, d = msg[perm], dst[perm]
                results.append(take_turns(
                    "segment_matmul", f"{dt} {edges}",
                    lambda: other.segment_matmul(msg, d, n),
                    lambda: sm.segment_matmul(msg, d, n),
                    sm.segment_matmul_plain(msg, d, n), bitwise=True))
                results[-1]["bit_identical"] = True
        shape = {"E": int(dst.numel()), "N": n, "D": chip_smoke.SAGE["d_feat"]}
    print(json.dumps({"kernel": args.kernel, "shape": shape,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
