#!/usr/bin/env python3
"""Two ceilings of ``masked_intersect``'s tensor-core kernel, measured
apart from it on one NVIDIA card (``scripts/mi_ceilings.cu``):

    python3 scripts/mi_ceilings.py

- the tensor cores' rate for the kernel's 1-bit
  ``wgmma.m64n64k256.s32.b1.b1.and.popc`` (A from registers, commit
  groups of 8, wait 0) at 1 to 3 warpgroups a block, one block an SM,
  beside ``wgmma.m64n64k32.s32.u8.u8`` (the same count as a product of
  0/1 bytes) issued the same way, as operations a second and as the time
  each would take for the clique shape's 64 x 32,768 x 32,768 bits (B x
  N x 32 W);
- b's stream as the kernel reads it (256 columns a block, cp.async of 16
  bytes, two stages in flight) at 64 and 128 bytes a column a stage (the
  kernel reads 128), beside the bytes over 3.35 TB/s, at the clique
  shape's b (N = 32,768, W = 1,024 words).

Prints the card's name and power limit, a line a measurement and last a
JSON line with them all.  Builds with ``nvcc`` into ``build/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (queued_ms, nvidia_smi, fail)

B, N, W = chip_smoke.MAIN_SHAPE
ITERS = 2000
KINDS = {"u8 m64n64k32": (0, 32), "b1 m64n64k256 and.popc": (1, 256)}


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    lib_path = build.BUILD_DIR / "libmi_ceilings.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    made = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path),
                           str(ROOT / "scripts" / "mi_ceilings.cu")],
                          capture_output=True, text=True, timeout=300)
    if made.returncode:
        chip_smoke.fail(f"nvcc: {made.stdout}{made.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.wgmma_rate_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.stream_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 384, dtype=torch.int32, device="cuda")
    results = {"wgmma": [], "stream": []}
    bits = B * N * 32 * W                       # bit-MACs of the clique call
    for name, (kind, k_bits) in KINDS.items():
        for wgs in (1, 2, 3):
            def run():
                err = lib.wgmma_rate_launch(kind, sms, wgs, ITERS,
                                            out.data_ptr(), stream())
                if err:
                    chip_smoke.fail(f"wgmma_rate {name}: CUDA error {err}")
            ms = chip_smoke.queued_ms(run, reps=5)
            macs = 64 * 64 * k_bits * 8 * ITERS * wgs * sms
            rate = macs / (ms * 1e-3)             # bit-MACs a second
            results["wgmma"].append(dict(
                instruction=name, warpgroups=wgs, ms=ms,
                bit_ops_per_s=2 * rate, clique_ms=1e3 * bits / rate))
            print(f"[wgmma {name}, {wgs} warpgroups] {ms:.4f} ms: "
                  f"{2 * rate / 1e12:.1f} T bit-operations/s; the clique "
                  f"call's {2 * bits:.4g} in {1e3 * bits / rate:.4f} ms")
    b = torch.randint(-2**31, 2**31, (N, W), dtype=torch.int64,
                      device="cuda").int()
    for cw in (16, 32):
        def run():
            err = lib.stream_launch(cw, b.data_ptr(), N, W, out.data_ptr(),
                                    stream())
            if err:
                chip_smoke.fail(f"stream: CUDA error {err}")
        ms = chip_smoke.queued_ms(run)
        results["stream"].append(dict(bytes_a_column=4 * cw, ms=ms,
                                      bytes_per_s=4 * N * W / (ms * 1e-3)))
        print(f"[stream {4 * cw} B a column a stage] {ms:.4f} ms: "
              f"{4 * N * W / ms / 1e9:.3f} TB/s (bound "
              f"{1e3 * 4 * N * W / chip_smoke.HBM_BYTES_PER_S:.4f} ms)")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
