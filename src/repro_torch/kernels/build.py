"""Build and load the CUDA kernels under ``csrc/`` at first use — the
counterpart of ``repro.kernels.runtime``, which picks how a Pallas kernel
runs; here a kernel always runs compiled, on the card.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, which the
kernel's wrapper loads with ``ctypes`` and calls on PyTorch's current
stream (:func:`launch_on`).  The library's
file name carries a hash of the source, the shared headers and the flags,
so an edited source is rebuilt and an unchanged one is loaded from the
build directory (``build/repro_torch`` at the repository root, listed in
``.gitignore``).  :func:`build_all` starts one ``nvcc`` per source, all at
once, and waits for every one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, Callable[..., int]] = {}   # name -> its declared C entry


def sources() -> Dict[str, Path]:
    """Kernel name -> CUDA source, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the kernel's library goes: named by a hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    text = sources()[name].read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output for the kernel's library, beside it."""
    return library_path(name).with_suffix(".log")


def _read(path: Path) -> str:
    return path.read_text() if path.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (default: all) whose library is missing,
    one ``nvcc`` process per source, all started together.  Returns, per
    kernel, ``{"seconds", "log"}``: ``log`` holds ``ptxas``' register,
    spill and shared-memory report, kept beside the library
    (:func:`log_path`) and read from there for a library already built,
    whose ``seconds`` is 0.  Raises with the compiler's output if any
    build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    report = {name: {"seconds": 0.0, "log": _read(log_path(name))}
              for name in names if library_path(name).exists()}
    todo = [name for name in names if name not in report]
    compiler = nvcc() if todo else ""
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        log_path(name).write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def launch(name: str, argtypes: Sequence, *args) -> None:
    """Call the kernel's C entry ``<name>_launch(*args)`` and raise if it
    returns a CUDA error (a launch the card refused never runs, and a later
    synchronize would not report it).  ``argtypes`` are declared before the
    first call: without them ctypes passes every int as a C int and cuts
    the 64-bit pointers."""
    entry = _ENTRIES.get(name)
    if entry is None:
        lib = load(name)
        entry = getattr(lib, f"{name}_launch")
        entry.argtypes = list(argtypes)
        entry.restype = ctypes.c_int
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        _ENTRIES[name] = entry
    err = entry(*args)
    if err:
        text = getattr(load(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({text})")


def launch_on(device: torch.device, name: str, argtypes: Sequence,
              *args) -> None:
    """:func:`launch` on ``device``, with the raw handle of PyTorch's
    current stream there as the entry's last argument, and ``device`` made
    the current device around the call where it is not already.  A short
    call's time on the card includes the host's enqueue, so the handle
    comes from PyTorch's raw accessor (what
    ``torch.cuda.current_stream(device).cuda_stream`` returns, without
    building a ``Stream`` object)."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        launch(name, argtypes, *args, stream)
    else:
        with torch.cuda.device(device):
            launch(name, argtypes, *args, stream)
