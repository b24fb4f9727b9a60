"""The port stands alone: importing every module of repro_torch (the
checkpoint, runtime, service, launch and distributed subpackages among
them) loads neither jax nor anything of repro, and no source of the port
(nor chip_smoke.py) names repro in an import."""
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    assert {"repro_torch.core.engine", "repro_torch.core.patterns",
            "repro_torch.core.aggregate", "repro_torch.core.exhaustive",
            "repro_torch.core.weighted_clique",
            "repro_torch.checkpoint.manager", "repro_torch.runtime",
            "repro_torch.runtime.fault_tolerance", "repro_torch.service",
            "repro_torch.service.api", "repro_torch.service.cache",
            "repro_torch.service.scheduler", "repro_torch.launch.serve",
            "repro_torch.distributed", "repro_torch.distributed.sharded_engine"
            } <= set(mods)
    assert len(mods) >= 35
    code = (f"import {', '.join(mods)}; import sys; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "bad = [m for m in sys.modules "
            "if m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    env = dict(os.environ)          # a stripped env can stall startup
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


IMPORT_REPRO = re.compile(
    r"^\s*(import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s+import))", re.M)


def test_no_port_source_imports_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in files
                 if IMPORT_REPRO.search(p.read_text())
                 or re.search(r"^\s*(import|from)\s+jax", p.read_text(),
                              re.M)]
    assert not offenders, offenders


def test_scan_catches_a_repro_import():
    for line in ("import repro", "from repro.core import bitset",
                 "from repro import obs", "import repro.obs"):
        assert IMPORT_REPRO.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import api"):
        assert not IMPORT_REPRO.search(line), line
