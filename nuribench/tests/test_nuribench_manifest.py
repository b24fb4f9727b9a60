"""``BENCHMARK.json`` against the benchmark's contract, every file it
names, and the benchmark's imports: nothing under ``nuribench/`` loads JAX
or the JAX package, and the reference loads nothing of the program."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "nuribench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "nuribench/run.py"]
    assert MANIFEST["paths"] == ["nuribench"]
    assert isinstance(MANIFEST["run_seconds"], int) and \
        1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_names_and_units(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(set(names)) == len(names)
    for e in MANIFEST[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e and kind in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                    and "\t" not in e[text]


def test_cells_metrics_and_bounds():
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert configs == {w["config"] for w in MANIFEST["workloads"]}
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
        assert any(m["name"] != "setup_s" and
                   cell in m.get("workloads", cells)
                   for m in MANIFEST["end_to_end"])


def test_every_named_file_exists():
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("nuribench/")
        config = json.loads(path.read_text())
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(config["published"])
        for key in c["reduced"]:
            assert NAME.fullmatch(key)
            assert config[key] != config["published"][key]
        assert (BENCH / "reference" / f"{config['reference']}.py").is_file()
    for w in MANIFEST["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def _defines(path: Path, name: str) -> bool:
    """Does the file define the function ``name`` at its top level?"""
    tree = ast.parse(path.read_text(), str(path))
    return any(isinstance(n, ast.FunctionDef) and n.name == name
               for n in tree.body)


@pytest.mark.parametrize("conf", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_every_configuration_has_tiny_and_a_generator(conf):
    """The tests' CPU size is the configuration's own (``tiny``: size keys
    of the configuration, request fields under ``request``), and its
    generator is a file of ``gen/`` with ``make(config, seed)``."""
    config = json.loads((ROOT / conf["file"]).read_text())
    tiny = config["tiny"]
    assert isinstance(tiny, dict) and tiny
    sizes = {k: v for k, v in tiny.items() if k != "request"}
    assert set(sizes) <= set(config) and all(
        isinstance(v, int) and v > 0 for v in sizes.values())
    assert isinstance(tiny.get("request", {}), dict)
    gen = BENCH / "gen" / f"{config['generator']}.py"
    assert gen.is_file() and _defines(gen, "make"), gen


def _imports(path: Path):
    """Top-level names of the modules a file imports (absolute imports,
    and ``importlib``/``__import__`` calls with a literal name)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            yield node.args[0].value.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))
#: the JAX package's benchmark folder, which nothing here reads (written
#: in two parts so that this file's own code does not name it)
JAX_BENCH = "benchmarks" + "/"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_program_in_the_reference(path):
    names = set(_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names, names
    assert not any(JAX_BENCH in text for text in _strings(path))


def _strings(path: Path):
    """The string constants of a file's code, docstrings left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)
            and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_import_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jaxlib import x\n"
                 "import importlib\nimportlib.import_module('repro.core')\n")
    assert set(_imports(f)) == {"repro_torch", "jaxlib", "importlib",
                                "repro"}
