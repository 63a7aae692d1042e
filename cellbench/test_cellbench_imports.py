"""What the benchmark runs loads neither JAX nor the JAX package (top-level
names compared whole), its reference nothing of the port, and every
name in ``BENCHMARK.json`` finds its file."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from cellbench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from cellbench import harness, run\n"
        "from cellbench.conftest import tiny\n"
        "import importlib\n"
        "for m in run.json.loads(run.ROOT.joinpath('BENCHMARK.json')"
        ".read_text())['per_layer']:\n"
        "    importlib.import_module('cellbench.metrics.' + m['name'])\n"
        "cfg, traffic = tiny('lsbench_share')\n"
        "harness.run_cell(cfg, traffic, 5, 0.3, True, device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "cellbench" in top
    assert not top & set(harness.FORBIDDEN)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "cellbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        assert _imports(f) <= {"__future__", "numpy", ""}, f


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    assert harness.forbidden_modules() == []      # repro_torch is loaded
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "reprox.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_every_name_finds_its_file():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert (ROOT / "cellbench" / "traffic" / f"{w['traffic']}.json") \
            .exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "cellbench" / "metrics" / f"{m['name']}.py").exists()
