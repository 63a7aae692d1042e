"""Boundaries of the port: what it imports, where it runs, what it
refuses.

* No file under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (checked on the syntax tree, and by importing the
  port in a fresh process).
* Entry points run on the card unless the caller asks for the CPU: with
  no CUDA device they raise, and ``device="cpu"`` works.
* ``JoinBackend.CUDA`` with CPU tensors raises; nothing falls back.
* ``chip_smoke.py`` without a card, or alone in a directory, exits
  non-zero and prints no result.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.core import engine, multi, state
from repro_torch.core.plan import compile_plan
from repro_torch.core.query import QueryGraph
from repro_torch.runtime.service import ContinuousSearchService

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
MODULES = [
    "repro_torch", "repro_torch.core.engine", "repro_torch.core.multi",
    "repro_torch.core.registry", "repro_torch.runtime.service",
    "repro_torch.kernels.compat_join.ops",
    "repro_torch.kernels.compat_join.kernel",
    "repro_torch.stream.generator", "repro_torch.analysis",
]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _foreign(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _plan():
    q = QueryGraph(3, (0, 1, 2), ((0, 1), (1, 2)), prec=frozenset({(0, 1)}))
    return compile_plan(q, 10, level_capacity=16, l0_capacity=16, max_new=8)


@pytest.mark.parametrize("entry", [
    "init_state", "init_slot_state", "build_tick", "make_batch",
    "service", "service_cuda_device"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = _plan()
    calls = {
        "init_state": lambda **kw: state.init_state(plan, **kw),
        "init_slot_state": lambda **kw: multi.init_slot_state(plan, 2, **kw),
        "build_tick": lambda **kw: engine.build_tick(plan, **kw),
        "make_batch": lambda **kw: state.make_batch([0], [1], [2], [0], [1],
                                                    [0], **kw),
        "service": lambda **kw: ContinuousSearchService(**kw),
        "service_cuda_device": lambda **kw: ContinuousSearchService(
            **{"device": "cuda", **kw}),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    if entry != "service_cuda_device":
        calls[entry](device="cpu")             # the CPU on request


def test_cuda_backend_with_cpu_tensors_raises():
    plan = _plan()
    with pytest.raises(ValueError, match="CUDA"):
        engine.build_tick(plan, backend="cuda", device="cpu")
    body = engine.build_tick_body(plan, backend="cuda")
    st = multi.init_slot_state(plan, 1, device="cpu")
    b = state.make_batch([0], [1], [2], [0], [1], [0], device="cpu")
    em = torch.ones((1, 2, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        body(st.engines, b, em, st.params.window)


def test_later_slices_raise_not_implemented():
    with pytest.raises(NotImplementedError):
        engine.build_tick_body(_plan(), prefix_depth=1)
    with pytest.raises(NotImplementedError):
        engine.build_tick_body(_plan(), axis_name="data", n_shards=2)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not alone:
        env["CUDA_VISIBLE_DEVICES"] = ""        # no card
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
