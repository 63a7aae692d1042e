"""Boundaries of the port: what it imports, where it runs, what it
refuses.

* No file under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (checked on the syntax tree, and by importing the
  port in a fresh process).
* Entry points run on the card unless the caller asks for the CPU: with
  no CUDA device they raise, and ``device="cpu"`` works.
* The kernels' wrappers run where their tensors lie: the plain version
  on CPU tensors, without a launch; ``backend="cuda"`` with CPU tensors
  raises, and nothing falls back.
* ``JoinBackend.CUDA`` with CPU tensors raises; nothing falls back.
* What a later item ports (a mesh of distinct devices) raises
  ``NotImplementedError``; what the port serves (replica and capacity
  sharding, sharded checkpoints, restores onto a mesh) runs.
* ``chip_smoke.py`` without a card, or alone in a directory, exits
  non-zero and prints no result.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import (
    gat_cora,
    gin_tu,
    nequip,
    pna,
    qwen3_14b,
    wide_deep,
)
from repro_torch.core import engine, multi, state
from repro_torch.core import join as TJ
from repro_torch.core.plan import compile_plan
from repro_torch.data.graphs import graph_to_device
from repro_torch.data.recsys import batch_to_device
from repro_torch.kernels.compat_join import ops as cj_ops
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.models.common import params_from_numpy
from repro_torch.models.gnn.models import GAT, GIN, PNA
from repro_torch.models import transformer
from repro_torch.models.gnn.nequip import NequIP
from repro_torch.models.transformer import LM
from repro_torch.models.recsys.wide_deep import WideDeep
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
    "repro_torch.kernels.embedding_bag.ops",
    "repro_torch.kernels.embedding_bag.kernel",
    "repro_torch.kernels.segment_reduce.ops",
    "repro_torch.kernels.segment_reduce.kernel",
    "repro_torch.models.recsys.wide_deep", "repro_torch.models.gnn.models",
    "repro_torch.models.gnn.message", "repro_torch.data.recsys",
    "repro_torch.data.graphs", "repro_torch.configs.wide_deep",
    "repro_torch.configs.gin_tu", "repro_torch.core.share",
    "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
    "repro_torch.obs.export", "repro_torch.obs.summarize",
    "repro_torch.api", "repro_torch.api.events", "repro_torch.api.pattern",
    "repro_torch.api.planner", "repro_torch.api.session",
    "repro_torch.launch.stream_serve", "repro_torch.stream",
    "repro_torch.stream.ingest", "repro_torch.stream.chaos",
    "repro_torch.runtime", "repro_torch.runtime.fault",
    "repro_torch.runtime.mesh", "repro_torch.analysis.ast_lint",
    "repro_torch.analysis.kernel_check", "repro_torch.analysis.cli",
    "repro_torch.models.gnn.nequip", "repro_torch.models.gnn.sampler",
    "repro_torch.configs.gat_cora", "repro_torch.configs.pna",
    "repro_torch.configs.nequip", "repro_torch.core.sjtree",
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.compress", "repro_torch.optim.schedule",
    "repro_torch.optim.tree", "repro_torch.launch.cells",
    "repro_torch.models.common", "repro_torch.models.attention",
    "repro_torch.models.moe", "repro_torch.models.transformer",
    "repro_torch.data.lm", "repro_torch.configs.registry",
    "repro_torch.configs.deepseek_coder_33b",
    "repro_torch.configs.qwen3_14b", "repro_torch.configs.internlm2_20b",
    "repro_torch.configs.arctic_480b", "repro_torch.configs.grok1_314b",
    "repro_torch.launch.train", "repro_torch.launch.dryrun",
    "repro_torch.launch.roofline",
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
    "service", "service_cuda_device", "wide_deep", "gin",
    "batch_to_device", "graph_to_device", "params_from_numpy",
    "shared_service", "init_node_state", "stream_session", "stream_server",
    "service_restore", "session_frontier", "service_frontier",
    "session_restore_ingest", "sharded_service", "mesh_session",
    "make_mesh", "sharded_tick", "gat", "pna", "nequip", "lm", "lm_init",
    "train_lm"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    from repro_torch.api import StreamSession
    from repro_torch.core.distributed import build_sharded_tick, make_mesh
    from repro_torch.core.share import init_node_state, node_spec
    from repro_torch.launch.train import train_lm
    from repro_torch.launch.stream_serve import StreamServer
    from repro_torch.runtime.mesh import ShardedSearchService

    from repro_torch.core.oracle import DataEdge
    from repro_torch.stream.ingest import IngestFrontier, ListSource

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = _plan()
    ckpt = tmp_path / "ckpt"

    def frontier():
        return IngestFrontier([ListSource("a", [
            DataEdge(0, 1, t, 0, 1, 0) for t in range(5)])],
            sleep=lambda d: None)

    def serve_session(sess):
        sess.register_query(plan.query, plan.window)
        return sess.serve_frontier(sess.sources(
            {"a": [DataEdge(0, 1, t, 0, 1, 0) for t in range(5)]}))

    def serve_service(svc):
        svc.register(plan.query, plan.window)
        return svc.serve_frontier(frontier())
    if entry in ("service_restore", "session_restore_ingest"):
        sess = StreamSession(device="cpu", ckpt_dir=str(ckpt))
        sess.register_query(plan.query, plan.window)
        sess.serve_frontier(frontier(), ckpt_every=1)
        sess.service.ckpt.wait()
    def mesh(device=None):        # a mesh takes its devices, repeated
        return make_mesh((2,), ("data",), devices=None if device is None
                         else (device,) * 2)

    calls = {
        "make_mesh": mesh,
        "sharded_tick": lambda **kw: build_sharded_tick(plan, mesh(**kw)),
        "sharded_service": lambda **kw: ShardedSearchService(**kw),
        "mesh_session": lambda **kw: StreamSession(mesh=2, **kw),
        "session_frontier": lambda **kw: serve_session(StreamSession(**kw)),
        "service_frontier": lambda **kw: serve_service(
            ContinuousSearchService(**kw)),
        "session_restore_ingest": lambda **kw: StreamSession.restore(
            str(ckpt), **kw).restored_ingest,
        "shared_service": lambda **kw: ContinuousSearchService(
            enable_sharing=True, **kw),
        "init_node_state": lambda **kw: init_node_state(node_spec(plan, 1),
                                                        **kw),
        "stream_session": lambda **kw: StreamSession(**kw),
        "stream_server": lambda **kw: StreamServer(plan, **kw),
        "service_restore": lambda **kw: ContinuousSearchService.restore(
            str(ckpt), **kw),
        "init_state": lambda **kw: state.init_state(plan, **kw),
        "init_slot_state": lambda **kw: multi.init_slot_state(plan, 2, **kw),
        "build_tick": lambda **kw: engine.build_tick(plan, **kw),
        "make_batch": lambda **kw: state.make_batch([0], [1], [2], [0], [1],
                                                    [0], **kw),
        "service": lambda **kw: ContinuousSearchService(**kw),
        "service_cuda_device": lambda **kw: ContinuousSearchService(
            **{"device": "cuda", **kw}),
        "wide_deep": lambda **kw: WideDeep(wide_deep.smoke_config(), **kw),
        "gin": lambda **kw: GIN(gin_tu.smoke_config(), **kw),
        "gat": lambda **kw: GAT(gat_cora.smoke_config(), **kw),
        "pna": lambda **kw: PNA(pna.smoke_config(), **kw),
        "nequip": lambda **kw: NequIP(nequip.smoke_config(), **kw),
        "lm": lambda **kw: LM(qwen3_14b.smoke_config(), **kw),
        "lm_init": lambda **kw: transformer.init(
            torch.Generator(), qwen3_14b.smoke_config(), **kw),
        "train_lm": lambda **kw: train_lm(qwen3_14b.smoke_config(), 1, 2, 8,
                                          **kw),
        "batch_to_device": lambda **kw: batch_to_device(
            {"dense": np.zeros((2, 3), np.float32)}, **kw),
        "graph_to_device": lambda **kw: graph_to_device(
            {"x": np.zeros((2, 3), np.float32), "n_graphs": 1}, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(
            {"w": [np.ones(2, np.float32)]}, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    if entry != "service_cuda_device":
        calls[entry](device="cpu")             # the CPU on request


def _op_args(op):
    """Small CPU inputs of each kernel wrapper."""
    i32 = torch.int32
    if op == "compat_mask":
        t = (torch.zeros((1, 3, 2), dtype=i32), torch.zeros((1, 3, 1), dtype=i32),
             torch.ones((1, 3), dtype=torch.bool), torch.zeros((4, 2), dtype=i32),
             torch.ones((4, 1), dtype=i32), torch.ones((1, 4), dtype=torch.bool))
        rel = np.array([[False, False], [True, False]])
        return cj_ops.compat_mask, t + (rel, np.array([[-1]], np.int8))
    if op == "embedding_bag":
        ids = torch.tensor([0, -1, 2, 1], dtype=i32)
        bags = torch.tensor([0, 0, 1, 1], dtype=i32)
        return eb_ops.embedding_bag, (ids, bags, torch.ones((3, 2)), 2)
    dst = torch.tensor([0, 1, 1, -1], dtype=i32)
    return sr_ops.segment_sum, (dst, torch.ones((4, 2)), 2)


@pytest.mark.parametrize("op", ["compat_mask", "embedding_bag",
                                "segment_sum"])
def test_kernel_wrappers_run_where_their_tensors_lie(op, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, args = _op_args(op)
    before = fn.launches
    out = fn(*args)                       # CPU tensors: the plain version
    assert out.device.type == "cpu" and fn.launches == before
    if op == "compat_mask":
        with pytest.raises(ValueError, match="CUDA"):
            TJ.compat_mask(*args, backend="cuda")
    else:
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, backend="cuda")


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


def test_later_slices_raise_not_implemented(tmp_path):
    """The capacity-sharding slice runs on a mesh of one device (repeats
    allowed): sharding one engine's capacity axis (``axis_name``/
    ``n_shards``), placing a checkpoint onto the mesh
    (``restore_checkpoint(mesh=, specs=)``, ``reshard``) and a sharded
    restore in ``FaultTolerantLoop``.  What is left to a later item — a
    mesh of distinct devices — raises."""
    from repro_torch.checkpoint import (
        reshard,
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.core.distributed import P, make_mesh
    from repro_torch.runtime.fault import FaultTolerantLoop

    mesh = make_mesh((2,), ("data",), devices=("cpu",) * 2)
    body = engine.build_tick_body(_plan(), axis_name="data", n_shards=2)
    assert callable(body)
    specs = {"a": P("data")}
    got = reshard({"a": torch.ones(2)}, mesh, specs)
    assert got["a"].device == torch.device("cpu")
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)})
    got = restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)},
                             mesh=mesh, specs=specs)
    assert got["a"].tolist() == [1.0, 1.0]
    loop = FaultTolerantLoop(str(tmp_path / "loop"), lambda s, i: s,
                             lambda: {"a": torch.zeros(2)}, mesh=mesh,
                             specs=specs)
    assert loop.run(1)["a"].tolist() == [0.0, 0.0]
    with pytest.raises(NotImplementedError, match="distinct"):
        make_mesh((2,), ("data",), devices=("cpu", "meta"))


def test_shared_prefix_depth_is_range_checked():
    engine.build_tick_body(_plan(), prefix_depth=2)
    with pytest.raises(ValueError, match="out of range"):
        engine.build_tick_body(_plan(), prefix_depth=3)


def test_replica_sharding_is_served(tmp_path):
    """The replica-sharding slice runs: a mesh session on CPU replicas
    is a ``ShardedSearchService``, and sharded checkpoints are written
    as per-replica files."""
    from repro_torch.api import StreamSession
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.runtime.mesh import ShardedSearchService

    sess = StreamSession(mesh=2, device="cpu")
    assert isinstance(sess.service, ShardedSearchService)
    assert sess.service.mesh == (torch.device("cpu"),) * 2
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(4)}, n_shards=2)
    assert sorted(os.listdir(tmp_path)) == [
        "step_1.json", "step_1.shard0of2.npz", "step_1.shard1of2.npz"]


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
