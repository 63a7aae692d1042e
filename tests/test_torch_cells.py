"""The port's launch layer (``launch.cells``, ``launch.roofline``,
``launch.dryrun``) against the reference's ``repro.launch``.

* ``all_cells()`` is the reference's 40 (arch, shape) pairs, in order.
* Every cell, built on the meta device, has argument leaves (a module
  read through ``params()``) whose shapes and dtypes are the reference
  cell's ``ShapeDtypeStruct``s, in the reference's leaf order, and the
  reference's ``meta`` (integer arithmetic, equal) and ``donate``.
* ``lm_param_flops`` lands near the nameplates (the reference's test).
* ``roofline_terms`` at the H100 constants gives 1.0 s a term;
  ``collective_bytes`` over records of the reference fixture's four ops
  equals the reference's parse of the fixture's HLO text.
* ``run_cell`` on the cells of the reference's
  ``test_build_cell_without_mesh`` (deepseek's ``train_4k`` cut to one
  layer: its 62 layers take a minute on the meta device) records ``ok``
  and FLOPs; a dense smoke train step's FLOPs equal a hand count of its
  products (forward and twice that backward) within 1%.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.launch import cells as RCELLS
from repro.launch import roofline as RRL
from test_roofline_and_cells import HLO

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import qwen3_14b
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch.cells import (
    all_cells,
    build_cell,
    cell_for,
    cell_leaves,
    lm_param_flops,
)

ALL = RCELLS.all_cells()


def test_all_cells_equal_the_reference():
    assert all_cells() == ALL
    assert len(ALL) == 40 and len({a for a, _ in ALL}) == 10


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.") if torch.is_tensor(x) \
        else str(np.dtype(x.dtype))


@pytest.mark.parametrize("arch_id,shape", ALL,
                         ids=[f"{a}-{s}" for a, s in ALL])
def test_cell_shapes_dtypes_and_meta_equal_the_reference(arch_id, shape):
    ref = RCELLS.build_cell(arch_id, shape, mesh=None)
    cell = build_cell(arch_id, shape)
    want = jax.tree.leaves(ref.args)
    got = cell_leaves(cell)
    assert all(t.device.type == "meta" for t in got)
    assert [(tuple(x.shape), _dtype(x)) for x in got] \
        == [(tuple(x.shape), _dtype(x)) for x in want]
    assert cell.meta == ref.meta
    assert cell.donate == ref.donate
    assert cell.skip_reason == ref.skip_reason
    assert (cell.arch_id, cell.shape_name) == (arch_id, shape)


def test_a_mesh_of_more_than_one_entry_raises():
    """A one-process mesh of distinct devices raises (a distinct device
    is another process's), and a process-group mesh builds: rank 0 of a
    2 × 2 ``("data", "model")`` mesh under the "fake" backend holds its
    blocks of the arguments (a one-process mesh of one device builds the
    one-card program with the shardings attached)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    with pytest.raises(NotImplementedError):
        build_cell("gat-cora", "full_graph_sm",
                   make_mesh((2,), ("data",), devices=("cpu", "meta")))
    one = build_cell("gat-cora", "full_graph_sm",
                     make_mesh((2,), ("data",), devices=("cpu",) * 2))
    assert one.meta == build_cell("gat-cora", "full_graph_sm").meta
    assert one.in_shardings is not None
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), devices=("meta",) * 4,
                         group=dist.group.WORLD)
        cell = build_cell("wide-deep", "train_batch", mesh)
        whole = build_cell("wide-deep", "train_batch")
        got = cell.args[0].params()
        want = whole.args[0].params()
        # tables P(None, "model", None): half the rows; the MLP whole
        assert got["tables"].shape[1] * 2 == want["tables"].shape[1]
        assert got["mlp"][0]["w"].shape == want["mlp"][0]["w"].shape
        assert cell.args[2]["labels"].shape[0] * 2 == \
            whole.args[2]["labels"].shape[0]
    finally:
        dist.destroy_process_group()


def test_lm_param_counts_match_published_scale():
    expect = {"deepseek-coder-33b": 33e9, "qwen3-14b": 14e9,
              "internlm2-20b": 20e9, "arctic-480b": 480e9,
              "grok-1-314b": 314e9}
    for aid, nominal in expect.items():
        total, active = lm_param_flops(ARCHS[aid].config)
        assert 0.55 * nominal < total < 1.45 * nominal, (aid, total)
        assert active <= total


def test_roofline_terms_at_the_h100_constants():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12}
    coll = {"total": 450e9}
    t = RL.roofline_terms(cost, coll, n_chips=4, model_flops=4 * 989e12)
    for k in ("compute_s", "memory_s", "collective_s", "useful_flops_ratio"):
        np.testing.assert_allclose(t[k], 1.0)
    assert set(t) == set(RRL.roofline_terms(
        cost, coll, n_chips=4, model_flops=1.0))


def test_collective_bytes_equal_the_reference_parse():
    records = [("all-reduce", 1024 * 512 * 4, 4),
               ("all-gather", 2048 * 128 * 2, 2),
               ("reduce-scatter", 256 * 4, 4),
               ("collective-permute", 64 * 4, 2)]
    assert RL.collective_bytes(records) == RRL.collective_bytes(HLO)
    assert RL.collective_bytes([])["total"] == 0.0
    with pytest.raises(KeyError):
        RL.collective_bytes([("broadcast", 8, 2)])


def _cut(arch_id, **cfg):
    arch = get_arch(arch_id)
    return dataclasses.replace(arch, config=dataclasses.replace(
        arch.config, **cfg))


@pytest.mark.parametrize("arch_id,shape", [
    ("deepseek-coder-33b", "train_4k"),
    ("arctic-480b", "decode_32k"),
    ("nequip", "molecule"),
    ("pna", "minibatch_lg"),
    ("wide-deep", "retrieval_cand"),
])
def test_run_cell_traces_on_meta(arch_id, shape, tmp_path):
    cell = None
    if shape == "train_4k":
        arch = _cut(arch_id, n_layers=1)
        cell = cell_for(arch, arch.shape(shape))
    rec = DR.run_cell(arch_id, shape, out_dir=str(tmp_path), cell=cell)
    assert rec["ok"] or rec.get("skipped"), rec.get("traceback")
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_bytes_per_device"]
    assert rec["roofline"]["n_chips"] == 1
    assert rec["collectives"]["total"] == 0.0
    path = tmp_path / "h100x1" / f"{arch_id}__{shape}.json"
    assert json.loads(path.read_text())["ok"] == rec["ok"]
    # an existing record is read back, not traced again
    assert DR.run_cell(arch_id, shape, out_dir=str(tmp_path))["wall_s"] \
        == rec["wall_s"]


def test_dense_train_step_flops_equal_a_hand_count():
    cfg = dataclasses.replace(qwen3_14b.smoke_config(), remat="none")
    arch = dataclasses.replace(get_arch("qwen3-14b"), config=cfg)
    b, s = 4, 64                       # two attention chunks of 32
    shape = dataclasses.replace(arch.shape("train_4k"), global_batch=b,
                                seq_len=s, microbatches=1)
    got = DR.trace_cell(cell_for(arch, shape))["cost"]["flops"]
    t, d = b * s, cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * t * d * hq * hd            # q
             + 2 * 2 * t * d * hkv * hd     # k, v
             + 2 * t * hq * hd * d          # o
             + 2 * 2 * b * hq * s * s * hd  # scores, P·V (every chunk)
             + 3 * 2 * t * d * cfg.d_ff)    # SwiGLU
    forward = cfg.n_layers * layer + 2 * t * d * cfg.vocab
    np.testing.assert_allclose(got, 3 * forward, rtol=1e-2)


def test_dry_run_main_exit_codes(tmp_path, monkeypatch):
    # --one-card: the CLI's default, as the reference's, is rank 0 of
    # pod16x16 under a process-wide "fake" group (tests/
    # test_torch_dryrun_mesh.py runs that in a subprocess)
    with pytest.raises(SystemExit) as ok:
        DR.main(argv=["--arch", "wide-deep", "--shape", "retrieval_cand",
                      "--one-card", "--out", str(tmp_path)])
    assert ok.value.code == 0

    def broken(*a, **k):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(DR, "build_cell", broken)
    with pytest.raises(SystemExit) as bad:
        DR.main(argv=["--arch", "gat-cora", "--shape", "molecule",
                      "--one-card", "--out", str(tmp_path)])
    assert bad.value.code == 1
    rec = json.loads((tmp_path / "h100x1" / "gat-cora__molecule.json")
                     .read_text())
    assert rec["ok"] is False and "no such cell" in rec["error"]
