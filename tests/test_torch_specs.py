"""The port's sharding specs against the reference's, entry for entry.

For every architecture of the registry, on the production meshes'
shapes ``(16, 16)`` ``("data", "model")`` and ``(2, 16, 16)`` ``("pod",
"data", "model")``: ``MeshAxes.for_mesh``, ``transformer.param_specs``
and ``cache_specs``, ``wide_deep.param_specs``, ``gnn.models.
param_specs``, ``adamw.state_specs`` in all three state modes, and
every cell's ``in_shardings`` and ``out_shardings``.  A spec compares as
the tuple of its entries, each None or a tuple of axis names.  The
reference's specs are plain objects: its mesh here is a stand-in with
the axis names and sizes (no devices), and its cells' ``NamedSharding``
wrapper is patched to hand back the spec tree.  The port's cells are
built on a one-process mesh of the meta device (the one-card program
with the shardings attached), so no process group is needed.
"""

import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro.launch.cells as RC
from repro.configs.registry import ARCHS as R_ARCHS
from repro.models import transformer as r_tfm
from repro.models.common import MeshAxes as RAxes
from repro.models.gnn import models as r_gnn
from repro.models.recsys import wide_deep as r_wd
from repro.optim import AdamWConfig as RAdamW
from repro.optim.adamw import state_specs as r_state_specs
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.core.distributed import make_mesh
from repro_torch.launch.cells import build_cell
from repro_torch.models import transformer as t_tfm
from repro_torch.models.common import MeshAxes as TAxes
from repro_torch.models.gnn import models as t_gnn
from repro_torch.models.recsys import wide_deep as t_wd
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim.adamw import state_specs as t_state_specs
from repro_torch.optim.tree import flatten

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("fp32", "factored", "int8")


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)),
                                 devices=np.empty(shape, dtype=object))


def _port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=("meta",) * int(np.prod(shape)))


def _entry(e):
    if e is None:
        return None
    return (e,) if isinstance(e, str) else tuple(e)


def _ref_specs(tree) -> list:
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP)
                             or x is None)
    return [None if s is None else tuple(_entry(e) for e in s)
            for s in leaves]


def _port_specs(tree) -> list:
    return [None if s is None else tuple(_entry(e) for e in s.parts)
            for s in flatten(tree)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axes_follow_the_reference(mesh):
    r = RAxes.for_mesh(_ref_mesh(mesh))
    t = TAxes.for_mesh(_port_mesh(mesh))
    assert (t.dp, t.fsdp, t.tp, t.dp_size, t.tp_size) == \
        (r.dp, r.fsdp, r.tp, r.dp_size, r.tp_size)
    assert t == TAxes(*(r.dp, r.fsdp, r.tp, r.dp_size, r.tp_size))


def _global_params(arch_id):
    """The reference's parameter shapes (``eval_shape``) and the port's
    meta parameters of ``arch_id``'s configuration."""
    import torch

    r_arch, t_arch = R_ARCHS[arch_id], T_ARCHS[arch_id]
    gen = torch.Generator().manual_seed(0)
    if r_arch.family == "lm":
        rp = jax.eval_shape(lambda k: r_tfm.init(k, r_arch.config),
                            jax.random.PRNGKey(0))
        tp = t_tfm.init(gen, t_arch.config, device="meta")
    elif r_arch.family == "recsys":
        rp = jax.eval_shape(lambda k: r_wd.init(k, r_arch.config),
                            jax.random.PRNGKey(0))
        tp = t_wd.init(gen, t_arch.config, device="meta")
    else:
        return None, None
    return rp, tp


LM_OR_RECSYS = [a for a, s in T_ARCHS.items() if s.family in ("lm",
                                                               "recsys")]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", LM_OR_RECSYS)
def test_param_and_state_specs_follow_the_reference(arch_id, mesh):
    r_axes = RAxes.for_mesh(_ref_mesh(mesh))
    t_axes = TAxes.for_mesh(_port_mesh(mesh))
    r_arch, t_arch = R_ARCHS[arch_id], T_ARCHS[arch_id]
    if r_arch.family == "lm":
        rs = r_tfm.param_specs(r_arch.config, r_axes)
        ts = t_tfm.param_specs(t_arch.config, t_axes)
        assert _port_specs(t_tfm.cache_specs(t_arch.config, t_axes)) == \
            _ref_specs(r_tfm.cache_specs(r_arch.config, r_axes))
    else:
        rs = r_wd.param_specs(r_arch.config, r_axes)
        ts = t_wd.param_specs(t_arch.config, t_axes)
    assert _port_specs(ts) == _ref_specs(rs)
    rp, tp = _global_params(arch_id)
    for mode in MODES:
        assert _port_specs(t_state_specs(ts, tp, TAdamW(state_mode=mode))) \
            == _ref_specs(r_state_specs(rs, rp, RAdamW(state_mode=mode))), \
            mode


@pytest.mark.parametrize("arch_id", [a for a, s in T_ARCHS.items()
                                     if s.family in ("gnn", "nequip")])
def test_gnn_param_specs_replicate(arch_id):
    """``gnn.models.param_specs``: every leaf ``P()``, as the reference."""
    import torch

    from repro.models.gnn import nequip as r_nq
    from repro_torch.models.gnn import nequip as t_nq

    r_arch, t_arch = R_ARCHS[arch_id], T_ARCHS[arch_id]
    gen = torch.Generator().manual_seed(0)
    if t_arch.family == "nequip":
        rp = jax.eval_shape(lambda k: r_nq.init(k, r_arch.config),
                            jax.random.PRNGKey(0))
        tp = t_nq.init(gen, t_arch.config, device="meta")
    else:
        rp = jax.eval_shape(
            lambda k: r_gnn.INITS[r_arch.config.arch](k, r_arch.config),
            jax.random.PRNGKey(0))
        tp = t_gnn.INITS[t_arch.config.arch](gen, t_arch.config,
                                             device="meta")
    got = _port_specs(t_gnn.param_specs(tp, None))
    assert got == _ref_specs(r_gnn.param_specs(rp, None))
    assert got == [()] * len(got)


ALL_CELLS = [(a, s.name) for a, arch in T_ARCHS.items()
             for s in arch.shapes]


@pytest.fixture
def ref_cells(monkeypatch):
    """The reference's cell builder with ``_ns`` handing back specs."""
    monkeypatch.setattr(RC, "_ns",
                        lambda mesh, tree: None if mesh is None else tree)
    return RC.build_cell


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id,shape", ALL_CELLS,
                         ids=[f"{a}-{s}" for a, s in ALL_CELLS])
def test_cell_shardings_follow_the_reference(ref_cells, arch_id, shape,
                                             mesh):
    r = ref_cells(arch_id, shape, _ref_mesh(mesh))
    t = build_cell(arch_id, shape, _port_mesh(mesh))
    assert _port_specs(t.in_shardings) == _ref_specs(r.in_shardings)
    assert _port_specs(t.out_shardings) == _ref_specs(r.out_shardings)
