"""The port's NequIP against the reference's: forward (per-graph energy
and total), energy and forces, the config and the parameter layout; and
the port's own symmetries.

The reference's parameters (``nequip.init``) carry across with
``params_from_numpy``; molecules are made with numpy (atoms in a 6 A box,
directed edges drawn among the pairs within the cutoff) and handed to
both packages.  Float32 on both sides, summed in other orders: energy
rtol 1e-5 / atol 1e-5 (relative to the largest |energy|), forces
rtol 1e-4 / atol 1e-5 (relative to the largest |force|): a force is a
difference of many per-edge terms from five layers' backward passes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import nequip as ref_cfg
from repro.models.gnn import nequip as RNQ

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import nequip as port_cfg
from repro_torch.kernels.segment_reduce import ops
from repro_torch.models.common import params_from_numpy
from repro_torch.models.gnn import nequip as TNQ


def molecules(rng, n_mol=3, n_atoms=10, n_edges=24, n_species=4,
              cutoff=5.0, box=6.0):
    """``n_mol`` molecules of ``n_atoms`` atoms and ``n_edges`` directed
    edges each, drawn without replacement among the ordered pairs of
    distinct atoms closer than ``cutoff``; nodes and edges of molecule m
    follow molecule m - 1's, ``graph_ids`` names each atom's molecule."""
    pos = rng.uniform(0, box, (n_mol, n_atoms, 3)).astype(np.float32)
    src, dst = [], []
    for m in range(n_mol):
        d = np.linalg.norm(pos[m][:, None] - pos[m][None], axis=-1)
        s, t = np.nonzero((d < cutoff) & ~np.eye(n_atoms, dtype=bool))
        take = rng.choice(len(s), n_edges, replace=False)
        src.append(s[take] + m * n_atoms)
        dst.append(t[take] + m * n_atoms)
    return {"species": rng.integers(0, n_species, n_mol * n_atoms)
            .astype(np.int32),
            "pos": pos.reshape(-1, 3),
            "edge_src": np.concatenate(src).astype(np.int32),
            "edge_dst": np.concatenate(dst).astype(np.int32),
            "graph_ids": np.repeat(np.arange(n_mol), n_atoms)
            .astype(np.int32),
            "n_graphs": n_mol}


def _case(size, pooled, seed=0):
    rcfg = ref_cfg.smoke_config() if size == "smoke" else ref_cfg.CONFIG
    pcfg = port_cfg.smoke_config() if size == "smoke" else port_cfg.CONFIG
    g = molecules(np.random.default_rng(seed + 7),
                  n_species=rcfg.n_species)
    g["edge_src"][:2] = -1                       # padding edges
    if not pooled:
        g = {k: v for k, v in g.items() if k not in ("graph_ids",
                                                     "n_graphs")}
    params = RNQ.init(jax.random.PRNGKey(seed), rcfg)
    model = TNQ.NequIP(pcfg, device="cpu", params=params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    return rcfg, params, model, g


def _jax(g):
    return {k: v if isinstance(v, int) else jnp.asarray(v)
            for k, v in g.items()}


def _torch(g):
    return {k: v if isinstance(v, int) else torch.as_tensor(v)
            for k, v in g.items()}


def _close(got, want, rtol, atol):
    """|got - want| <= rtol |want| + atol max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * np.abs(want) + atol * scale + 1e-30)


CASES = [("smoke", True), ("smoke", False), ("full", True), ("full", False)]
IDS = [f"{s}-{'graphs' if p else 'total'}" for s, p in CASES]


@pytest.mark.parametrize("size,pooled", CASES, ids=IDS)
def test_forward_matches_reference(size, pooled):
    rcfg, params, model, g = _case(size, pooled)
    want = np.asarray(RNQ.forward(params, _jax(g), rcfg))
    with torch.no_grad():
        got = model(_torch(g))
        fn = TNQ.forward(model.params(), _torch(g), model.cfg)
    assert got.shape == want.shape == ((3,) if pooled else (1,))
    assert torch.equal(got, fn)
    _close(got.numpy(), want, 1e-5, 1e-5)


@pytest.mark.parametrize("size,pooled", CASES, ids=IDS)
def test_energy_and_forces_match_reference(size, pooled):
    rcfg, params, model, g = _case(size, pooled)
    e_want, f_want = RNQ.energy_and_forces(params, _jax(g), rcfg)
    e_got, f_got = model.energy_and_forces(_torch(g))
    assert e_got.shape == () and f_got.shape == g["pos"].shape
    assert not e_got.requires_grad and not f_got.requires_grad
    _close(e_got.numpy(), np.asarray(e_want), 1e-5, 1e-5)
    _close(f_got.numpy(), np.asarray(f_want), 1e-4, 1e-5)
    assert np.abs(np.asarray(f_want)).max() > 1e-3      # not vacuous


def _rotation(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.as_tensor(q.astype(np.float32))


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_port_is_rotation_and_translation_invariant(size):
    """Energy unchanged and forces rotated with the positions under a
    random rotation (``test_gnn.py``'s check and tolerances); energy
    unchanged under a translation."""
    _, _, model, g = _case(size, True)
    g = _torch(g)
    rot = _rotation(np.random.default_rng(3))
    e1, f1 = model.energy_and_forces(g)
    e2, f2 = model.energy_and_forces({**g, "pos": g["pos"] @ rot.T})
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4)
    np.testing.assert_allclose((f1 @ rot.T).numpy(), f2.numpy(), rtol=2e-3,
                               atol=2e-4)
    with torch.no_grad():
        shift = torch.tensor([1.7, -0.3, 2.2])
        np.testing.assert_allclose(
            model(g).numpy(), model({**g, "pos": g["pos"] + shift}).numpy(),
            rtol=1e-5, atol=1e-6)


def test_segment_sums_per_layer(monkeypatch):
    """Each layer sums its three aggregations through ``sr.segment_sum``
    (on the card, three kernel launches), flattened to [E, C], [E, 3C]
    and [E, 9C]; the energy pooling does not."""
    _, _, model, g = _case("smoke", True)
    calls = []
    real = ops.segment_sum

    def counted(dst, msg, n_nodes, backend=None):
        calls.append(msg.shape[1])
        return real(dst, msg, n_nodes, backend)

    monkeypatch.setattr(ops, "segment_sum", counted)
    model.energy_and_forces(_torch(g))
    c = model.cfg.channels
    assert calls == [c, 3 * c, 9 * c] * model.cfg.n_layers


def test_config_matches_reference_field_for_field():
    for rc, pc in ((ref_cfg.CONFIG, port_cfg.CONFIG),
                   (ref_cfg.smoke_config(), port_cfg.smoke_config())):
        for f in dataclasses.fields(pc):
            if f.name not in ("_", "backend", "mesh"):
                assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    a, b = ref_cfg.ARCH, port_cfg.ARCH
    assert (b.arch_id, b.family, b.source, b.notes) == \
        (a.arch_id, a.family, a.source, a.notes)
    assert [s.extra for s in b.shapes] == [s.extra for s in a.shapes]


def test_init_and_basis_match_reference():
    """``init`` gives the reference's tree layout; ``bessel_basis`` and
    the path list are the reference's."""
    cfg = port_cfg.CONFIG
    want = RNQ.init(jax.random.PRNGKey(0), ref_cfg.CONFIG)
    got = TNQ.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), want)
    assert TNQ.PATHS == RNQ.PATHS
    r = np.linspace(0.0, 6.0, 50).astype(np.float32)
    np.testing.assert_allclose(
        TNQ.bessel_basis(torch.as_tensor(r), 8, 5.0).numpy(),
        np.asarray(RNQ.bessel_basis(jnp.asarray(r), 8, 5.0)),
        rtol=1e-5, atol=1e-5)
