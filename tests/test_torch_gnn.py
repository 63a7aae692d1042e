"""The port's GIN inference path against the reference's.

The graph generators must give the reference's arrays bit for bit.  The
reference's GIN parameters (``gin_init`` of the smoke config) carry
across with ``params_from_numpy``; the port's forward (its segment_sum
on the CPU is the plain version) is held to ``gin_forward`` with the
Pallas kernel in interpret mode, node-level and pooled per graph,
float32 rtol 1e-4 / atol 1e-4.  ``gather_scatter`` is held to the
reference for all four reductions, with padding edges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as ref_cfg
from repro.data import graphs as RG
from repro.models.gnn import message as RM
from repro.models.gnn import models as RMod

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import gin_tu as port_cfg
from repro_torch.data import graphs as TG
from repro_torch.models.gnn import message as TM
from repro_torch.models.gnn import models as TMod

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which,kw", [
    ("cora", dict(n_nodes=200, n_edges=600, d_feat=50, n_classes=4,
                  seed=1)),
    ("products", dict(n_nodes=500, avg_degree=5, d_feat=16, n_classes=5,
                      seed=2)),
])
def test_graph_generators_are_bit_equal(which, kw):
    name = "synth_cora_like" if which == "cora" else "synth_products_like"
    want = getattr(RG, name)(**kw)
    got = getattr(TG, name)(**kw)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert np.array_equal(want[k], got[k]), k


def _graph(pooled: bool):
    cfg = port_cfg.smoke_config()
    g = TG.synth_products_like(n_nodes=300, avg_degree=4, d_feat=cfg.d_in,
                               n_classes=cfg.n_classes, seed=3)
    g = {k: g[k] for k in ("x", "edge_src", "edge_dst")}
    rng = np.random.default_rng(0)
    pad = rng.random(g["edge_src"].shape) < 0.05          # padding edges
    g["edge_src"] = np.where(pad, -1, g["edge_src"]).astype(np.int32)
    if pooled:
        gid = rng.integers(0, 5, 300).astype(np.int32)
        gid[rng.random(300) < 0.1] = -1
        g["graph_ids"], g["n_graphs"] = gid, 5
    return g


@pytest.mark.parametrize("pooled", [False, True], ids=["nodes", "graphs"])
def test_gin_forward_matches_reference(pooled):
    rcfg = dataclasses.replace(ref_cfg.smoke_config(),
                               backend="pallas_interpret")
    params = RMod.gin_init(jax.random.PRNGKey(0), rcfg)
    g = _graph(pooled)
    jg = {k: v if isinstance(v, int) else jnp.asarray(v)
          for k, v in g.items()}
    want = np.asarray(RMod.gin_forward(params, jg, rcfg))
    model = TMod.GIN(port_cfg.smoke_config(), device="cpu",
                     params=TMod.params_from_numpy(
                         jax.tree.map(np.asarray, params), device="cpu"))
    with torch.no_grad():
        got = model(TG.graph_to_device(g, device="cpu"))
    assert got.shape == want.shape == ((5 if pooled else 300), 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gin_config_matches_reference():
    for c_ref, c_port in ((ref_cfg.CONFIG, port_cfg.CONFIG),
                          (ref_cfg.smoke_config(), port_cfg.smoke_config())):
        for name in ("arch", "n_layers", "d_in", "d_hidden", "n_classes",
                     "eps_learnable"):
            assert getattr(c_ref, name) == getattr(c_port, name)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_gather_scatter_matches_reference(reduce):
    rng = np.random.default_rng(7)
    n, e, d = 40, 300, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 5, e).astype(np.int32)   # nodes with no edge
    src[rng.random(e) < 0.05] = -1
    dst[rng.random(e) < 0.05] = -1
    backend = "pallas_interpret" if reduce in ("sum", "mean") else "xla"
    want = np.asarray(RM.gather_scatter(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n,
        reduce=reduce, backend=backend))
    got = TM.gather_scatter(torch.as_tensor(x), torch.as_tensor(src),
                            torch.as_tensor(dst), n, reduce=reduce)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_segment_softmax_and_degrees_match_reference():
    rng = np.random.default_rng(8)
    e, n = 200, 30
    scores = rng.standard_normal((e, 3)).astype(np.float32)
    seg = rng.integers(0, n - 4, e).astype(np.int32)
    seg[rng.random(e) < 0.1] = -1
    want = np.asarray(RM.segment_softmax(jnp.asarray(scores),
                                         jnp.asarray(seg), n))
    got = TM.segment_softmax(torch.as_tensor(scores), torch.as_tensor(seg), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        TM.degrees(torch.as_tensor(seg), n).numpy(),
        np.asarray(RM.degrees(jnp.asarray(seg), n)))
