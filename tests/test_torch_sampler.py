"""The port's neighbour sampler against the reference's, and minibatch
inference on a sampled subgraph.

``CSRGraph``, ``sample_subgraph`` and ``subgraph_shapes`` are the
reference's numpy code: for the same ``np.random.default_rng`` seed the
arrays must be bit-equal, on a power-law graph with hubs, with nodes
that have no in-neighbour and fanouts past some degrees.  The slice as
a whole: the same sampled subgraph (its nodes' features, padding rows
zero) through the reference's GAT and PNA forwards and the port's, the
logits within float32 rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gat_cora as ref_gat_cfg
from repro.configs import pna as ref_pna_cfg
from repro.models.gnn import models as RMod
from repro.models.gnn import sampler as RS

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import gat_cora as port_gat_cfg
from repro_torch.configs import pna as port_pna_cfg
from repro_torch.data import graphs as TG
from repro_torch.models.gnn import models as TMod
from repro_torch.models.gnn import sampler as TS


def _graph(n=500, avg_degree=6, seed=4):
    g = TG.synth_products_like(n_nodes=n, avg_degree=avg_degree, d_feat=8,
                               n_classes=3, seed=seed)
    return n, g


@pytest.mark.parametrize("batch,fanouts", [(16, (5, 3)), (64, (15, 10)),
                                           (8, (40,)), (32, (2, 2, 2))])
def test_sampler_is_bit_equal(batch, fanouts):
    n, g = _graph()
    ref_csr = RS.CSRGraph(n, g["edge_src"], g["edge_dst"])
    csr = TS.CSRGraph(n, g["edge_src"], g["edge_dst"])
    assert np.array_equal(csr.indptr, ref_csr.indptr)
    assert np.array_equal(csr.dst_sorted_src, ref_csr.dst_sorted_src)
    assert (csr.indptr[1:] == csr.indptr[:-1]).any()    # nodes without
    seeds = np.random.default_rng(9).choice(n, batch, replace=False)
    want = RS.sample_subgraph(ref_csr, seeds, fanouts,
                              np.random.default_rng(1))
    got = TS.sample_subgraph(csr, seeds, fanouts, np.random.default_rng(1))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), k
        assert np.asarray(want[k]).dtype == np.asarray(got[k]).dtype
    assert TS.subgraph_shapes(batch, fanouts) == \
        RS.subgraph_shapes(batch, fanouts)
    assert (got["edge_src"] >= 0).sum() > 0


def test_minibatch_lg_shapes():
    """``minibatch_lg``'s sampling: 1,024 seeds, fanout (15, 10)."""
    assert TS.subgraph_shapes(1024, (15, 10)) == (169_984, 168_960) == \
        RS.subgraph_shapes(1024, (15, 10))


@pytest.mark.parametrize("arch", ["gat", "pna"])
def test_minibatch_inference_matches_reference(arch):
    """Sample with both packages, then run each package's forward over
    the subgraph's own features (padding rows 0); the seeds' logits
    agree."""
    n = 400
    rcfg = (ref_gat_cfg if arch == "gat" else ref_pna_cfg).smoke_config()
    pcfg = (port_gat_cfg if arch == "gat" else port_pna_cfg).smoke_config()
    g = TG.synth_products_like(n_nodes=n, avg_degree=5, d_feat=rcfg.d_in,
                               n_classes=rcfg.n_classes, seed=2)
    seeds = np.random.default_rng(3).choice(n, 12, replace=False)
    sub = TS.sample_subgraph(TS.CSRGraph(n, g["edge_src"], g["edge_dst"]),
                             seeds, (4, 3), np.random.default_rng(5))
    ref_sub = RS.sample_subgraph(
        RS.CSRGraph(n, g["edge_src"], g["edge_dst"]), seeds, (4, 3),
        np.random.default_rng(5))
    assert all(np.array_equal(sub[k], ref_sub[k]) for k in sub)
    x = np.where((sub["nodes"] >= 0)[:, None],
                 g["x"][np.maximum(sub["nodes"], 0)], 0).astype(np.float32)
    sg = {"x": x, "edge_src": sub["edge_src"], "edge_dst": sub["edge_dst"]}
    params = RMod.INITS[arch](jax.random.PRNGKey(1), rcfg)
    want = np.asarray(RMod.FORWARDS[arch](
        params, {k: jnp.asarray(v) for k, v in sg.items()}, rcfg))
    model = (TMod.GAT if arch == "gat" else TMod.PNA)(
        pcfg, device="cpu", params=TMod.params_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu"))
    with torch.no_grad():
        got = model(TG.graph_to_device(sg, device="cpu")).numpy()
    assert got.shape == (len(sub["nodes"]), rcfg.n_classes)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
