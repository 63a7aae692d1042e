"""The port's GAT and PNA inference against the reference's, and the
segment_sum kernel's gradient.

The reference's parameters (``gat_init``/``pna_init``) carry across with
``params_from_numpy``; the port's forwards (their segment sums on the
CPU are the plain version) are held to ``gat_forward``/``pna_forward``
in float32: at the smoke configs on ``test_gnn.py``'s padded random
graph (with nodes that have no in-edge), GAT at the full gat-cora width
on ``synth_cora_like`` and PNA at the full pna width on a small power-law
graph.  Tolerance rtol 1e-5 / atol 1e-5: both sides compute in float32,
and sums (the segment sums, the matmuls over up to 1,433 features, PNA's
std from sum and sum of squares) run in another order.  PNA at the full
width: rtol 1e-4 / atol 1e-4, because four layers, each divided by its
standard deviation and each taking std as sqrt(E[m^2] - E[m]^2) from
float32 sums, amplify those roundings: there the reference itself lies
2.5e-5 from a float64 run of the same forward (the port 1.3e-5).

``ops.SegmentSum``, the ``autograd.Function`` the kernel's launch sits
in on the card, is driven here by the plain forward: ``gradcheck`` in
float64, and its gradient equals the plain version's native one
(``index_add_``) in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gat_cora as ref_gat_cfg
from repro.configs import pna as ref_pna_cfg
from repro.models.gnn import models as RMod

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import gat_cora as port_gat_cfg
from repro_torch.configs import pna as port_pna_cfg
from repro_torch.data import graphs as TG
from repro_torch.kernels.segment_reduce import ops, ref
from repro_torch.models.gnn import models as TMod

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_PNA_FULL = dict(rtol=1e-4, atol=1e-4)
CFGS = {"gat": (ref_gat_cfg, port_gat_cfg), "pna": (ref_pna_cfg, port_pna_cfg)}


def rand_graph(rng, n=20, e=60, f=16, pad_e=8, isolated=4):
    """``test_gnn.py``'s padded random graph; the last ``isolated`` nodes
    get no in-edge, and some padding edges keep a valid dst (counted by
    ``degrees``, as in the reference)."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - isolated, e).astype(np.int32)
    src = np.concatenate([src, np.full(pad_e, -1, np.int32)])
    dst = np.concatenate([dst, rng.integers(-1, n, pad_e).astype(np.int32)])
    return {"x": rng.standard_normal((n, f)).astype(np.float32),
            "edge_src": src, "edge_dst": dst}


def _case(which):
    """(arch, reference config, port config, numpy graph)."""
    arch, size = which.split("_")
    rmod, pmod = CFGS[arch]
    rng = np.random.default_rng(11)
    if size == "smoke":
        rcfg, pcfg = rmod.smoke_config(), pmod.smoke_config()
        g = rand_graph(rng, f=rcfg.d_in)
    elif arch == "gat":               # the published Cora shape
        rcfg, pcfg = rmod.CONFIG, pmod.CONFIG
        g = TG.synth_cora_like(seed=5)
        g = {k: g[k] for k in ("x", "edge_src", "edge_dst")}
    else:
        rcfg, pcfg = rmod.CONFIG, pmod.CONFIG
        g = TG.synth_products_like(n_nodes=400, avg_degree=6,
                                   d_feat=rcfg.d_in, n_classes=rcfg.n_classes,
                                   seed=6)
        g = {k: g[k] for k in ("x", "edge_src", "edge_dst")}
        g["edge_src"][rng.random(g["edge_src"].shape) < 0.05] = -1
    return arch, rcfg, pcfg, g


def _port_model(arch, rcfg, pcfg, seed=0):
    params = RMod.INITS[arch](jax.random.PRNGKey(seed), rcfg)
    cls = TMod.GAT if arch == "gat" else TMod.PNA
    return params, cls(pcfg, device="cpu", params=TMod.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))


@pytest.mark.parametrize("which", ["gat_smoke", "pna_smoke", "gat_full",
                                   "pna_full"])
def test_forward_matches_reference(which):
    arch, rcfg, pcfg, g = _case(which)
    params, model = _port_model(arch, rcfg, pcfg)
    want = np.asarray(RMod.FORWARDS[arch](
        params, {k: jnp.asarray(v) for k, v in g.items()}, rcfg))
    with torch.no_grad():
        got = model(TG.graph_to_device(g, device="cpu"))
    n = g["x"].shape[0]
    assert got.shape == want.shape == (n, rcfg.n_classes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **(
        TOL_PNA_FULL if which == "pna_full" else TOL))


@pytest.mark.parametrize("arch,per_layer", [("gat", 1), ("pna", 2)])
def test_segment_sums_per_forward(arch, per_layer, monkeypatch):
    """Every segment sum of a forward goes through ``sr.segment_sum`` (on
    the card, one kernel launch each): GAT one a layer, PNA two (sum and
    sum of squares); max/min and the softmax do not."""
    _, rcfg, pcfg, g = _case(f"{arch}_smoke")
    _, model = _port_model(arch, rcfg, pcfg)
    calls = []
    real = ops.segment_sum

    def counted(dst, msg, n_nodes, backend=None):
        calls.append(msg.shape[1])
        return real(dst, msg, n_nodes, backend)

    monkeypatch.setattr(ops, "segment_sum", counted)
    with torch.no_grad():
        model(TG.graph_to_device(g, device="cpu"))
    assert len(calls) == per_layer * pcfg.n_layers
    if arch == "gat":
        assert calls == [pcfg.n_heads * pcfg.d_hidden,
                         pcfg.n_heads * pcfg.n_classes]
    else:
        assert set(calls) == {pcfg.d_hidden}


@pytest.mark.parametrize("arch", ["gat", "gin", "pna"])
def test_inits_have_the_reference_layout(arch):
    """``INITS[arch]`` gives the reference's tree: the same keys, list
    lengths and shapes (the numbers come from a torch generator)."""
    mod = {"gat": (ref_gat_cfg, port_gat_cfg), "pna": (ref_pna_cfg,
                                                       port_pna_cfg)}
    if arch == "gin":
        from repro.configs import gin_tu as rc
        from repro_torch.configs import gin_tu as pc
    else:
        rc, pc = mod[arch]
    want = RMod.INITS[arch](jax.random.PRNGKey(0), rc.CONFIG)
    got = TMod.INITS[arch](torch.Generator().manual_seed(0), pc.CONFIG,
                           device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), want)


@pytest.mark.parametrize("name", ["gat_cora", "pna"])
def test_configs_match_reference_field_for_field(name):
    rmod, pmod = CFGS["gat" if name == "gat_cora" else "pna"]
    for rc, pc in ((rmod.CONFIG, pmod.CONFIG),
                   (rmod.smoke_config(), pmod.smoke_config())):
        for f in dataclasses.fields(pc):
            if f.name in ("_", "backend", "mesh"):
                continue
            want, got = getattr(rc, f.name), getattr(pc, f.name)
            if f.name == "dtype":
                want, got = np.dtype(want).name, str(got).split(".")[-1]
            assert got == want, f.name
    assert (pmod.ARCH.arch_id, pmod.ARCH.family, pmod.ARCH.source) == \
        (rmod.ARCH.arch_id, rmod.ARCH.family, rmod.ARCH.source)
    assert [s.name for s in pmod.ARCH.shapes] == \
        [s.name for s in rmod.ARCH.shapes]
    assert [s.extra for s in pmod.ARCH.shapes] == \
        [s.extra for s in rmod.ARCH.shapes]


def _seg_inputs(dtype, e=40, n=9, d=3, seed=2):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-2, n + 2, e).astype(np.int32)   # some out of range
    dst[:5] = 4                                          # a repeated node
    msg = torch.tensor(rng.standard_normal((e, d)), dtype=dtype,
                       requires_grad=True)
    return torch.as_tensor(dst), msg, n


def test_segment_sum_function_gradcheck():
    """The Function's backward (the gather) against numerical
    differentiation of the plain forward, in float64."""
    dst, msg, n = _seg_inputs(torch.float64)
    assert torch.autograd.gradcheck(
        lambda m: ops.SegmentSum.apply(dst, m, n, ref.segment_sum), (msg,))


def test_segment_sum_function_gradient_equals_plain():
    """Through the Function and through ``index_add_`` (the plain
    version's own autograd) the gradient is the same, in float32, with
    ids outside [0, N) getting 0."""
    dst, msg, n = _seg_inputs(torch.float32)
    w = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (n, msg.shape[1])), dtype=torch.float32)
    out = ops.SegmentSum.apply(dst, msg, n, ref.segment_sum)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.segment_sum(dst, msg, n).detach()
                                  .numpy())
    (g_fn,) = torch.autograd.grad((out * w).sum(), msg)
    (g_plain,) = torch.autograd.grad((ref.segment_sum(dst, msg, n) * w)
                                     .sum(), msg)
    np.testing.assert_array_equal(g_fn.numpy(), g_plain.numpy())
    bad = ((dst < 0) | (dst >= n)).numpy()
    assert bad.any() and not g_fn.numpy()[bad].any()
