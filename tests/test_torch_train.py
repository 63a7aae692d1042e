"""The port's train steps (``repro_torch.launch.cells``) against the
reference's ``make_gnn_train_step`` / ``make_recsys_train_step``.

The reference's initial parameters carry across with
``params_from_numpy``; both packages take one step on the same numpy
batch (GNN: AdamW fp32, as the reference's GNN cells; Wide&Deep:
factored, as its recsys cell), on the CPU, where the port's segment
sums and embedding_bag are their plain versions.  GIN, GAT and PNA at
their smoke configs node-level, with a ``label_mask`` and with
``graph_ids`` (GIN pools in its forward, GAT and PNA in the loss); GAT
also at the full gat-cora width on ``synth_cora_like``; NequIP at its
smoke config on ``mse_loss`` against target energies; Wide&Deep at its
smoke config, whose ``tables`` leaf is stacked (updated field by
field).

Tolerances, derived:
* loss and ``grad_norm``: rtol 1e-5 (float32 sums in another order).
* The gradient, read from the first moment (after one step from zero,
  ``m = (1 - b1) * clip(g)``): per leaf within 1e-4 of the leaf's
  largest entry (float32 sums over edges and rows in another order;
  PNA's std amplifies them, as in ``test_torch_gat_pna.py``).
* The second moment: the same from ``v`` (or ``vr``/``vc``).
* The parameters: Adam's step ``(m / c1) / (sqrt(v / c2) + eps)`` maps a
  gradient difference that is large against ``|g|`` (an entry whose
  gradient is within float noise of 0) to up to 2 lr.  So each side's
  step is recomputed (float64) from its own moments, and each parameter
  must lie within ``lr * |step_port - step_ref|`` of the reference's,
  plus 16 float32 ulps of the update's operands (``p0`` and ``lr *
  step``): about 7 roundings a side (the step's five, the decay, the
  product with lr and the difference).
* ``remat=True`` gives the same two steps as ``remat=False``, bit for
  bit (the same operations recomputed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gat_cora as ref_gat_cfg
from repro.configs import gin_tu as ref_gin_cfg
from repro.configs import nequip as ref_nq_cfg
from repro.configs import pna as ref_pna_cfg
from repro.configs import wide_deep as ref_wd_cfg
from repro.launch import cells as RC
from repro.models.gnn import models as RMod
from repro.models.gnn import nequip as RNQ
from repro.models.recsys import wide_deep as RWD
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as ref_adamw_init

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import gat_cora as port_gat_cfg
from repro_torch.configs import gin_tu as port_gin_cfg
from repro_torch.configs import nequip as port_nq_cfg
from repro_torch.configs import pna as port_pna_cfg
from repro_torch.configs import wide_deep as port_wd_cfg
from repro_torch.data import graphs as TG
from repro_torch.data.recsys import batch_to_device, recsys_batch
from repro_torch.launch.cells import make_gnn_train_step, \
    make_recsys_train_step
from repro_torch.models.common import params_from_numpy
from repro_torch.models.gnn import models as TMod
from repro_torch.models.gnn import nequip as TNQ
from repro_torch.models.recsys import wide_deep as TWD
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.tree import flatten
from test_torch_gat_pna import rand_graph
from test_torch_nequip import molecules

CPU = "cpu"
LR = 1e-3
CFGS = {"gin": (ref_gin_cfg, port_gin_cfg), "gat": (ref_gat_cfg, port_gat_cfg),
        "pna": (ref_pna_cfg, port_pna_cfg)}
CLASSES = {"gin": TMod.GIN, "gat": TMod.GAT, "pna": TMod.PNA}


def _gnn_graph(arch, variant, rcfg, rng):
    """A numpy graph with labels, and a ``label_mask`` or ``graph_ids``
    (4 graphs, the last nodes padding) by ``variant``."""
    if variant == "cora":
        g = TG.synth_cora_like(seed=5)
        g = {k: g[k] for k in ("x", "edge_src", "edge_dst", "labels")}
    else:
        g = rand_graph(rng, f=rcfg.d_in)
        g["labels"] = rng.integers(0, rcfg.n_classes,
                                   g["x"].shape[0]).astype(np.int32)
    n = g["x"].shape[0]
    if variant == "mask":
        g["label_mask"] = rng.random(n) < 0.6
    if variant == "graphs":
        gid = np.sort(rng.integers(0, 4, n)).astype(np.int32)
        gid[-2:] = -1
        g["graph_ids"], g["n_graphs"] = gid, 4
        g["graph_labels"] = rng.integers(0, rcfg.n_classes,
                                         4).astype(np.int32)
    return g


def _to_jax(g):
    return {k: (v if k == "n_graphs" else jnp.asarray(v))
            for k, v in g.items()}


def _to_torch(g):
    return {k: (v if k == "n_graphs" else torch.as_tensor(v))
            for k, v in g.items()}


def _adam_steps(leaves, count, cfg):
    """Each leaf's Adam step ``(m / c1) / (sqrt(v / c2) + eps)`` in float64
    from its state dict (numpy), before clipping's scale is undone."""
    c1, c2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
    out = []
    for st in leaves:
        m = np.asarray(st["m"], np.float64)
        if "vr" in st:
            vr = np.asarray(st["vr"], np.float64)
            vc = np.asarray(st["vc"], np.float64)
            den = np.maximum(vr.mean(-1, keepdims=True), 1e-30)
            v = vr[..., :, None] * vc[..., None, :] / den[..., None]
        else:
            v = np.asarray(st["v"], np.float64)
        out.append((m / c1) / (np.sqrt(v / c2) + cfg.eps))
    return out


def _state_leaves(tree, structure):
    """The per-parameter state dicts in flatten order, as numpy."""
    from repro_torch.optim.tree import flatten_up_to
    return [{k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                           else v) for k, v in st.items()}
            for st in flatten_up_to(structure, tree)]


def _check_step(ref, port, cfg, where):
    """``ref``/``port``: (params tree, opt state, loss, grad_norm) after one
    step from the same parameters and a zero state."""
    rp, rs, rl, rg = ref
    tp, ts, tl, tg = port
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5,
                               err_msg=f"{where} loss")
    np.testing.assert_allclose(float(tg), float(rg), rtol=1e-5,
                               err_msg=f"{where} grad_norm")
    r_leaves = [np.asarray(x) for x in jax.tree.leaves(rp)]
    t_leaves = [x.detach().numpy() for x in flatten(tp)]
    assert [x.shape for x in r_leaves] == [x.shape for x in t_leaves]
    structure = jax.tree.map(lambda x: 0, rp)
    r_st = _state_leaves(jax.tree.map(np.asarray, rs["leaves"]), structure)
    t_st = _state_leaves(ts["leaves"], tp)
    for i, (a, b) in enumerate(zip(t_st, r_st)):
        for k in b:
            scale = float(np.abs(b[k]).max())
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=1e-4 * scale + 1e-30,
                                       err_msg=f"{where} leaf {i} {k}")
    t_steps = _adam_steps(t_st, 1, cfg)
    r_steps = _adam_steps(r_st, 1, cfg)
    for i, (a, b, sa, sb) in enumerate(zip(t_leaves, r_leaves, t_steps,
                                           r_steps)):
        # 16 ulps of the update's operands, p0 and lr * step (a step can
        # cancel most of p0): about 7 roundings a side
        tol = LR * np.abs(sa - sb) \
            + 16 * 2.0 ** -24 * (np.abs(b) + LR * (np.abs(sb) + 1))
        assert (np.abs(a.astype(np.float64) - b) <= tol).all(), \
            f"{where} parameter leaf {i}: {np.abs(a - b).max()}"


def _gnn_case(arch, variant):
    rmod, pmod = CFGS[arch]
    if variant == "cora":
        rcfg, pcfg = rmod.CONFIG, pmod.CONFIG
    else:
        rcfg, pcfg = rmod.smoke_config(), pmod.smoke_config()
    rng = np.random.default_rng(7)
    g = _gnn_graph(arch, variant, rcfg, rng)
    params = RMod.INITS[arch](jax.random.PRNGKey(1), rcfg)
    return rcfg, pcfg, g, params


@pytest.mark.parametrize("arch,variant", [
    ("gin", "nodes"), ("gin", "mask"), ("gin", "graphs"),
    ("gat", "nodes"), ("gat", "mask"), ("gat", "graphs"), ("gat", "cora"),
    ("pna", "nodes"), ("pna", "mask"), ("pna", "graphs")])
def test_gnn_train_step_matches_reference(arch, variant):
    rcfg, pcfg, g, params = _gnn_case(arch, variant)
    rocfg, ocfg = RAdamWConfig(state_mode="fp32"), AdamWConfig(
        state_mode="fp32")
    jg = _to_jax(g)
    rstep = RC.make_gnn_train_step(rcfg, RMod.node_classification_loss,
                                   rocfg, LR)
    ref = jax.jit(lambda p, s: rstep(p, s, jg))(
        params, ref_adamw_init(params, rocfg))
    model = CLASSES[arch](pcfg, device=CPU, params=params_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))
    step = make_gnn_train_step(pcfg, TMod.node_classification_loss, ocfg, LR)
    opt = adamw_init(model.params(), ocfg)
    out_model, opt, loss, gnorm = step(model, opt, _to_torch(g))
    assert out_model is model
    _check_step(ref, (model.params(), opt, loss, gnorm), ocfg,
                f"{arch} {variant}")


def test_node_classification_loss_matches_reference():
    """The loss alone, each variant (GIN's pooled forward, GAT's and
    PNA's mean-pooled logits, masks)."""
    for arch in ("gin", "gat", "pna"):
        for variant in ("nodes", "mask", "graphs"):
            rcfg, pcfg, g, params = _gnn_case(arch, variant)
            want, aux = RMod.node_classification_loss(params, _to_jax(g),
                                                      rcfg)
            model = CLASSES[arch](pcfg, device=CPU, params=params_from_numpy(
                jax.tree.map(np.asarray, params), device=CPU))
            with torch.no_grad():
                got, taux = TMod.node_classification_loss(model, _to_torch(g))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       err_msg=f"{arch} {variant}")
            assert set(taux) == set(aux) == {"ce"}


def _nequip_case(remat=False):
    rcfg = dataclasses.replace(ref_nq_cfg.smoke_config(), remat=remat)
    pcfg = dataclasses.replace(port_nq_cfg.smoke_config(), remat=remat)
    rng = np.random.default_rng(9)
    g = molecules(rng)
    g["energy"] = rng.standard_normal(g["n_graphs"]).astype(np.float32)
    params = RNQ.init(jax.random.PRNGKey(2), rcfg)
    return rcfg, pcfg, g, params


def _nequip_loss(model, g):
    return TNQ.mse_loss(model.params(), g, model.cfg)


def test_nequip_train_step_matches_reference():
    rcfg, pcfg, g, params = _nequip_case()
    rocfg, ocfg = RAdamWConfig(state_mode="fp32"), AdamWConfig(
        state_mode="fp32")
    jg = _to_jax(g)
    ng = g["n_graphs"]

    def loss(p, graph, c):          # n_graphs static, as the reference cell
        return RNQ.mse_loss(p, {**graph, "n_graphs": ng}, c)

    rstep = RC.make_gnn_train_step(rcfg, loss, rocfg, LR)
    ref = jax.jit(lambda p, s: rstep(
        p, s, {k: v for k, v in jg.items() if k != "n_graphs"}))(
        params, ref_adamw_init(params, rocfg))
    model = TNQ.NequIP(pcfg, device=CPU, params=params_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))
    step = make_gnn_train_step(pcfg, _nequip_loss, ocfg, LR)
    opt = adamw_init(model.params(), ocfg)
    _, opt, loss_v, gnorm = step(model, opt, _to_torch(g))
    _check_step(ref, (model.params(), opt, loss_v, gnorm), ocfg, "nequip")
    # mse_loss alone, and without targets (zeros)
    want, _ = RNQ.mse_loss(params, {**jg, "energy": jnp.zeros(ng)}, rcfg)
    g0 = {k: v for k, v in _to_torch(g).items() if k != "energy"}
    fresh = TNQ.NequIP(pcfg, device=CPU, params=params_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))
    with torch.no_grad():
        got, aux = TNQ.mse_loss(fresh.params(), g0, fresh.cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(aux) == {"mse"}


def test_recsys_train_step_matches_reference():
    rcfg, pcfg = ref_wd_cfg.smoke_config(), port_wd_cfg.smoke_config()
    params = RWD.init(jax.random.PRNGKey(3), rcfg)
    batch = recsys_batch(0, 32, pcfg.n_sparse, pcfg.vocab_per_field,
                         pcfg.n_dense, pcfg.n_wide_crosses, seed=4)
    rocfg = RAdamWConfig(state_mode="factored")
    ocfg = AdamWConfig(state_mode="factored")
    rstep = RC.make_recsys_train_step(rcfg, rocfg, LR)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax.jit(lambda p, s: rstep(p, s, jb))(
        params, ref_adamw_init(params, rocfg))
    model = TWD.WideDeep(pcfg, device=CPU, params=params_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))
    opt = adamw_init(model.params(), ocfg)
    assert "vr" in opt["leaves"]["tables"] \
        and opt["leaves"]["tables"]["vr"].shape == (6, 100)
    step = make_recsys_train_step(pcfg, ocfg, LR)
    _, opt, loss, gnorm = step(model, opt, batch_to_device(batch,
                                                           device=CPU))
    _check_step(ref, (model.params(), opt, loss, gnorm), ocfg, "wide_deep")


def test_module_params_have_the_reference_layout():
    """``params()`` of every module is the reference's tree: the same
    leaves in ``jax.tree`` order, the module's own tensors."""
    for arch in ("gin", "gat", "pna"):
        rcfg, pcfg, _, params = _gnn_case(arch, "nodes")
        model = CLASSES[arch](pcfg, device=CPU, params=params_from_numpy(
            jax.tree.map(np.asarray, params), device=CPU))
        got = flatten(model.params())
        want = jax.tree.leaves(params)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a.detach().numpy(), np.asarray(b))
        assert {id(p) for p in got} == {id(p) for p in model.parameters()}
    rcfg = ref_wd_cfg.smoke_config()
    params = RWD.init(jax.random.PRNGKey(3), rcfg)
    model = TWD.WideDeep(port_wd_cfg.smoke_config(), device=CPU,
                         params=params_from_numpy(
                             jax.tree.map(np.asarray, params), device=CPU))
    for a, b in zip(flatten(model.params()), jax.tree.leaves(params)):
        assert np.array_equal(a.detach().numpy(), np.asarray(b))
    assert len(flatten(model.params())) == len(list(model.parameters()))


def _two_steps(make_model, loss, g, ocfg):
    model = make_model()
    step = make_gnn_train_step(model.cfg, loss, ocfg, LR)
    opt = adamw_init(model.params(), ocfg)
    losses = []
    for _ in range(2):
        _, opt, l, _ = step(model, opt, g)
        losses.append(float(l))
    return [p.detach().clone() for p in flatten(model.params())], losses


@pytest.mark.parametrize("arch", ["gin", "gat", "pna", "nequip"])
def test_remat_gives_the_same_steps(arch):
    ocfg = AdamWConfig(state_mode="fp32")
    if arch == "nequip":
        _, pcfg, g, params = _nequip_case()
        cls, loss = TNQ.NequIP, _nequip_loss
    else:
        _, pcfg, g, params = _gnn_case(arch, "graphs")
        cls, loss = CLASSES[arch], TMod.node_classification_loss
    tree = jax.tree.map(np.asarray, params)
    g = _to_torch(g)
    runs = [_two_steps(lambda: cls(dataclasses.replace(pcfg, remat=r),
                                   device=CPU,
                                   params=params_from_numpy(tree,
                                                            device=CPU)),
                       loss, g, ocfg) for r in (False, True)]
    (p0, l0), (p1, l1) = runs
    assert l0 == l1
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def _bags(rng, n_bags=40, max_bag=6, v=30):
    sizes = rng.integers(0, max_bag + 1, n_bags)
    bags = np.repeat(np.arange(n_bags, dtype=np.int32), sizes)
    ids = rng.integers(-1, v, bags.size).astype(np.int32)   # -1: padding
    return torch.as_tensor(ids), torch.as_tensor(bags), n_bags


def test_embedding_bag_function_gradcheck_and_plain_gradient(monkeypatch):
    """``EmbeddingBag`` (the Function the kernel's launch sits in on the
    card) driven by the plain forward: ``gradcheck`` in float64, and in
    float32 its gradient equals the plain version's own (``index_put_``'s
    float32 accumulation in autograd) within the summation bound
    ``(k + 1) 2^-24 sum|terms|`` of a row's k terms (the backward's plain
    segment sum adds them in float64).  The backward is one
    ``segment_sum`` over the table's rows."""
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.segment_reduce import ops as sr

    rng = np.random.default_rng(12)
    ids, bags, n_bags = _bags(rng)
    for d in (1, 5):
        table = torch.randn((30, d), dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda t: eb.EmbeddingBag.apply(ids, bags, t, n_bags,
                                            eb_ref.embedding_bag),
            (table,))
    calls = []
    real = sr.segment_sum

    def counted(dst, msg, n_nodes, backend=None):
        calls.append((tuple(msg.shape), n_nodes))
        return real(dst, msg, n_nodes, backend)

    monkeypatch.setattr(sr, "segment_sum", counted)
    table = torch.randn((30, 4), requires_grad=True)
    w = torch.randn((n_bags, 4))
    out = eb.EmbeddingBag.apply(ids, bags, table, n_bags,
                                eb_ref.embedding_bag)
    (got,) = torch.autograd.grad((out * w).sum(), table)
    assert calls == [((ids.shape[0], 4), 30)]
    table2 = table.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        (eb_ref.embedding_bag(ids, bags, table2, n_bags) * w).sum(), table2)
    ok = ids >= 0
    k = torch.zeros(30).index_add_(0, ids[ok].long(),
                                   torch.ones(int(ok.sum())))
    terms = torch.zeros((30, 4)).index_add_(0, ids[ok].long(),
                                            w.abs()[bags[ok].long()])
    bound = (k[:, None] + 1) * 2.0 ** -24 * terms
    assert ((got - want).abs() <= bound).all()
    # on CPU tensors the public wrapper is the plain version, which is
    # differentiable by itself (the kernel's Function is for the card)
    (plain,) = torch.autograd.grad(
        (eb.embedding_bag(ids, bags, table2, n_bags) * w).sum(), table2)
    assert torch.equal(plain, want)
