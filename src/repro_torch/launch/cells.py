"""Cell builders and train steps: the port of ``repro.launch.cells``.

A *cell* bundles what the dry run (``launch.dryrun``) and the drivers
need for one (architecture × input shape):

  fn            the step: a train step, ``transformer.prefill``, a decode
                step on ``transformer.serve_step``, ``wide_deep.forward``
                or ``wide_deep.retrieval_score``
  args          its arguments, tensors on ``device`` (the meta device by
                default: shapes and dtypes, no storage — the port's
                ``ShapeDtypeStruct``); a train step's first argument is
                the model, an ``nn.Module`` built from the module-level
                init with a seeded CPU generator
  donate        argument indices the reference donates (the step updates
                them in place here)
  meta          model-FLOPs terms for the roofline, the reference's
                integer arithmetic

The reference's ``in_shardings`` and ``out_shardings`` are JAX sharding
and are not ported: a cell is the one-card program.

A train step takes the model (which holds its parameters and config),
the optimiser state (``optim.adamw_init`` of ``model.params()``) and a
batch: it runs the forward and the backward (``torch.autograd.grad``, so
no ``.grad`` is left on the parameters), then ``adamw_update``, which
writes the new parameters into the module in place.  It returns
``(model, opt_state, loss, grad_norm)``.  ``lr`` is the builder's value,
captured by the step as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs.registry import ARCHS, ArchSpec, ShapeSpec, get_arch
from repro_torch.models import transformer as tfm
from repro_torch.models.common import matmul_flags
from repro_torch.models.gnn import models as gnn
from repro_torch.models.gnn import nequip as nq
from repro_torch.models.gnn.sampler import subgraph_shapes
from repro_torch.models.recsys import wide_deep as wd
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.tree import flatten, unflatten

I32 = torch.int32


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    # the reference's in_shardings / out_shardings sit here (JAX
    # sharding, not ported): the fields after them are keyword-only
    _: dataclasses.KW_ONLY
    donate: tuple
    meta: dict
    skip_reason: str | None = None


# ===================================================================== #
# Train steps
# ===================================================================== #
def _grads(loss: Callable, leaves: list):
    """``loss()`` -> (loss, aux): the detached loss and the gradient of
    every leaf (zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives it: NequIP's last gate)."""
    l, _ = loss()
    grads = torch.autograd.grad(l, leaves, allow_unused=True)
    return l.detach(), [torch.zeros_like(p) if g is None else g
                        for g, p in zip(grads, leaves)]


def _step(model, opt_state, loss, lr, ocfg: AdamWConfig):
    params = model.params()
    l, grads = _grads(loss, flatten(params))
    _, opt_state, st = adamw_update(unflatten(params, grads), opt_state,
                                    params, lr, ocfg)
    return model, opt_state, l, st["grad_norm"]


def make_lm_train_step(cfg, ocfg: AdamWConfig, microbatches: int,
                       lr: float = 1e-4):
    """``train_step(model, opt_state, tokens)`` for an ``LM`` module on
    ``transformer.loss_fn``: tokens [B, S] int.

    With ``microbatches > 1`` the batch splits into that many equal
    parts (row-major, as the reference's reshape); each part's gradient
    is added in place into one accumulator tree in ``cfg.param_dtype``,
    allocated once a step, which is divided by ``microbatches`` once; the
    loss is the mean of the parts' losses.  A Python loop is the
    reference's ``lax.scan``, and no list of per-part gradients is kept.

    The loss and its backward run in one ``matmul_flags`` scope: bfloat16
    products reduce in float32 (no reduced-precision split-K), as the
    reference accumulates, in the forward, in each layer recomputed under
    ``remat="full"`` and in every product's gradient, all of which run in
    the backward, outside ``forward``'s own scope.  TF32 stays off in the
    scope: the attention's score products switch it on around themselves
    (exact for bfloat16 operands; the recompute runs the same code, so it
    gets the same switch), and the gradients of those products run in
    IEEE float32, because float32 gradients are not exact in TF32."""

    def loss_and_grads(params, leaves, tokens):
        return _grads(functools.partial(tfm.loss_fn, params, tokens, cfg),
                      leaves)

    def train_step(model, opt_state, tokens):
        params = model.params()
        leaves = flatten(params)
        gb, seq = tokens.shape
        with matmul_flags(allow_bf16_reduced_precision_reduction=False,
                          allow_tf32=False):
            if microbatches > 1:
                acc = [torch.zeros(p.shape, dtype=cfg.param_dtype,
                                   device=p.device) for p in leaves]
                losses = []
                for part in tokens.reshape(microbatches, gb // microbatches,
                                           seq):
                    l, grads = loss_and_grads(params, leaves, part)
                    for a, g in zip(acc, grads):
                        a.add_(g)
                    del grads
                    losses.append(l)
                for a in acc:
                    a.div_(microbatches)
                loss, grads = torch.stack(losses).mean(), acc
            else:
                loss, grads = loss_and_grads(params, leaves, tokens)
        _, opt_state, st = adamw_update(unflatten(params, grads), opt_state,
                                        params, lr, ocfg)
        return model, opt_state, loss, st["grad_norm"]

    return train_step


def make_gnn_train_step(cfg, loss, ocfg: AdamWConfig, lr: float = 1e-3):
    """``train_step(model, opt_state, g)`` for a GNN or NequIP module.
    ``loss(model, g)`` -> (loss, aux): ``models.node_classification_loss``,
    or for NequIP ``lambda m, g: nequip.mse_loss(m.params(), g, m.cfg)``.
    ``cfg`` is the model's config, in the reference's first slot: the
    port's losses read it from the module."""
    del cfg

    def train_step(model, opt_state, g):
        return _step(model, opt_state, lambda: loss(model, g), lr, ocfg)

    return train_step


def make_recsys_train_step(cfg, ocfg: AdamWConfig, lr: float = 1e-3):
    """``train_step(model, opt_state, batch)`` for a ``WideDeep`` module
    on ``wide_deep.bce_loss``; ``cfg`` as in ``make_gnn_train_step``."""
    del cfg

    def train_step(model, opt_state, batch):
        return _step(model, opt_state, lambda: wd.bce_loss(model, batch),
                     lr, ocfg)

    return train_step


def lm_param_flops(cfg) -> tuple[int, int]:
    """(total params, active params) — MoE counts top-k experts only."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d
    if cfg.moe:
        ffn_total = cfg.n_experts * 3 * d * f + d * cfg.n_experts
        ffn_active = cfg.moe_topk * 3 * d * f + d * cfg.n_experts
        if cfg.dense_residual:
            rf = cfg.residual_d_ff or f
            ffn_total += 3 * d * rf
            ffn_active += 3 * d * rf
    else:
        ffn_total = ffn_active = 3 * d * f
    total = L * (attn + ffn_total) + 2 * v * d
    active = L * (attn + ffn_active) + 2 * v * d
    return total, active


# ===================================================================== #
# Cells
# ===================================================================== #
def _gen(device: torch.device) -> torch.Generator:
    """The init's generator: a seeded CPU one for the meta device (which
    draws no numbers), else one on the device."""
    return torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(0)


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _decode_step(params, tokens, kc, vc, length, cfg):
    logits, (nk, nv, nl) = tfm.serve_step(params, tokens, (kc, vc, length),
                                          cfg)
    return logits, nk, nv, nl


def _lm_cell(arch: ArchSpec, shape: ShapeSpec, device) -> Cell:
    cfg = arch.config
    total, active = lm_param_flops(cfg)
    gb, seq = shape.global_batch, shape.seq_len
    params = tfm.init(_gen(device), cfg, device=device)

    if shape.kind == "train":
        ocfg = AdamWConfig(state_mode=arch.opt_state_mode)
        model = tfm.LM(cfg, device=device, params=params)
        opt = adamw_init(model.params(), ocfg)
        fn = make_lm_train_step(cfg, ocfg, shape.microbatches)
        meta = dict(model_flops=6 * active * gb * seq,
                    params_total=total, params_active=active,
                    tokens=gb * seq)
        return Cell(arch.arch_id, shape.name, fn,
                    (model, opt, _zeros((gb, seq), I32, device)),
                    donate=(0, 1), meta=meta, skip_reason=shape.skip_reason)

    if shape.kind == "prefill":
        fn = functools.partial(tfm.prefill, cfg=cfg)
        meta = dict(model_flops=2 * active * gb * seq
                    + 2 * gb * cfg.n_layers * cfg.n_heads
                    * cfg.head_dim * seq * seq,   # attention term
                    params_total=total, tokens=gb * seq)
        return Cell(arch.arch_id, shape.name, fn,
                    (params, _zeros((gb, seq), I32, device)),
                    donate=(), meta=meta, skip_reason=shape.skip_reason)

    # decode: one token against a seq_len cache (bf16, as the reference's)
    smax = seq
    kv = (cfg.n_layers, gb, smax, cfg.n_kv_heads, cfg.head_dim)
    args = (params, _zeros((gb, 1), I32, device),
            _zeros(kv, torch.bfloat16, device),
            _zeros(kv, torch.bfloat16, device), _zeros((gb,), I32, device))
    # decode model flops: 2*active per token + KV attention reads
    attn_flops = 4 * gb * cfg.n_layers * cfg.n_heads * cfg.head_dim * smax
    meta = dict(model_flops=2 * active * gb + attn_flops,
                params_total=total, tokens=gb,
                kv_bytes=2 * cfg.n_layers * gb * smax * cfg.n_kv_heads
                * cfg.head_dim * 2)
    return Cell(arch.arch_id, shape.name,
                functools.partial(_decode_step, cfg=cfg), args,
                donate=(2, 3), meta=meta, skip_reason=shape.skip_reason)


def _pad_up(x: int, m: int = 512) -> int:
    """Pad a sharded leading dim to a multiple of the largest mesh size
    (512), as the reference's cells do, so a cell's shapes are the
    reference's; padding slots carry -1 sentinels and contribute
    nothing."""
    return ((x + m - 1) // m) * m


def _graph_sds(shape: ShapeSpec, for_nequip: bool, device):
    """The shape's graph batch as zero tensors on ``device`` -> (g, nodes,
    padded edges)."""
    ex = shape.extra
    if shape.name == "minibatch_lg":
        n, e = subgraph_shapes(ex["batch_nodes"], tuple(ex["fanout"]))
    elif shape.name == "molecule":
        n = ex["n_nodes"] * ex["batch"]
        e = ex["n_edges"] * ex["batch"]
    else:
        n, e = ex["n_nodes"], ex["n_edges"]
    e = _pad_up(e)
    f32 = torch.float32
    g = {"edge_src": _zeros((e,), I32, device),
         "edge_dst": _zeros((e,), I32, device)}
    if for_nequip:
        g["species"] = _zeros((n,), I32, device)
        g["pos"] = _zeros((n, 3), f32, device)
    else:
        g["x"] = _zeros((n, ex["d_feat"]), f32, device)
        g["labels"] = _zeros((n,), I32, device)
    if shape.name == "molecule":
        g["graph_ids"] = _zeros((n,), I32, device)
        if for_nequip:
            g["energy"] = _zeros((ex["batch"],), f32, device)
        else:
            g["graph_labels"] = _zeros((ex["batch"],), I32, device)
    elif for_nequip:
        g["energy"] = _zeros((1,), f32, device)
    if shape.name == "minibatch_lg" and not for_nequip:
        g["label_mask"] = _zeros((n,), torch.bool, device)
    return g, n, e


def _nequip_loss(model, g):
    return nq.mse_loss(model.params(), g, model.cfg)


_GNN_MODELS = {"gat": gnn.GAT, "gin": gnn.GIN, "pna": gnn.PNA}


def _gnn_cell(arch: ArchSpec, shape: ShapeSpec, device) -> Cell:
    is_nq = arch.family == "nequip"
    ex = shape.extra
    # full-batch-large shapes remat per layer and (GNNs) compute in bf16,
    # as the reference's cells do
    big = shape.name in ("ogb_products", "minibatch_lg")
    gen = _gen(device)
    if is_nq:
        cfg = dataclasses.replace(arch.config, remat=big)
        model = nq.NequIP(cfg, device=device,
                          params=nq.init(gen, cfg, device=device))
        loss = _nequip_loss
    else:
        base = arch.config
        cfg = dataclasses.replace(
            base, d_in=ex["d_feat"], n_classes=ex["n_classes"], remat=big,
            dtype=torch.bfloat16 if big else base.dtype)
        model = _GNN_MODELS[base.arch](
            cfg, device=device,
            params=gnn.INITS[base.arch](gen, cfg, device=device))
        loss = gnn.node_classification_loss
    ocfg = AdamWConfig(state_mode="fp32")
    opt = adamw_init(model.params(), ocfg)
    g, n, e = _graph_sds(shape, is_nq, device)
    ng = ex.get("batch", 1)

    def loss_with_static(m, graph):
        graph = dict(graph)
        if shape.name == "molecule":
            graph["n_graphs"] = ng       # static: closed over
        return loss(m, graph)

    fn = make_gnn_train_step(cfg, loss_with_static, ocfg)
    d_h = getattr(cfg, "d_hidden", getattr(cfg, "channels", 32))
    layers = cfg.n_layers
    # model flops: fwd+bwd of per-edge message (2*d_h^2-ish) + node MLPs
    meta = dict(model_flops=6 * layers * (e * d_h * d_h + n * d_h * d_h),
                n_nodes=n, n_edges=e)
    return Cell(arch.arch_id, shape.name, fn, (model, opt, g),
                donate=(0, 1), meta=meta, skip_reason=shape.skip_reason)


def _recsys_cell(arch: ArchSpec, shape: ShapeSpec, device) -> Cell:
    cfg = arch.config
    b = shape.global_batch
    f32 = torch.float32

    if shape.kind == "retrieval":
        nc = _pad_up(shape.extra["n_candidates"])
        args = (_zeros((cfg.embed_dim,), f32, device),
                _zeros((nc, cfg.embed_dim), f32, device))
        fn = functools.partial(wd.retrieval_score, top_k=100)
        meta = dict(model_flops=2 * nc * cfg.embed_dim, n_candidates=nc)
        return Cell(arch.arch_id, shape.name, fn, args, donate=(),
                    meta=meta, skip_reason=shape.skip_reason)

    batch = {
        "sparse_ids": _zeros((b, cfg.n_sparse), I32, device),
        "dense": _zeros((b, cfg.n_dense), f32, device),
        "wide_ids": _zeros((b, cfg.n_wide_crosses), I32, device),
        "labels": _zeros((b,), I32, device),
    }
    params = wd.init(_gen(device), cfg, device=device)
    mlp_flops = 0
    d = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    for h in cfg.mlp:
        mlp_flops += 2 * d * h
        d = h
    embed_bytes = cfg.n_sparse * cfg.embed_dim * 4

    if shape.kind == "train":
        ocfg = AdamWConfig(state_mode="factored")
        model = wd.WideDeep(cfg, device=device, params=params)
        opt = adamw_init(model.params(), ocfg)
        meta = dict(model_flops=6 * b * mlp_flops // 2,
                    embed_bytes=3 * b * embed_bytes)
        return Cell(arch.arch_id, shape.name,
                    make_recsys_train_step(cfg, ocfg), (model, opt, batch),
                    donate=(0, 1), meta=meta, skip_reason=shape.skip_reason)

    meta = dict(model_flops=b * mlp_flops, embed_bytes=b * embed_bytes)
    return Cell(arch.arch_id, shape.name, functools.partial(wd.forward,
                                                            cfg=cfg),
                (params, batch), donate=(), meta=meta,
                skip_reason=shape.skip_reason)


_FAMILY_CELLS = {"lm": _lm_cell, "gnn": _gnn_cell, "nequip": _gnn_cell,
                 "recsys": _recsys_cell}


def cell_for(arch: ArchSpec, shape: ShapeSpec, *, device="meta") -> Cell:
    """The cell of ``shape`` under ``arch``, which need not be in the
    registry: a configuration or shape cut to size
    (``dataclasses.replace`` of a registry entry) builds as the full one
    does."""
    return _FAMILY_CELLS[arch.family](arch, shape, torch.device(device))


def build_cell(arch_id: str, shape_name: str, mesh=None, *,
               device="meta") -> Cell:
    """The cell of ``arch_id`` at ``shape_name``, its arguments on
    ``device`` (the meta device: nothing is allocated).  A cell is the
    one-card program: a ``mesh`` of more than one entry raises
    ``NotImplementedError`` (per-device cells wait for meshes of distinct
    devices)."""
    if mesh is not None and mesh.devices.size > 1:
        raise NotImplementedError(
            "a cell is the one-card program; per-device cells over a mesh "
            "wait for meshes of distinct devices")
    arch = get_arch(arch_id)
    return cell_for(arch, arch.shape(shape_name), device=device)


def all_cells() -> list[tuple[str, str]]:
    out = []
    for aid, arch in ARCHS.items():
        for s in arch.shapes:
            out.append((aid, s.name))
    return out


def cell_leaves(cell: Cell) -> list:
    """The tensors of ``cell.args`` in the reference's leaf order, a
    module read through its ``params()`` tree."""
    out = []
    for a in cell.args:
        out.extend(flatten(a.params() if hasattr(a, "params") else a))
    return out

