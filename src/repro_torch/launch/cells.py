"""Cell builders and train steps: the port of ``repro.launch.cells``.

A *cell* bundles what the dry run (``launch.dryrun``) and the drivers
need for one (architecture × input shape × mesh):

  fn            the step: a train step, ``transformer.prefill``, a decode
                step on ``transformer.serve_step``, ``wide_deep.forward``
                or ``wide_deep.retrieval_score``
  args          its arguments, tensors on ``device`` (the meta device by
                default: shapes and dtypes, no storage — the port's
                ``ShapeDtypeStruct``); a train step's first argument is
                the model, an ``nn.Module`` built from the module-level
                init with a seeded generator
  in_shardings  a tree of ``PartitionSpec`` matching ``args`` (a
                module's through its ``params()`` tree), None without a
                mesh
  out_shardings the same for the outputs
  donate        argument indices the reference donates (the step updates
                them in place here)
  meta          model-FLOPs terms for the roofline, the reference's
                integer arithmetic

On a process-group mesh (``core.distributed.Mesh(group=)``, one rank a
device) ``args`` are this rank's blocks under ``in_shardings`` — the
block JAX's ``NamedSharding`` gives the device at the same mesh
coordinates — and ``fn`` is the rank's program, which calls the
collectives itself (``core.collectives``): FSDP × TP for the LM family,
row-sharded tables for Wide&Deep, sharded edges for the GNNs (the
models' docstrings).  Its outputs are the rank's blocks under
``out_shardings``.  On a one-process mesh of one device (repeated) the
cell is the one-card program with the shardings attached.

A train step takes the model (which holds its parameters and config),
the optimiser state (``optim.adamw_init`` of ``model.params()``) and a
batch: it runs the forward and the backward (``torch.autograd.grad``, so
no ``.grad`` is left on the parameters), then ``adamw_update``, which
writes the new parameters into the module in place.  It returns
``(model, opt_state, loss, grad_norm)``.  ``lr`` is the builder's value,
captured by the step as in the reference.  Sharded, each rank's
objective is the global loss over the number of ranks, so that the
collectives' gradients sum to the global one, and each gradient is
summed over the mesh axes its leaf is replicated on before the update
(``sync_grads``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

from typing import Any

import torch

from repro_torch.configs.registry import ARCHS, ArchSpec, ShapeSpec, get_arch
from repro_torch.core.collectives import all_reduce_
from repro_torch.core.distributed import (
    _DISTINCT,
    P,
    local_block,
    replicated_axes,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import MeshAxes, constrain, matmul_flags
from repro_torch.models.gnn import models as gnn
from repro_torch.models.gnn import nequip as nq
from repro_torch.models.gnn.sampler import subgraph_shapes
from repro_torch.models.recsys import wide_deep as wd
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import state_specs as adamw_state_specs
from repro_torch.optim.tree import flatten, flatten_up_to, tree_map, unflatten

I32 = torch.int32


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    # the reference's donate is a jit knob here too (the steps update in
    # place): it and the fields after it are keyword-only
    _: dataclasses.KW_ONLY
    donate: tuple
    meta: dict
    skip_reason: str | None = None


def _specs(mesh, spec_tree):
    """The reference's ``_ns``: the spec tree, None without a mesh."""
    return None if mesh is None else spec_tree


# ===================================================================== #
# Train steps
# ===================================================================== #
def _grads(loss: Callable, leaves: list, scale: float = 1.0):
    """``loss()`` -> (loss, aux): the detached loss and the gradient of
    every leaf of ``loss * scale`` (zeros for a leaf the loss does not
    reach, as ``jax.grad`` gives it: NequIP's last gate)."""
    l, _ = loss()
    grads = torch.autograd.grad(l * scale if scale != 1.0 else l, leaves,
                                allow_unused=True)
    return l.detach(), [torch.zeros_like(p) if g is None else g
                        for g, p in zip(grads, leaves)]


def sync_grads(grads: list, specs: list, mesh) -> list:
    """Each gradient block summed in place over the mesh axes its leaf
    is replicated on (``specs``: the leaves' ``PartitionSpec``s, in
    order): the ranks that hold a copy of the block each hold part of
    its gradient."""
    for g, spec in zip(grads, specs):
        rep = replicated_axes(spec, mesh)
        if rep:
            all_reduce_(g, mesh.axis_group(rep))
    return grads


def _mesh_of(axes):
    return None if axes is None else axes.mesh


def _step(model, opt_state, loss, lr, ocfg: AdamWConfig, specs=None,
          mesh=None):
    params = model.params()
    leaves = flatten(params)
    l, grads = _grads(loss, leaves, 1.0 / mesh.size if mesh else 1.0)
    if mesh is not None:
        sync_grads(grads, flatten_up_to(params, specs), mesh)
    _, opt_state, st = adamw_update(unflatten(params, grads), opt_state,
                                    params, lr, ocfg, specs=specs,
                                    mesh=mesh)
    return model, opt_state, l, st["grad_norm"]


def make_lm_train_step(cfg, ocfg: AdamWConfig, microbatches: int,
                       lr: float = 1e-4, axes=None):
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
    IEEE float32, because float32 gradients are not exact in TF32.

    ``axes`` over a process-group mesh: the model holds the rank's
    blocks (``transformer.param_specs``), ``tokens`` is its data block,
    and each microbatch is a block of the rank's rows (the reference
    constrains its microbatches' batch dim over ``dp``); a rank with
    fewer rows than ``microbatches`` runs one a row."""
    mesh = _mesh_of(axes)
    scale = 1.0 / mesh.size if mesh else 1.0

    def loss_and_grads(params, leaves, tokens):
        return _grads(functools.partial(tfm.loss_fn, params, tokens, cfg,
                                        axes), leaves, scale)

    def train_step(model, opt_state, tokens):
        params = model.params()
        leaves = flatten(params)
        gb, seq = tokens.shape
        # a rank holding fewer rows than the microbatches runs one a row
        # (the reference's partitioner splits such a microbatch's rows
        # below one a device)
        mb = microbatches if mesh is None else math.gcd(gb, microbatches)
        with matmul_flags(allow_bf16_reduced_precision_reduction=False,
                          allow_tf32=False):
            if mb > 1:
                acc = [torch.zeros(p.shape, dtype=cfg.param_dtype,
                                   device=p.device) for p in leaves]
                losses = []
                for part in tokens.reshape(mb, gb // mb, seq):
                    part = constrain(part, axes, "dp", None)
                    l, grads = loss_and_grads(params, leaves, part)
                    for a, g in zip(acc, grads):
                        a.add_(g)
                    del grads
                    losses.append(l)
                for a in acc:
                    a.div_(mb)
                loss, grads = torch.stack(losses).mean(), acc
            else:
                loss, grads = loss_and_grads(params, leaves, tokens)
        specs = None
        if mesh is not None:
            specs = tfm.param_specs(cfg, axes)
            sync_grads(grads, flatten_up_to(params, specs), mesh)
        _, opt_state, st = adamw_update(unflatten(params, grads), opt_state,
                                        params, lr, ocfg, specs=specs,
                                        mesh=mesh)
        return model, opt_state, loss, st["grad_norm"]

    return train_step


def make_gnn_train_step(cfg, loss, ocfg: AdamWConfig, lr: float = 1e-3):
    """``train_step(model, opt_state, g)`` for a GNN or NequIP module.
    ``loss(model, g)`` -> (loss, aux): ``models.node_classification_loss``,
    or for NequIP ``lambda m, g: nequip.mse_loss(m.params(), g, m.cfg)``.
    ``cfg`` is the model's config, in the reference's first slot: the
    port's losses read it from the module.  A model whose config names a
    process-group mesh (``cfg.mesh``) runs sharded: its parameters are
    replicated (``models.param_specs``) and ``g``'s edges are the rank's
    block."""
    del cfg

    def train_step(model, opt_state, g):
        mesh = model.cfg.mesh
        specs = None if mesh is None else tree_map(lambda _: P(),
                                                   model.params())
        return _step(model, opt_state, lambda: loss(model, g), lr, ocfg,
                     specs, mesh)

    return train_step


def make_recsys_train_step(cfg, ocfg: AdamWConfig, lr: float = 1e-3):
    """``train_step(model, opt_state, batch)`` for a ``WideDeep`` module
    on ``wide_deep.bce_loss``; a module with ``axes`` over a
    process-group mesh holds the rank's blocks
    (``wide_deep.param_specs``) and ``batch`` is its data block."""

    def train_step(model, opt_state, batch):
        mesh = _mesh_of(model.axes)
        specs = None if mesh is None else wd.param_specs(cfg, model.axes)
        return _step(model, opt_state, lambda: wd.bce_loss(model, batch),
                     lr, ocfg, specs, mesh)

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


def _ranks(mesh):
    """The mesh whose ranks run the cell (a process-group mesh), or
    None: the one-card program."""
    return mesh if mesh is not None and mesh.group is not None else None


def _local(tree, specs, mesh):
    """``tree``'s leaves as this rank's blocks under ``specs``, each a
    tensor of its own (the global one can go); ``tree`` itself when no
    ranks run the cell."""
    if mesh is None:
        return tree
    return tree_map(lambda x, sp: local_block(x, sp, mesh).clone(
        memory_format=torch.contiguous_format), tree, specs)


def _decode_step(params, tokens, kc, vc, length, cfg, axes=None):
    logits, (nk, nv, nl) = tfm.serve_step(params, tokens, (kc, vc, length),
                                          cfg, axes=axes)
    return logits, nk, nv, nl


def _lm_cell(arch: ArchSpec, shape: ShapeSpec, mesh, device) -> Cell:
    cfg = arch.config
    ranks = _ranks(mesh)
    axes = MeshAxes.for_mesh(mesh) if mesh is not None else MeshAxes()
    run_axes = axes if ranks is not None else None
    total, active = lm_param_flops(cfg)
    gb, seq = shape.global_batch, shape.seq_len
    params = tfm.init(_gen(device), cfg, device=device)
    pspecs = tfm.param_specs(cfg, axes)
    dp_size = mesh.axis_size(axes.dp) if mesh is not None else 1

    if shape.kind == "train":
        ocfg = AdamWConfig(state_mode=arch.opt_state_mode)
        ospecs = adamw_state_specs(pspecs, params, ocfg)
        params = _local(params, pspecs, ranks)
        model = tfm.LM(cfg, device=device, params=params)
        del params
        opt = adamw_init(model.params(), ocfg,
                         specs=pspecs if ranks else None, mesh=ranks)
        tokens = _local(_zeros((gb, seq), I32, device), P(axes.dp, None),
                        ranks)
        fn = make_lm_train_step(cfg, ocfg, shape.microbatches,
                                axes=run_axes)
        in_sh = _specs(mesh, (pspecs, ospecs, P(axes.dp, None)))
        out_sh = _specs(mesh, (pspecs, ospecs, P(), P()))
        meta = dict(model_flops=6 * active * gb * seq,
                    params_total=total, params_active=active,
                    tokens=gb * seq)
        return Cell(arch.arch_id, shape.name, fn, (model, opt, tokens),
                    in_sh, out_sh, donate=(0, 1), meta=meta,
                    skip_reason=shape.skip_reason)

    params = _local(params, pspecs, ranks)
    if shape.kind == "prefill":
        fn = functools.partial(tfm.prefill, cfg=cfg, axes=run_axes)
        kv_out = P(None, axes.dp, axes.tp, None, None)
        tokens = _local(_zeros((gb, seq), I32, device), P(axes.dp, None),
                        ranks)
        in_sh = _specs(mesh, (pspecs, P(axes.dp, None)))
        out_sh = _specs(mesh, (P(axes.dp, axes.tp), kv_out, kv_out))
        meta = dict(model_flops=2 * active * gb * seq
                    + 2 * gb * cfg.n_layers * cfg.n_heads
                    * cfg.head_dim * seq * seq,   # attention term
                    params_total=total, tokens=gb * seq)
        return Cell(arch.arch_id, shape.name, fn, (params, tokens),
                    in_sh, out_sh, donate=(), meta=meta,
                    skip_reason=shape.skip_reason)

    # decode: one token against a seq_len cache (bf16, as the reference's)
    smax = seq
    kv = (cfg.n_layers, gb, smax, cfg.n_kv_heads, cfg.head_dim)
    # the serving rule's layout: weights 2-D sharded and stationary, the
    # per-token activations replicated (tokens, length and logits carry
    # no dp sharding; the step moves only them: ``transformer.
    # serve_step``); a batch smaller than the data axes puts the cache's
    # positions over every axis instead of its batch over the data axes
    if mesh is not None and gb < dp_size:
        kv_spec = P(None, None, tuple(axes.dp) + (axes.tp,), None, None)
    else:
        kv_spec = P(None, axes.dp, axes.tp, None, None)
    tok_spec, len_spec = P(None, None), P(None)
    args = (params, _zeros((gb, 1), I32, device),
            _local(_zeros(kv, torch.bfloat16, device), kv_spec, ranks),
            _local(_zeros(kv, torch.bfloat16, device), kv_spec, ranks),
            _zeros((gb,), I32, device))
    in_sh = _specs(mesh, (pspecs, tok_spec, kv_spec, kv_spec, len_spec))
    out_sh = _specs(mesh, (P(None, None), kv_spec, kv_spec, len_spec))
    # decode model flops: 2*active per token + KV attention reads
    attn_flops = 4 * gb * cfg.n_layers * cfg.n_heads * cfg.head_dim * smax
    meta = dict(model_flops=2 * active * gb + attn_flops,
                params_total=total, tokens=gb,
                kv_bytes=2 * cfg.n_layers * gb * smax * cfg.n_kv_heads
                * cfg.head_dim * 2)
    return Cell(arch.arch_id, shape.name,
                functools.partial(_decode_step, cfg=cfg, axes=run_axes),
                args, in_sh, out_sh, donate=(2, 3), meta=meta,
                skip_reason=shape.skip_reason)


def _pad_up(x: int, m: int = 512) -> int:
    """Pad a sharded leading dim to a multiple of the largest mesh size
    (512), as the reference's cells do, so a cell's shapes are the
    reference's and every mesh's blocks divide exactly; padding slots
    carry -1 sentinels and contribute nothing."""
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


def _graph_specs(g, mesh):
    """Edges sharded over every mesh axis (flat); node arrays
    replicated."""
    if mesh is None:
        return None
    all_axes = tuple(mesh.axis_names)
    return {k: P(all_axes) if k.startswith("edge_") else P(*([None] * v.ndim))
            for k, v in g.items()}


def _nequip_loss(model, g):
    return nq.mse_loss(model.params(), g, model.cfg)


_GNN_MODELS = {"gat": gnn.GAT, "gin": gnn.GIN, "pna": gnn.PNA}


def _gnn_cell(arch: ArchSpec, shape: ShapeSpec, mesh, device) -> Cell:
    is_nq = arch.family == "nequip"
    ex = shape.extra
    ranks = _ranks(mesh)
    # full-batch-large shapes: node-dim activations sharded over the
    # whole mesh, each layer recomputed in the backward and (GNNs) bf16
    # activations, as the reference's cells do
    big = shape.name in ("ogb_products", "minibatch_lg")
    mesh_axes = tuple(mesh.axis_names) if (mesh is not None and big) \
        else None
    gen = _gen(device)
    if is_nq:
        cfg = dataclasses.replace(arch.config, mesh_axes=mesh_axes,
                                  remat=big, mesh=ranks)
        model = nq.NequIP(cfg, device=device,
                          params=nq.init(gen, cfg, device=device))
        loss = _nequip_loss
    else:
        base = arch.config
        cfg = dataclasses.replace(
            base, d_in=ex["d_feat"], n_classes=ex["n_classes"],
            mesh_axes=mesh_axes, remat=big, mesh=ranks,
            dtype=torch.bfloat16 if big else base.dtype)
        model = _GNN_MODELS[base.arch](
            cfg, device=device,
            params=gnn.INITS[base.arch](gen, cfg, device=device))
        loss = gnn.node_classification_loss
    ocfg = AdamWConfig(state_mode="fp32")
    pspecs = tree_map(lambda _: P(), model.params())
    opt = adamw_init(model.params(), ocfg, specs=pspecs if ranks else None,
                     mesh=ranks)
    ospecs = adamw_state_specs(pspecs, model.params(), ocfg)
    g, n, e = _graph_sds(shape, is_nq, device)
    gspecs = _graph_specs(g, mesh)
    g = _local(g, gspecs, ranks)
    ng = ex.get("batch", 1)

    def loss_with_static(m, graph):
        graph = dict(graph)
        if shape.name == "molecule":
            graph["n_graphs"] = ng       # static: closed over
        return loss(m, graph)

    fn = make_gnn_train_step(cfg, loss_with_static, ocfg)
    in_sh = _specs(mesh, (pspecs, ospecs, gspecs))
    out_sh = _specs(mesh, (pspecs, ospecs, P(), P()))
    d_h = getattr(cfg, "d_hidden", getattr(cfg, "channels", 32))
    layers = cfg.n_layers
    # model flops: fwd+bwd of per-edge message (2*d_h^2-ish) + node MLPs
    meta = dict(model_flops=6 * layers * (e * d_h * d_h + n * d_h * d_h),
                n_nodes=n, n_edges=e)
    return Cell(arch.arch_id, shape.name, fn, (model, opt, g), in_sh,
                out_sh, donate=(0, 1), meta=meta,
                skip_reason=shape.skip_reason)


def _recsys_cell(arch: ArchSpec, shape: ShapeSpec, mesh, device) -> Cell:
    cfg = arch.config
    ranks = _ranks(mesh)
    axes = MeshAxes.for_mesh(mesh) if mesh is not None else MeshAxes()
    run_axes = axes if ranks is not None else None
    b = shape.global_batch
    f32 = torch.float32

    if shape.kind == "retrieval":
        nc = _pad_up(shape.extra["n_candidates"])
        all_axes = tuple(mesh.axis_names) if mesh is not None else ()
        cand_spec = P(all_axes, None)
        args = (_zeros((cfg.embed_dim,), f32, device),
                _local(_zeros((nc, cfg.embed_dim), f32, device), cand_spec,
                       ranks))
        fn = functools.partial(wd.retrieval_score, top_k=100, axes=run_axes)
        in_sh = _specs(mesh, (P(None), cand_spec))
        out_sh = _specs(mesh, (P(None), P(None)))
        meta = dict(model_flops=2 * nc * cfg.embed_dim, n_candidates=nc)
        return Cell(arch.arch_id, shape.name, fn, args, in_sh, out_sh,
                    donate=(), meta=meta, skip_reason=shape.skip_reason)

    bspec = {"sparse_ids": P(axes.dp, None), "dense": P(axes.dp, None),
             "wide_ids": P(axes.dp, None), "labels": P(axes.dp)}
    batch = _local({
        "sparse_ids": _zeros((b, cfg.n_sparse), I32, device),
        "dense": _zeros((b, cfg.n_dense), f32, device),
        "wide_ids": _zeros((b, cfg.n_wide_crosses), I32, device),
        "labels": _zeros((b,), I32, device),
    }, bspec, ranks)
    params = wd.init(_gen(device), cfg, device=device)
    pspecs = wd.param_specs(cfg, axes)
    mlp_flops = 0
    d = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    for h in cfg.mlp:
        mlp_flops += 2 * d * h
        d = h
    embed_bytes = cfg.n_sparse * cfg.embed_dim * 4

    if shape.kind == "train":
        ocfg = AdamWConfig(state_mode="factored")
        ospecs = adamw_state_specs(pspecs, params, ocfg)
        model = wd.WideDeep(cfg, device=device,
                            params=_local(params, pspecs, ranks),
                            axes=run_axes)
        del params
        opt = adamw_init(model.params(), ocfg,
                         specs=pspecs if ranks else None, mesh=ranks)
        in_sh = _specs(mesh, (pspecs, ospecs, bspec))
        out_sh = _specs(mesh, (pspecs, ospecs, P(), P()))
        meta = dict(model_flops=6 * b * mlp_flops // 2,
                    embed_bytes=3 * b * embed_bytes)
        return Cell(arch.arch_id, shape.name,
                    make_recsys_train_step(cfg, ocfg), (model, opt, batch),
                    in_sh, out_sh, donate=(0, 1), meta=meta,
                    skip_reason=shape.skip_reason)

    in_sh = _specs(mesh, (pspecs, bspec))
    out_sh = _specs(mesh, P(axes.dp))
    meta = dict(model_flops=b * mlp_flops, embed_bytes=b * embed_bytes)
    return Cell(arch.arch_id, shape.name,
                functools.partial(wd.forward, cfg=cfg, axes=run_axes),
                (_local(params, pspecs, ranks), batch), in_sh, out_sh,
                donate=(), meta=meta, skip_reason=shape.skip_reason)


_FAMILY_CELLS = {"lm": _lm_cell, "gnn": _gnn_cell, "nequip": _gnn_cell,
                 "recsys": _recsys_cell}


def cell_for(arch: ArchSpec, shape: ShapeSpec, *, mesh=None,
             device="meta") -> Cell:
    """The cell of ``shape`` under ``arch``, which need not be in the
    registry: a configuration or shape cut to size
    (``dataclasses.replace`` of a registry entry) builds as the full one
    does.  ``mesh``: see ``build_cell``."""
    if mesh is not None and mesh.group is not None and mesh.rank is None:
        raise ValueError("this process is not a rank of the mesh's group")
    return _FAMILY_CELLS[arch.family](arch, shape, mesh,
                                      torch.device(device))


def build_cell(arch_id: str, shape_name: str, mesh=None, *,
               device="meta") -> Cell:
    """The cell of ``arch_id`` at ``shape_name``, its arguments on
    ``device`` (the meta device: nothing is allocated).

    ``mesh`` None: the one-card program, no shardings.  A process-group
    mesh (``core.distributed.Mesh(group=)``, e.g. ``launch.mesh.
    make_production_mesh(group=)``) of any size: ``args`` are this
    rank's blocks of the arguments and ``fn`` the rank's program (see
    the module docstring).  A one-process mesh names one device (n
    logical entries on it: the one-card program with the shardings
    attached); distinct devices are other processes' (``core.
    distributed``'s rule, which ``Mesh`` enforces)."""
    if mesh is not None and mesh.group is None and any(
            d != mesh.device for d in mesh.devices.reshape(-1)):
        raise NotImplementedError(_DISTINCT)
    arch = get_arch(arch_id)
    return cell_for(arch, arch.shape(shape_name), mesh=mesh, device=device)


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

