"""GAT, GIN and PNA, the port of ``repro.models.gnn.models``: the
forwards (node-level, and GIN's pooled per graph) and the training loss
``node_classification_loss``.

Graphs are dicts of tensors:
  x [N, F] node features; edge_src/edge_dst int32 [E] (-1 = padding);
  optional graph_ids [N] (-1 = padding) with ``n_graphs`` (an int) for
  batched small graphs.

Every segment *sum* goes through the segment_sum kernel (``message.
gather_scatter`` for GIN, ``sr.segment_sum`` for GAT's messages and
PNA's sum and sum of squares); segment max/min and the attention
softmax are plain torch, as the reference's are plain JAX.  Every
per-edge gather of node rows (GIN's ``x[src]``, GAT's scores and
messages, PNA's row pairs) is ``message.gather_rows``, whose gradient is
a segment sum on the same kernel: a hub's millions of bf16 gradient
terms sum in float32, and the padding edges (index -1) add nothing,
where ``index_put_``'s backward kernel walks every duplicate of one row
in turn (a padded minibatch's edges clamped onto row 0 made it most of a
GAT or PNA train step).

``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
does.  The models take the reference's functional forwards' place:
``node_classification_loss`` takes the module, and ``params()`` reads
its parameters back as the reference's tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import all_reduce, all_reduce_
from repro_torch.core.distributed import P
from repro_torch.core.join import resolve_backend
from repro_torch.core.state import resolve_device
from repro_torch.kernels.segment_reduce import ops as sr
from repro_torch.models.common import dense_init, params_from_numpy  # noqa: F401
from repro_torch.models.gnn.message import (
    NodeBlocks,
    degrees,
    edge_sum,
    gather_rows,
    gather_scatter,
    pool_graphs,
    segment_extreme,
    segment_softmax,
)
from repro_torch.optim.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    arch: str = "gat"            # gat | gin | pna
    n_layers: int = 2
    d_in: int = 16
    d_hidden: int = 8
    n_heads: int = 8             # gat
    n_classes: int = 7
    eps_learnable: bool = True   # gin
    aggregators: tuple = ("mean", "max", "min", "std")   # pna
    scalers: tuple = ("identity", "amplification", "attenuation")
    delta: float = 2.5           # pna degree normalizer (log-mean degree)
    backend: str | None = None   # segment_sum: None = device default
    # nequip (its model takes models.gnn.nequip.NequIPConfig)
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    dtype: torch.dtype = torch.float32
    # distribution: shard node-dim tensors over these mesh axes (the
    # reference's full-batch-large shapes)
    mesh_axes: tuple | None = None
    # a field the port adds comes after this marker
    _: dataclasses.KW_ONLY
    remat: bool = False          # recompute each layer in the backward
    # the process-group mesh whose ranks split the edge arrays (every
    # mesh axis, flat) and replicate the node arrays; None: one device
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


def _module_params(tree: dict, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v.to(device))
                             for k, v in tree.items()})


class _GNN(nn.Module):
    """Parameters on ``device`` (None means the card) in the reference's
    tree layout: ``params`` (from ``INITS[arch]`` or
    ``params_from_numpy``), or drawn from a generator seeded with
    ``seed`` on the device.  ``backend`` is the segment_sum backend the
    forward uses ("ref" runs the plain version on the card)."""

    ARCH = ""

    def __init__(self, cfg: GNNConfig, *, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, device)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = INITS[self.ARCH](gen, cfg, device=device)
        self.layers = nn.ModuleList(_module_params(lp, device)
                                    for lp in params["layers"])
        if "readout" in params:
            self.readout = nn.Parameter(params["readout"].to(device))

    @property
    def group(self):
        """The process group the edges are split over (None: one
        device)."""
        mesh = self.cfg.mesh
        return None if mesh is None else mesh.group

    def node_blocks(self, n: int):
        """The node blocks of an n-node graph when the config shards the
        node-dim tensors (``mesh_axes`` on a process-group mesh: the
        forward then returns the rank's block of the logits), else
        None."""
        cfg = self.cfg
        if cfg.mesh is None or cfg.mesh_axes is None:
            return None
        return NodeBlocks(n, cfg.mesh.axis_group(tuple(cfg.mesh_axes)))

    def _layer(self, lp, keys):
        return (lp[k].to(self.cfg.dtype) for k in keys)

    def _apply(self, layer, x, *args):
        """``layer(x, *args)``, recomputed in the backward under
        ``cfg.remat``."""
        if self.cfg.remat:
            return checkpoint(layer, x, *args, use_reentrant=False)
        return layer(x, *args)

    def params(self) -> dict:
        """The parameters as the reference's tree (the module's own
        tensors, not copies)."""
        tree = {"layers": [dict(lp.items()) for lp in self.layers]}
        if hasattr(self, "readout"):
            tree["readout"] = self.readout
        return tree


# --------------------------------------------------------------------- #
# GAT
# --------------------------------------------------------------------- #
def gat_init(gen: torch.Generator, cfg: GNNConfig, *, device=None) -> dict:
    """Seeded GAT parameters in the reference's tree layout."""
    device = resolve_device(device)
    layers = []
    d = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        out = cfg.n_classes if last else cfg.d_hidden
        layers.append({
            "w": dense_init(gen, (d, cfg.n_heads, out), device=device),
            "a_src": dense_init(gen, (cfg.n_heads, out), 1, device=device),
            "a_dst": dense_init(gen, (cfg.n_heads, out), 1, device=device),
        })
        d = out if last else out * cfg.n_heads
    return {"layers": layers}


class GAT(_GNN):
    """GAT: per layer ``h = x w`` [N, H, O], attention logits
    ``leaky_relu(es + ed, 0.2)`` softmaxed over each node's in-edges,
    messages ``h[src] * alpha`` summed into dst through the segment_sum
    kernel; ELU of the concatenated heads, the head mean at the last
    layer.  Logits [N, n_classes] in ``cfg.dtype``.

    ``es``/``ed`` are computed per node and gathered per edge ([E, H]),
    where the reference gathers ``h[src]``/``h[dst]`` ([E, H, O]) for
    them, and the one [E, H, O] gather (the message) is scaled in place
    (the gathers are ``gather_rows``; a padding edge's weight is 0):
    at the ogbn-products shape the second layer's message alone is
    61 M x 8 x 47 bf16 = 46 GB, and a second one does not fit on the
    card."""

    ARCH = "gat"
    KEYS = ("w", "a_src", "a_dst")

    def forward(self, g: dict) -> torch.Tensor:
        x = g["x"].to(self.cfg.dtype)
        src, dst = g["edge_src"], g["edge_dst"]
        e_ok = (src >= 0) & (dst >= 0)
        seg = torch.where(e_ok, dst, -1)
        nodes = self.node_blocks(x.shape[0])
        if nodes is not None:
            x = nodes.block(x)
        for i, lp in enumerate(self.layers):
            x = self._apply(self._gat_layer, x, lp, src, dst, e_ok, seg,
                            i == len(self.layers) - 1, nodes)
        return x

    def _gat_layer(self, x, lp, s, t, e_ok, seg, last: bool, nodes=None):
        w, a_src, a_dst = self._layer(lp, self.KEYS)
        h = torch.einsum("nf,fho->nho", x, w)                 # [N, H, O]
        es = torch.einsum("nho,ho->nh", h, a_src)
        ed = torch.einsum("nho,ho->nh", h, a_dst)
        if nodes is not None:     # the blocks' rows, for every edge
            es, ed = nodes.whole(es), nodes.whole(ed)
            h = nodes.whole(h.reshape(h.shape[0], -1)).view(
                -1, *h.shape[1:])
        n = h.shape[0]
        score = F.leaky_relu(gather_rows(es, s, self.backend)
                             + gather_rows(ed, t, self.backend),
                             0.2)                               # [E, H]
        del es, ed
        score.masked_fill_(~e_ok[:, None], float("-inf"))
        alpha = segment_softmax(score, seg, n, group=self.group)
        del score
        msg = gather_rows(h.view(n, -1), s, self.backend)     # a fresh gather
        msg = msg.view(-1, *h.shape[1:])                      # [E, H, O]
        msg.mul_(alpha[..., None])                # scaled in place
        del alpha
        msg = msg.view(msg.shape[0], -1)
        if nodes is not None:
            agg = nodes.scatter(sr.segment_sum(seg, msg, n, self.backend))
        else:
            agg = edge_sum(seg, msg, n, self.backend, group=self.group)
        del msg
        agg = agg.view(agg.shape[0], h.shape[1], -1)
        return agg.mean(1) if last else F.elu(agg.view(agg.shape[0], -1))


# --------------------------------------------------------------------- #
# GIN
# --------------------------------------------------------------------- #
def gin_init(gen: torch.Generator, cfg: GNNConfig, *, device=None) -> dict:
    """Seeded GIN parameters in the reference's tree layout, made on
    ``device`` from ``gen`` (a generator on that device)."""
    device = resolve_device(device)
    layers = []
    d = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "w1": dense_init(gen, (d, cfg.d_hidden), device=device),
            "w2": dense_init(gen, (cfg.d_hidden, cfg.d_hidden),
                             device=device),
            "ln": torch.ones((cfg.d_hidden,), device=device),
            "eps": torch.zeros((), device=device),
        })
        d = cfg.d_hidden
    return {"layers": layers,
            "readout": dense_init(gen, (cfg.d_hidden, cfg.n_classes),
                                  device=device)}


def _norm_relu(h, ln):
    """The reference's normalisation: population variance, sd >= 1e-3."""
    mu = h.mean(-1, keepdim=True)
    sd = torch.sqrt(torch.clamp(h.var(-1, keepdim=True, correction=0),
                                min=1e-6))
    return torch.relu(ln * (h - mu) / sd)


class GIN(_GNN):
    """GIN; logits [N, n_classes] per node, or [n_graphs, n_classes]
    pooled per graph when ``g`` has ``graph_ids``."""

    ARCH = "gin"
    KEYS = ("w1", "w2", "ln", "eps")

    def forward(self, g: dict) -> torch.Tensor:
        x = g["x"].to(self.cfg.dtype)
        nodes = self.node_blocks(x.shape[0])
        if nodes is not None:
            if "graph_ids" in g:
                raise ValueError("node-sharded graphs are not pooled")
            xb = nodes.block(x)
            for i, lp in enumerate(self.layers):
                xb = self._apply(self._gin_nodes_layer, xb, lp,
                                 g["edge_src"], g["edge_dst"], nodes,
                                 x if i == 0 else None)
            return xb.to(self.readout.dtype) @ self.readout
        for lp in self.layers:
            x = self._apply(self._gin_layer, x, lp, g["edge_src"],
                            g["edge_dst"])
        if "graph_ids" in g:
            x = pool_graphs(x, g["graph_ids"], g["n_graphs"])
        # the reference multiplies by the float32 readout: a float32 result
        return x.to(self.readout.dtype) @ self.readout

    def _gin_nodes_layer(self, xb, lp, src, dst, nodes, x_in=None):
        """A layer on this rank's block of nodes: the sums of every
        rank's edges reduce-scattered onto the blocks, the rows of the
        gather read from the blocks' all-gather (``x_in``: the first
        layer's whole input)."""
        w1, w2, ln, eps = self._layer(lp, self.KEYS)
        x = nodes.whole(xb) if x_in is None else x_in
        agg = nodes.scatter(gather_scatter(x, src, dst, nodes.n,
                                           reduce="sum",
                                           backend=self.backend))
        h = torch.relu(((1.0 + eps) * xb + agg) @ w1)
        return _norm_relu(h @ w2, ln)

    def _gin_layer(self, x, lp, src, dst):
        w1, w2, ln, eps = self._layer(lp, self.KEYS)
        agg = gather_scatter(x, src, dst, x.shape[0], reduce="sum",
                             backend=self.backend, group=self.group)
        h = (1.0 + eps) * x + agg
        h = torch.relu(h @ w1)
        return _norm_relu(h @ w2, ln)


# --------------------------------------------------------------------- #
# PNA
# --------------------------------------------------------------------- #
def pna_init(gen: torch.Generator, cfg: GNNConfig, *, device=None) -> dict:
    """Seeded PNA parameters in the reference's tree layout."""
    device = resolve_device(device)
    layers = []
    d = cfg.d_in
    n_mix = len(cfg.aggregators) * len(cfg.scalers)
    for _ in range(cfg.n_layers):
        layers.append({
            "pre": dense_init(gen, (2 * d, cfg.d_hidden), device=device),
            "post": dense_init(gen, (n_mix * cfg.d_hidden + d,
                                     cfg.d_hidden), device=device),
            "ln": torch.ones((cfg.d_hidden,), device=device),
        })
        d = cfg.d_hidden
    return {"layers": layers,
            "readout": dense_init(gen, (cfg.d_hidden, cfg.n_classes),
                                  device=device)}


class PNA(_GNN):
    """PNA: messages ``relu(concat(x[src], x[dst]) pre)``, the mean / max
    / min / std aggregators (sum and sum of squares through the
    segment_sum kernel, max and min plain ``scatter_reduce_``; a node
    without edges gets 0), each under the identity / amplification /
    attenuation scalers of ``log1p(deg)`` and ``delta``, then ``post``
    and the normalisation.  Logits [N, n_classes] in float32 (the
    reference's float32 readout).

    ``concat(x[src], x[dst])`` is one gather of [E, 2] row pairs, so no
    separate halves exist beside it (``gather_rows``; no sum reads a
    padding edge's message)."""

    ARCH = "pna"
    KEYS = ("pre", "post", "ln")

    def forward(self, g: dict) -> torch.Tensor:
        cfg = self.cfg
        x = g["x"].to(cfg.dtype)
        n = x.shape[0]
        src, dst = g["edge_src"], g["edge_dst"]
        e_ok = (src >= 0) & (dst >= 0)
        pair = torch.stack([src, dst], 1).view(-1)            # [2E]
        seg = torch.where(e_ok, dst, -1)
        deg = degrees(dst, n, group=self.group).to(cfg.dtype)
        nodes = self.node_blocks(n)
        if nodes is not None:
            deg = nodes.block(deg)
        cnt = torch.clamp(deg[:, None], min=1.0)
        logd = torch.log1p(deg)[:, None]
        for i, lp in enumerate(self.layers):
            if nodes is None:
                x = self._apply(self._pna_layer, x, lp, pair, seg, cnt,
                                logd)
            else:
                x = self._apply(self._pna_layer, nodes.block(x)
                                if i == 0 else x, lp, pair, seg, cnt,
                                logd, nodes, x if i == 0 else None)
        return x.to(self.readout.dtype) @ self.readout

    def _pna_layer(self, x, lp, pair, seg, cnt, logd, nodes=None,
                   x_in=None):
        """A layer; with ``nodes`` on this rank's block ``x`` of the nodes
        (the pairs' rows read from the blocks' all-gather, or ``x_in``,
        the first layer's whole input)."""
        cfg = self.cfg
        pre, post, ln = self._layer(lp, self.KEYS)
        xw = x if nodes is None else (nodes.whole(x) if x_in is None
                                      else x_in)
        n = xw.shape[0]
        msg = torch.relu(gather_rows(xw, pair, self.backend).view(
            pair.shape[0] // 2, -1) @ pre)                    # [E, H]
        del xw

        def total(m):        # the segment sums of every rank's edges
            if nodes is None:
                return edge_sum(seg, m, n, self.backend, group=self.group)
            return nodes.scatter(sr.segment_sum(seg, m, n, self.backend))

        m_mean = total(msg) / cnt
        aggs = []
        if "mean" in cfg.aggregators:
            aggs.append(m_mean)
        for red in ("max", "min"):
            if red in cfg.aggregators:
                ext = segment_extreme(seg, msg, n, red, group=self.group)
                aggs.append(ext if nodes is None else nodes.block(ext))
        if "std" in cfg.aggregators:
            sq = total(msg * msg)
            var = torch.clamp(sq / cnt - m_mean ** 2, min=0)
            aggs.append(torch.sqrt(var + 1e-6))
        del msg
        scaled = []
        for a in aggs:
            for sc in cfg.scalers:
                if sc == "identity":
                    scaled.append(a)
                elif sc == "amplification":
                    scaled.append(a * (logd / cfg.delta))
                elif sc == "attenuation":
                    scaled.append(
                        a * (cfg.delta / torch.clamp(logd, min=1e-3)))
        return _norm_relu(torch.cat(scaled + [x], -1) @ post, ln)


# --------------------------------------------------------------------- #
INITS = {"gat": gat_init, "gin": gin_init, "pna": pna_init}


def node_classification_loss(model: _GNN, g: dict):
    """Node-level cross entropy of ``model(g)``; with ``graph_ids`` present
    (batched small graphs), mean-pools node logits per graph and
    classifies graphs instead (except GIN, whose forward already pools
    through its readout).  ``label_mask`` (bool, optional) picks the
    nodes or graphs counted.  -> (ce, {"ce": ce})."""
    logits = model(g).float()
    if "graph_ids" in g and logits.shape[0] != g["labels"].shape[0]:
        pass  # GIN path: forward already pooled to graph level
    elif "graph_ids" in g:
        gid, ng = g["graph_ids"], g["n_graphs"]
        tot = pool_graphs(logits, gid, ng)
        cnt = pool_graphs(logits.new_ones((logits.shape[0], 1)), gid, ng)
        logits = tot / torch.clamp(cnt, min=1)
    labels = g["labels"] if "graph_ids" not in g else g["graph_labels"]
    mask = g.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    nodes = None if "graph_ids" in g else model.node_blocks(
        labels.shape[0])
    if nodes is not None:       # the logits are this rank's block
        labels = nodes.block(labels)
        mask = nodes.block(mask) & nodes.valid(mask.device)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    tot = torch.where(mask, lse - ll, 0).sum()
    cnt = mask.sum()
    if nodes is not None:       # over every rank's nodes
        tot = all_reduce(tot, nodes.group)
        cnt = all_reduce_(cnt.reshape(1).clone(), nodes.group)[0]
    ce = tot / torch.clamp(cnt, min=1)
    return ce, {"ce": ce}


def param_specs(params, axes):
    """GNN params are tiny: replicate everywhere."""
    return tree_map(lambda _: P(), params)
