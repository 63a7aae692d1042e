"""NequIP-style E(3)-equivariant interatomic potential (l_max = 2): the
port of ``repro.models.gnn.nequip`` (inference: energy and forces).

Features live in Cartesian tensor form, as in the reference:

    l=0: scalars          [N, C]
    l=1: vectors          [N, C, 3]
    l=2: symmetric traceless matrices [N, C, 3, 3]

Message paths (feature x edge geometry -> output), each weighted per
channel by a radial MLP over a Bessel basis with a polynomial cutoff
envelope:
    s.1->s, s.Y1->v, s.Y2->t, v.Y1->s (dot), v.1->v, v.Y2->v (matvec),
    v.Y1->t (sym outer), t.1->t, t.Y1->v (matvec), t.Y2->s (double dot).

The three aggregations per layer (out_s [E, C], out_v [E, 3C], out_t
[E, 9C], flattened contiguously) go through the segment_sum kernel,
whose ``autograd.Function`` carries the forces' gradient back through it
(``energy_and_forces``).  The per-graph energy pooling is plain
``index_add_``.  ``params`` is a tree of tensors in the reference's
layout (``init`` or ``params_from_numpy``); ``NequIP`` holds one as an
``nn.Module``.  ``mse_loss`` is the training loss (energies only, so no
double backward); ``cfg.remat`` recomputes each interaction layer in the
backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import all_reduce
from repro_torch.core.join import resolve_backend
from repro_torch.core.state import resolve_device
from repro_torch.kernels.segment_reduce import ops as sr
from repro_torch.models.common import dense_init
from repro_torch.models.gnn.message import NodeBlocks, edge_sum, pool_graphs

PATHS = ("ss", "sv", "st", "vs", "vv", "vt_mat", "vt_outer", "tt", "tv", "ts")


def bessel_basis(r, n_rbf: int, cutoff: float):
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    b = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * r[:, None]
                                            / cutoff) / r[:, None]
    x = torch.clamp(r / cutoff, 0, 1)
    env = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5      # smooth C^2 cutoff
    return b * env[:, None]


def _sym_traceless(m):
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return s - tr * eye / 3.0


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    radial_hidden: int = 64
    mesh_axes: tuple | None = None   # shard node-dim tensors over these
    _: dataclasses.KW_ONLY
    backend: str | None = None     # segment_sum: None = device default
    remat: bool = False            # checkpoint each interaction layer
    # the process-group mesh whose ranks split the edge arrays (every
    # mesh axis, flat) and replicate the node arrays; None: one device
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


def init(gen: torch.Generator, cfg: NequIPConfig, *, device=None) -> dict:
    """Seeded parameters in the reference's tree layout, made on
    ``device`` from ``gen`` (a generator on that device)."""
    device = resolve_device(device)
    c = cfg.channels

    def dense(shape):
        return dense_init(gen, shape, device=device)

    layers = [{
        # radial MLP: basis -> per-(path, channel) weights
        "r1": dense((cfg.n_rbf, cfg.radial_hidden)),
        "r2": dense((cfg.radial_hidden, len(PATHS) * c)),
        # self-interaction channel mixers per l
        "w_s": dense((c, c)),
        "w_v": dense((c, c)),
        "w_t": dense((c, c)),
        # gate scalars: 2c extra scalars to gate v and t
        "w_gate": dense((c, 2 * c)),
        "ln_s": torch.ones((c,), device=device),
    } for _ in range(cfg.n_layers)]
    return {"embed": dense((cfg.n_species, c)), "layers": layers,
            "out1": dense((c, c)), "out2": dense((c, 1))}


def _messages(s, v, t, lp, edge_src, edge_dst, rvec, cfg, nodes=None):
    """Per-edge path outputs, summed into their destinations (with
    ``nodes``, the sums of every rank's edges on this rank's block of
    them)."""
    e_ok = (edge_src >= 0) & (edge_dst >= 0)
    si = edge_src.clamp(min=0).long()
    r = torch.linalg.norm(rvec, dim=-1)
    rhat = rvec / torch.clamp(r, min=1e-6)[:, None]
    y1 = rhat                                             # [E, 3]
    y2 = _sym_traceless(rhat[:, :, None] * rhat[:, None, :])  # [E, 3, 3]

    basis = bessel_basis(r, cfg.n_rbf, cfg.cutoff)
    w = F.silu(basis @ lp["r1"]) @ lp["r2"]               # [E, P*C]
    w = w.view(-1, len(PATHS), cfg.channels)
    w = torch.where(e_ok[:, None, None], w, 0)
    W = {p: w[:, i] for i, p in enumerate(PATHS)}         # each [E, C]

    se, ve, te = s[si], v[si], t[si]                      # gathered src feats

    out_s = (W["ss"] * se
             + W["vs"] * torch.einsum("eci,ei->ec", ve, y1)
             + W["ts"] * torch.einsum("ecij,eij->ec", te, y2))
    out_v = (W["sv"][..., None] * y1[:, None, :]
             + W["vv"][..., None] * ve
             + W["vt_mat"][..., None] * torch.einsum("ecij,ej->eci", te, y1)
             + W["tv"][..., None] * torch.einsum("eij,ecj->eci", y2, ve))
    outer = _sym_traceless(ve[..., :, None] * y1[:, None, None, :])
    out_t = (W["st"][..., None, None] * y2[:, None, :, :]
             + W["vt_outer"][..., None, None] * outer
             + W["tt"][..., None, None] * te)

    n = s.shape[0]
    seg = torch.where(e_ok, edge_dst, -1)

    group = None if cfg.mesh is None else cfg.mesh.group

    def agg(x):
        flat = x.reshape(x.shape[0], -1)                  # [E, C * 3^l]
        if nodes is not None:
            out = nodes.scatter(sr.segment_sum(seg, flat, n, cfg.backend))
        else:
            out = edge_sum(seg, flat, n, cfg.backend, group=group)
        return out.view((out.shape[0],) + x.shape[1:])

    return agg(out_s), agg(out_v), agg(out_t)


def forward(params: dict, g: dict, cfg: NequIPConfig):
    """g: species [N] int, pos [N, 3], edge_src/edge_dst [E], optional
    graph_ids/n_graphs.  Returns the per-graph energy [G] (a [1] total
    without graph_ids).  With ``cfg.mesh_axes`` on a process-group mesh
    the node features are this rank's block of the nodes (``message.
    NodeBlocks``) and the energies are summed over the ranks."""
    species = torch.clamp(g["species"], 0, cfg.n_species - 1).long()
    pos = g["pos"]
    n = species.shape[0]
    c = cfg.channels
    nodes = None
    if cfg.mesh is not None and cfg.mesh_axes is not None:
        nodes = NodeBlocks(n, cfg.mesh.axis_group(tuple(cfg.mesh_axes)))
        species = nodes.block(species)
    s = params["embed"][species]                          # [N, C]
    v = s.new_zeros((s.shape[0], c, 3))
    t = s.new_zeros((s.shape[0], c, 3, 3))

    src, dst = g["edge_src"], g["edge_dst"]
    e_ok = (src >= 0) & (dst >= 0)
    rvec = torch.where(e_ok[:, None],
                       pos[src.clamp(min=0).long()]
                       - pos[dst.clamp(min=0).long()], 1.0)

    def layer(s, v, t, lp):
        if nodes is None:
            ms, mv, mt = _messages(s, v, t, lp, src, dst, rvec, cfg)
        else:                  # every rank's rows, for the gathers
            ms, mv, mt = _messages(
                nodes.whole(s), nodes.whole(v), nodes.whole(t), lp, src,
                dst, rvec, cfg, nodes)
        # self-interaction + residual
        s_new = s + ms @ lp["w_s"]
        v_new = v + torch.einsum("nci,cd->ndi", mv, lp["w_v"])
        t_new = t + torch.einsum("ncij,cd->ndij", mt, lp["w_t"])
        # gate nonlinearity: scalars silu; v/t scaled by sigmoids
        gates = torch.sigmoid(s_new @ lp["w_gate"])        # [N, 2C]
        return (F.silu(s_new) * lp["ln_s"], v_new * gates[:, :c, None],
                t_new * gates[:, c:, None, None])

    for lp in params["layers"]:
        if cfg.remat:
            s, v, t = checkpoint(layer, s, v, t, lp, use_reentrant=False)
        else:
            s, v, t = layer(s, v, t, lp)

    e_node = F.silu(s @ params["out1"]) @ params["out2"]  # [N, 1]
    if nodes is not None:
        e_node = torch.where(nodes.valid(e_node.device)[:, None], e_node, 0)
        if "graph_ids" in g:
            return all_reduce(pool_graphs(e_node[:, 0], nodes.block(
                g["graph_ids"]), g["n_graphs"]), nodes.group)
        return all_reduce(e_node[:, 0].sum()[None], nodes.group)
    if "graph_ids" in g:
        return pool_graphs(e_node[:, 0], g["graph_ids"], g["n_graphs"])
    return e_node[:, 0].sum()[None]


def mse_loss(params: dict, g: dict, cfg: NequIPConfig):
    """Mean squared error of the per-graph energies against
    ``g["energy"]`` (0 where the batch has none) -> (mse, {"mse": mse})."""
    e = forward(params, g, cfg)
    target = g.get("energy")
    if target is None:
        target = torch.zeros_like(e)
    l = torch.mean((e - target) ** 2)
    return l, {"mse": l}


def energy_and_forces(params: dict, g: dict, cfg: NequIPConfig):
    """(total energy, a scalar; forces -dE/dpos [N, 3]).  The gradient
    flows back through the segment_sum kernel on the card."""
    pos = g["pos"].detach().requires_grad_(True)
    with torch.enable_grad():
        e = forward(params, {**g, "pos": pos}, cfg).sum()
        (grad,) = torch.autograd.grad(e, pos)
    return e.detach(), -grad


class NequIP(nn.Module):
    """NequIP on ``device`` (None means the card): ``params`` in the
    reference's layout (``init`` or ``params_from_numpy``), or drawn from
    a generator seeded with ``seed`` on the device.  ``forward(g)`` is
    the module-level ``forward``; ``energy_and_forces(g)`` the
    module-level one."""

    def __init__(self, cfg: NequIPConfig, *, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = dataclasses.replace(
            cfg, backend=resolve_backend(cfg.backend, device))
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init(gen, cfg, device=device)
        self.embed = nn.Parameter(params["embed"].to(device))
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(x.to(device))
                              for k, x in lp.items()})
            for lp in params["layers"])
        self.out1 = nn.Parameter(params["out1"].to(device))
        self.out2 = nn.Parameter(params["out2"].to(device))

    def params(self) -> dict:
        """The parameters as the reference's tree (the module's own
        tensors, not copies)."""
        return {"embed": self.embed,
                "layers": [dict(lp.items()) for lp in self.layers],
                "out1": self.out1, "out2": self.out2}

    def forward(self, g: dict) -> torch.Tensor:
        return forward(self.params(), g, self.cfg)

    def energy_and_forces(self, g: dict):
        return energy_and_forces(self.params(), g, self.cfg)
