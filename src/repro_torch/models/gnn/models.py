"""GIN, the port of the GIN half of ``repro.models.gnn.models``
(inference: the forward, node-level and pooled per graph).

Graphs are dicts of tensors:
  x [N, F] node features; edge_src/edge_dst int32 [E] (-1 = padding);
  optional graph_ids [N] (-1 = padding) with ``n_graphs`` (an int) for
  batched small graphs.

Message passing sums through the segment_sum kernel (``message.
gather_scatter``).  GAT, PNA, NequIP, the sampler and the training loss
wait for later slices (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.join import resolve_backend
from repro_torch.core.state import resolve_device
from repro_torch.models.common import dense_init, params_from_numpy  # noqa: F401
from repro_torch.models.gnn.message import gather_scatter


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    arch: str = "gin"
    n_layers: int = 2
    d_in: int = 16
    d_hidden: int = 8
    # the reference's fields after d_hidden (n_heads, aggregators, ...)
    # belong to GAT/PNA/NequIP, which are not ported: the rest is
    # keyword-only, so no positional config means another field here
    _: dataclasses.KW_ONLY
    n_classes: int = 7
    eps_learnable: bool = True
    backend: str | None = None     # segment_sum: None = device default
    dtype: torch.dtype = torch.float32


def gin_init(gen: torch.Generator, cfg: GNNConfig, *,
             device=None) -> dict:
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


class GIN(nn.Module):
    """GIN on ``device`` (None means the card).  ``params`` is a tree of
    tensors in the reference's layout (``gin_init`` or
    ``params_from_numpy``); without it the parameters come from a
    generator seeded with ``seed`` on the device."""

    KEYS = ("w1", "w2", "ln", "eps")

    def __init__(self, cfg: GNNConfig, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, device)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = gin_init(gen, cfg, device=device)
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(lp[k].to(device))
                              for k in self.KEYS})
            for lp in params["layers"])
        self.readout = nn.Parameter(params["readout"].to(device))

    def forward(self, g: dict) -> torch.Tensor:
        """Logits: [N, n_classes] per node, or [n_graphs, n_classes]
        pooled per graph when ``g`` has ``graph_ids``."""
        dt = self.cfg.dtype
        x = g["x"].to(dt)
        n = x.shape[0]
        for lp in self.layers:
            w1, w2, ln, eps = (lp[k].to(dt) for k in self.KEYS)
            agg = gather_scatter(x, g["edge_src"], g["edge_dst"], n,
                                 reduce="sum", backend=self.backend)
            h = (1.0 + eps) * x + agg
            h = torch.relu(h @ w1)
            h = h @ w2
            mu = h.mean(-1, keepdim=True)
            sd = torch.sqrt(torch.clamp(
                h.var(-1, keepdim=True, correction=0), min=1e-6))
            x = torch.relu(ln * (h - mu) / sd)
        if "graph_ids" in g:
            gid = g["graph_ids"]
            n_graphs = g["n_graphs"]
            seg = torch.where(gid < 0, n_graphs, gid).long()
            pooled = torch.zeros((n_graphs + 1, x.shape[1]), dtype=x.dtype,
                                 device=x.device)
            pooled.index_add_(0, seg, torch.where((gid >= 0)[:, None], x, 0))
            x = pooled[:n_graphs]
        # the reference multiplies by the float32 readout: a float32 result
        return x.to(self.readout.dtype) @ self.readout
