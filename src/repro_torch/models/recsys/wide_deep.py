"""Wide & Deep (Cheng et al. 2016) for CTR prediction: the port of
``repro.models.recsys.wide_deep`` (forward, loss, retrieval).

Deep side: 40 sparse categorical fields -> 32-dim embeddings (one table
per field) concatenated with dense features -> MLP 1024-512-256 -> logit.
The per-field gather is plain indexing, as in the reference, and the MLP
is ``torch.matmul``.
Wide side: hashed cross features into one wide table -> summed logit,
through the embedding_bag kernel (multi-hot bags, D = 1), whose gradient
in the wide table runs on the segment_sum kernel.

Parameters keep the reference's tree layout (``tables`` [F, V, D],
``wide`` [V], ``mlp`` [{w, b}], ``head``, ``bias``), so the reference's
weights carry across with ``params_from_numpy``, and ``params()`` reads
them back in that layout.  ``forward(params, batch, cfg)`` is the
reference's functional form on such a tree; the module's forward runs
it on its own parameters.

Sharded (``axes``, a ``MeshAxes`` over a process-group mesh, laid out
as ``param_specs``): each rank holds its ``model``-block of every
table's rows and of the wide table, and its ``data``-block of the batch.
It looks up only the ids in its row block (the others read nothing: the
deep gather is masked, and the wide ids outside the block are -1, which
the embedding_bag kernel skips), shifted to its local rows; the partial
embeddings and wide sums are summed over ``model``.  The table
gradients are then the rank's own rows (the wide table's on the
segment_sum kernel, ``ops.EmbeddingBag``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.collectives import all_gather, all_reduce
from repro_torch.core.distributed import P
from repro_torch.core.join import resolve_backend
from repro_torch.core.state import resolve_device
from repro_torch.kernels.embedding_bag import ops as eb
from repro_torch.models.common import dense_init, params_from_numpy  # noqa: F401


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    vocab_per_field: int = 1_000_000
    embed_dim: int = 32
    n_dense: int = 13
    mlp: tuple = (1024, 512, 256)
    wide_vocab: int = 2_000_000
    n_wide_crosses: int = 16       # hashed cross features per example
    backend: str | None = None     # embedding_bag: None = device default
    dtype: torch.dtype = torch.float32


def init(gen: torch.Generator, cfg: WideDeepConfig, *,
         device=None) -> dict:
    """Seeded parameters in the reference's tree layout, made on
    ``device`` from ``gen`` (a generator on that device)."""
    device = resolve_device(device)
    tables = torch.randn((cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim),
                         generator=gen, device=device).mul_(0.01)
    wide = torch.randn((cfg.wide_vocab,), generator=gen,
                       device=device).mul_(0.01)
    params = {"tables": tables, "wide": wide, "mlp": []}
    d = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    for h in cfg.mlp:
        params["mlp"].append({"w": dense_init(gen, (d, h), device=device),
                              "b": torch.zeros((h,), device=device)})
        d = h
    params["head"] = dense_init(gen, (d, 1), device=device)
    params["bias"] = torch.zeros((), device=device)
    return params


class WideDeep(nn.Module):
    """Wide&Deep on ``device`` (None means the card).  ``params`` is a
    tree of tensors in the reference's layout (``init`` or
    ``params_from_numpy``); without it the parameters come from a
    generator seeded with ``seed`` on the device."""

    def __init__(self, cfg: WideDeepConfig, device=None, seed: int = 0,
                 params: dict | None = None, *, axes=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.axes = axes
        self.backend = resolve_backend(cfg.backend, device)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init(gen, cfg, device=device)
        self.tables = nn.Parameter(params["tables"].to(device))
        self.wide = nn.Parameter(params["wide"].to(device))
        self.mlp_w = nn.ParameterList(
            [nn.Parameter(lp["w"].to(device)) for lp in params["mlp"]])
        self.mlp_b = nn.ParameterList(
            [nn.Parameter(lp["b"].to(device)) for lp in params["mlp"]])
        self.head = nn.Parameter(params["head"].to(device))
        self.bias = nn.Parameter(params["bias"].to(device))

    def params(self) -> dict:
        """The parameters as the reference's tree (the module's own
        tensors, not copies)."""
        return {"tables": self.tables, "wide": self.wide,
                "mlp": [{"w": w, "b": b}
                        for w, b in zip(self.mlp_w, self.mlp_b)],
                "head": self.head, "bias": self.bias}

    def forward(self, batch: dict) -> torch.Tensor:
        """batch: sparse_ids int32 [B, F], dense [B, n_dense], wide_ids
        int32 [B, n_crosses] (-1 padded multi-hot bags) -> logits [B]."""
        return _forward(self.params(), batch, self.cfg, self.backend,
                        self.axes)


def _row_block(ids, n_rows: int, axes):
    """Ids of a table whose rows are split over ``axes.tp`` as this
    rank's local rows, and whether each is in its block."""
    local = ids - axes.index("tp") * n_rows
    return local, (local >= 0) & (local < n_rows)


def _forward(params: dict, batch: dict, cfg: WideDeepConfig, backend: str,
             axes=None):
    sharded = axes is not None and axes.sharded()
    ids = batch["sparse_ids"].long()              # [B, F]
    b, f = ids.shape
    fld = torch.arange(f, device=ids.device)[None, :]
    if sharded:
        rows, mine = _row_block(ids, params["tables"].shape[1], axes)
        emb = params["tables"][fld, rows.clamp(0, params["tables"].shape[1]
                                               - 1)]
        emb = all_reduce(torch.where(mine[..., None], emb, 0),
                         axes.group("tp"))
    else:
        emb = params["tables"][fld, ids]          # [B, F, D]
    h = torch.cat([emb.reshape(b, -1), batch["dense"]],
                  dim=-1).to(cfg.dtype)
    for lp in params["mlp"]:
        h = torch.relu(h.to(lp["w"].dtype) @ lp["w"] + lp["b"])
    deep_logit = (h @ params["head"])[:, 0]

    # wide: multi-hot bag sum over hashed cross ids
    wid = batch["wide_ids"]                       # [B, K], -1 padded
    if sharded:
        local, mine = _row_block(wid, params["wide"].shape[0], axes)
        wid = torch.where(mine & (wid >= 0), local, -1).to(wid.dtype)
    bags = torch.arange(b, dtype=torch.int32,
                        device=wid.device).repeat_interleave(wid.shape[1])
    wide_logit = eb.embedding_bag(
        wid.reshape(-1), bags, params["wide"][:, None], b,
        backend=backend)[:, 0]
    if sharded:
        wide_logit = all_reduce(wide_logit, axes.group("tp"))
    return deep_logit + wide_logit + params["bias"]


def forward(params: dict, batch: dict, cfg: WideDeepConfig, *,
            axes=None) -> torch.Tensor:
    """The reference's functional forward on a parameter tree (``init``
    or ``params_from_numpy``) -> logits [B]; the embedding_bag backend is
    ``cfg.backend`` resolved on the tree's device.  With ``axes`` (a
    process-group mesh's) the tree and the batch are this rank's blocks
    and so are the logits (``P(dp)``)."""
    return _forward(params, batch, cfg,
                    resolve_backend(cfg.backend, params["wide"].device),
                    axes)


def bce_loss(model: WideDeep, batch: dict):
    """Mean binary cross entropy of ``model(batch)``; sharded, the mean
    over the global batch (every rank holds it)."""
    logit = model(batch).float()
    y = batch["labels"].float()
    loss = torch.mean(torch.relu(logit) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))
    axes = model.axes
    if axes is not None and axes.sharded():
        loss = all_reduce(loss, axes.group("dp")) / axes.dp_size
    return loss, {"bce": loss}


def param_specs(cfg: WideDeepConfig, axes):
    tp = axes.tp
    return {
        "tables": P(None, tp, None),   # row-shard each field's vocab
        "wide": P(tp),
        "mlp": [{"w": P(), "b": P()} for _ in cfg.mlp],
        "head": P(),
        "bias": P(),
    }


def retrieval_score(user_vec, cand_table, top_k: int = 100, *,
                    axes=None):
    """user_vec [D], cand_table [N, D] -> the top-k (scores, indices),
    highest first: one matrix-vector product and a top-k.

    With ``axes`` (a process-group mesh's) ``cand_table`` is this rank's
    block of the candidates, split over every mesh axis: a local top-k,
    its indices made global, gathered from every rank and merged by a
    second top-k; every rank returns the whole result.  Tied scores may
    come in another order than one device's (``torch.topk``'s)."""
    scores = cand_table @ user_vec                # [N]
    if axes is None or not axes.sharded():
        return torch.topk(scores, top_k)
    mesh = axes.mesh
    val, idx = torch.topk(scores, min(top_k, scores.shape[0]))
    idx = idx + mesh.axis_index(mesh.axis_names) * scores.shape[0]
    group = mesh.axis_group(mesh.axis_names)
    val, idx = all_gather(val, 0, group), all_gather(idx, 0, group)
    top, at = torch.topk(val, top_k)
    return top, idx[at]
