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
it on its own parameters.  The reference's sharding specs
(``param_specs``) are JAX sharding and are not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

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
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
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
        return _forward(self.params(), batch, self.cfg, self.backend)


def _forward(params: dict, batch: dict, cfg: WideDeepConfig, backend: str):
    ids = batch["sparse_ids"].long()              # [B, F]
    b, f = ids.shape
    fld = torch.arange(f, device=ids.device)[None, :]
    emb = params["tables"][fld, ids]              # [B, F, D]
    h = torch.cat([emb.reshape(b, -1), batch["dense"]],
                  dim=-1).to(cfg.dtype)
    for lp in params["mlp"]:
        h = torch.relu(h.to(lp["w"].dtype) @ lp["w"] + lp["b"])
    deep_logit = (h @ params["head"])[:, 0]

    # wide: multi-hot bag sum over hashed cross ids
    wid = batch["wide_ids"]                       # [B, K], -1 padded
    bags = torch.arange(b, dtype=torch.int32,
                        device=wid.device).repeat_interleave(wid.shape[1])
    wide_logit = eb.embedding_bag(
        wid.reshape(-1), bags, params["wide"][:, None], b,
        backend=backend)[:, 0]
    return deep_logit + wide_logit + params["bias"]


def forward(params: dict, batch: dict, cfg: WideDeepConfig) -> torch.Tensor:
    """The reference's functional forward on a parameter tree (``init``
    or ``params_from_numpy``) -> logits [B]; the embedding_bag backend is
    ``cfg.backend`` resolved on the tree's device."""
    return _forward(params, batch, cfg,
                    resolve_backend(cfg.backend, params["wide"].device))


def bce_loss(model: WideDeep, batch: dict):
    logit = model(batch).float()
    y = batch["labels"].float()
    loss = torch.mean(torch.relu(logit) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))
    return loss, {"bce": loss}


def retrieval_score(user_vec, cand_table, top_k: int = 100):
    """user_vec [D], cand_table [N, D] -> the top-k (scores, indices),
    highest first: one matrix-vector product and a top-k."""
    scores = cand_table @ user_vec                # [N]
    return torch.topk(scores, top_k)
