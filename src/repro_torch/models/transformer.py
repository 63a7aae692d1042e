"""Decoder-only LM family, dense and MoE: GQA + RoPE (+ qk-norm), SwiGLU,
a loop over stacked layers with optional remat (the port of
``repro.models.transformer``).

Covers the five LM architectures of the registry (deepseek-coder-33b,
qwen3-14b, internlm2-20b, arctic-480b, grok-1-314b) through one config
dataclass.  The functions keep the reference's functional form on its
parameter tree: ``forward(params, tokens, cfg)``, ``loss_fn``,
``prefill`` and ``serve_step``.  The tree holds ``embed``,
``final_norm``, ``lm_head`` and ``layers``, a dict of ``[L, ...]``
stacked leaves (as ``jax.vmap(_init_layer)`` makes them).  Each stacked
leaf is unbound once per call into per-layer views (so its gradient is
stacked once in the backward), and a layer casts its views to
``cfg.dtype``, as the reference casts every parameter before use.  So
parameters stored in ``cfg.dtype`` compute exactly what float32 masters
compute.  ``LM`` holds such a tree as an ``nn.Module``.

``serve_step`` writes the new K/V into the caller's cache tensors in
place (the reference's scan returns new stacked caches) and returns them
with ``length + S``.  On the card, bfloat16 products reduce in float32
(``f32_reductions``), as the reference's do.

Sharded (``axes``, a ``MeshAxes`` over a process-group mesh): every leaf
is the rank's block under ``param_specs`` (FSDP over the data axes × TP
over ``model``).  Training and prefill take the tokens' data block; each
layer's blocks are cast to ``cfg.dtype`` and gathered over the FSDP axes
inside the layer (inside its recompute under remat, so a layer's whole
weights live only while it runs; their gradient is a reduce-scatter
back onto the blocks), and run tensor-parallel over ``model``: the query
heads in padded groups, the FFN's d_ff and the experts (``attention``,
``moe``); the vocabulary of ``lm_head`` too, so the logits are the
rank's ``P(dp, None, tp)`` block and the loss a vocabulary-parallel
cross entropy.  ``loss_fn`` returns the global loss on every rank.
Decode (``serve_step(..., axes=)``) is weight-stationary, the
reference's serving rule: every weight stays in its stored block and
only the per-token activations move.  Each product is the rank's FSDP
block of the (replicated) activations times its weight block, float32
partial sums summed over the contracted dim's axes and cast once; its
``model`` column blocks are gathered where the next step needs them
whole, and the rank reads its block of the cache (``cache_specs``, or
the positions over every axis for a batch smaller than the data axes:
the cells' serving rule).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import all_gather, all_reduce
from repro_torch.core.distributed import P
from repro_torch.core.state import resolve_device
from repro_torch.models.attention import attention_block, \
    stationary_attention
from repro_torch.models.common import (
    constrain,
    dense_init,
    f32_reductions,
    partial_product,
    rms_norm,
)
from repro_torch.models.moe import moe_ffn, stationary_moe
from repro_torch.optim.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    vocab: int = 1024
    # MoE
    moe: bool = False
    n_experts: int = 8
    moe_topk: int = 2
    moe_renorm: bool = True
    capacity_factor: float = 1.25
    dense_residual: bool = False     # Arctic: dense FFN in parallel with MoE
    residual_d_ff: int = 0           # width of that dense branch
    moe_lb_coef: float = 0.01
    moe_z_coef: float = 1e-3
    expert_shard: str = "expert"     # 'expert' | 'ffn' (TP axis placement)
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_chunk: int = 1024
    attn_window: int | None = None   # sliding-window attention
    # numerics / memory
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: str = "full"              # 'full' | 'none'
    z_loss: float = 1e-4
    tie_embeddings: bool = False

    @property
    def kv_cache_shape(self):
        return (self.n_layers, None, None, self.n_kv_heads, self.head_dim)


# --------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------- #
def init(gen: torch.Generator, cfg: LMConfig, *, device=None) -> dict:
    """Seeded parameters in the reference's tree layout, each layer leaf
    stacked over ``[L, ...]``, drawn in ``cfg.param_dtype`` on ``device``
    from ``gen`` (a generator on that device)."""
    device = resolve_device(device)
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    L, pd = cfg.n_layers, cfg.param_dtype

    def dense(shape, in_axis: int = 0, stacked: bool = True):
        if stacked:
            shape, in_axis = (L,) + tuple(shape), in_axis + 1
        return dense_init(gen, shape, in_axis, pd, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    embed = dense((cfg.vocab, d), 1, stacked=False)
    head = None if cfg.tie_embeddings else dense((d, cfg.vocab), 0,
                                                 stacked=False)
    layers = {
        "ln1": ones((L, d)),
        "ln2": ones((L, d)),
        "attn": {
            "wq": dense((d, hq * hd)),
            "wk": dense((d, hkv * hd)),
            "wv": dense((d, hkv * hd)),
            "wo": dense((hq * hd, d)).div_((2 * L) ** 0.5),
        },
    }
    if cfg.qk_norm:
        layers["attn"]["q_norm"] = ones((L, hd))
        layers["attn"]["k_norm"] = ones((L, hd))
    if cfg.moe:
        layers["moe"] = {
            "wg": dense((d, cfg.n_experts)),
            "w1": dense((cfg.n_experts, d, f), 1),
            "w3": dense((cfg.n_experts, d, f), 1),
            "w2": dense((cfg.n_experts, f, d), 1),
        }
    if not cfg.moe or cfg.dense_residual:
        rf = (cfg.residual_d_ff or f) if cfg.moe else f
        layers["ffn"] = {"w1": dense((d, rf)), "w3": dense((d, rf)),
                         "w2": dense((rf, d))}
    params = {"embed": embed, "final_norm": ones((d,)), "layers": layers}
    if head is not None:
        params["lm_head"] = head
    return params


# --------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------- #
def _unbind_layers(layers: dict) -> list:
    """The ``[L, ...]`` stacked leaves as L trees of per-layer views, each
    leaf unbound once: its gradient is then one ``stack`` in the
    backward, where indexing ``v[l]`` layer by layer would add a
    zero-filled ``[L, ...]`` tensor into it once per layer."""
    views = [v.unbind(0) for v in flatten(layers)]
    return [unflatten(layers, [u[l] for u in views])
            for l in range(len(views[0]))]


def _cast(lp: dict, dtype) -> dict:
    """A layer's views cast to ``dtype`` (no copy where a leaf is already
    in it)."""
    return tree_map(lambda v: v.to(dtype), lp)


def _sharded(axes) -> bool:
    return axes is not None and axes.sharded()


def _gathered(x, spec, axes, keep_tp: bool):
    """A leaf's block gathered over the mesh axes its ``spec`` entries
    name: every entry, or all but ``tp``'s when ``keep_tp``."""
    for d, entry in enumerate(spec.parts):
        if entry is None or (keep_tp and entry == (axes.tp,)):
            continue
        x = all_gather(x, d, axes.mesh.axis_group(entry))
    return x


def _layer_weights(lp, cfg: LMConfig, axes):
    """A layer's per-layer blocks cast to ``cfg.dtype`` and gathered for
    the rank's training or prefill compute: over the FSDP axes, and over
    ``model`` too for ``wk``/``wv`` and for the attention weights when
    the heads do not split over ``model`` (the rank then slices its
    heads' out)."""
    lp = _cast(lp, cfg.dtype)
    if not _sharded(axes):
        return lp
    specs = param_specs(cfg, axes)["layers"]
    heads_tp = cfg.n_heads % axes.tp_size == 0

    def one(path, x, spec):
        keep = path not in ("attn.wk", "attn.wv") and (
            heads_tp or path not in ("attn.wq", "attn.wo"))
        return _gathered(x, P(*spec.parts[1:]), axes, keep)

    return {k: (one(k, v, specs[k]) if not isinstance(v, dict) else
                {n: one(f"{k}.{n}", x, specs[k][n]) for n, x in v.items()})
            for k, v in lp.items()}


def _embed(params, tokens, cfg: LMConfig, axes=None):
    # the gather, then the cast: the reference's cast-then-gather values
    if not _sharded(axes):
        return F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    # the table's d is split over the FSDP axes: gather whichever is
    # smaller, the table's column blocks, or every FSDP rank's tokens'
    # rows of this rank's columns (then the rows' column blocks)
    group, b = axes.group("fsdp"), tokens.shape[0]
    if tokens.numel() * axes.mesh.axis_size(axes.fsdp) >= cfg.vocab:
        table = all_gather(params["embed"].to(cfg.dtype), 1, group)
        return F.embedding(tokens.long(), table)
    part = F.embedding(all_gather(tokens, 0, group).long(),
                       params["embed"]).to(cfg.dtype)
    rows = all_gather(part, part.dim() - 1, group)
    i = axes.index("fsdp")
    return rows[i * b:(i + 1) * b]


def _head(params, cfg: LMConfig, axes=None):
    """The output projection [d, V]: sharded, the rank's vocabulary
    block gathered over the FSDP axes (tied: the whole table's)."""
    if cfg.tie_embeddings:
        head = params["embed"].to(cfg.dtype)
        if _sharded(axes):
            head = all_gather(head, 1, axes.group("fsdp"))
        return head.T
    head = params["lm_head"].to(cfg.dtype)
    if _sharded(axes):
        head = all_gather(head, 0, axes.group("fsdp"))
    return head


def _logits(params, x, cfg: LMConfig, axes=None):
    """Sharded, the rank's vocabulary block of the logits."""
    x = rms_norm(x, params["final_norm"].to(cfg.dtype))
    logits = x @ _head(params, cfg, axes)
    if not _sharded(axes) or not cfg.tie_embeddings:
        return logits
    v_l = cfg.vocab // axes.tp_size     # the rank's vocabulary block
    return logits[..., axes.index("tp") * v_l:][..., :v_l]


def _dense_ffn(x, p):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def _split_ffn(x, p, axes, d_ff: int):
    """``_dense_ffn``; sharded with ``w1`` narrower than ``d_ff`` (the
    rank's ``model`` block of d_ff), its partial sums summed over it."""
    y = _dense_ffn(x, p)
    if _sharded(axes) and p["w1"].shape[-1] < d_ff:
        y = all_reduce(y, axes.group("tp"))
    return y


def _layer(x, lp, cfg: LMConfig, kv_cache=None, positions=None, axes=None):
    h, new_cache = attention_block(
        rms_norm(x, lp["ln1"]), lp["attn"], cfg,
        positions=positions, kv_cache=kv_cache, axes=axes)
    x = x + h
    xin = rms_norm(x, lp["ln2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        b, s, d = xin.shape
        y, aux = moe_ffn(xin.reshape(b * s, d), lp["moe"], cfg, axes=axes)
        y = y.view(b, s, d)
        if cfg.dense_residual:
            y = y + _split_ffn(xin, lp["ffn"], axes,
                               cfg.residual_d_ff or cfg.d_ff)
    else:
        y = _split_ffn(xin, lp["ffn"], axes, cfg.d_ff)
    return x + y, aux, new_cache


def _body(x, lp, cfg: LMConfig, axes=None):
    y, aux, _ = _layer(x, _layer_weights(lp, cfg, axes), cfg, axes=axes)
    y = constrain(y, axes, "dp", None, None)
    return y, aux


@f32_reductions
def forward(params, tokens, cfg: LMConfig, axes=None):
    """tokens [B, S] -> (logits [B, S, V], aux loss).  Under
    ``remat="full"`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``) while autograd records; the outputs are
    the same.  The recompute reads the same per-layer views (no copy of
    a stack); it runs in the backward, outside this function's
    reduction scope, so a train step holds the scope around its
    backward too (``launch.cells.make_lm_train_step``).

    ``axes`` over a process-group mesh: ``params`` and ``tokens`` are the
    rank's blocks; the logits are its ``P(dp, None, tp)`` block and the
    aux loss its token group's."""
    x = _embed(params, tokens, cfg, axes)
    x = constrain(x, axes, "dp", None, None)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    auxs = []
    for lp in _unbind_layers(params["layers"]):
        if remat:
            x, aux = checkpoint(_body, x, lp, cfg, axes,
                                use_reentrant=False)
        else:
            x, aux = _body(x, lp, cfg, axes)
        auxs.append(aux)
    logits = constrain(_logits(params, x, cfg, axes), axes, "dp", None, "tp")
    return logits, torch.stack(auxs).sum()


def _vocab_ce(logits, targets, axes):
    """(lse, target logit) of float32 ``logits`` [..., V_local], the
    rank's block of the vocabulary over ``model``."""
    group = axes.group("tp")
    v_l = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), group, "max")
    lse = torch.log(all_reduce(torch.exp(logits - m[..., None]).sum(-1),
                               group)) + m
    local = targets - axes.index("tp") * v_l
    mine = (local >= 0) & (local < v_l)
    ll = torch.gather(logits, -1, local.clamp(0, v_l - 1)[..., None])[..., 0]
    return lse, all_reduce(torch.where(mine, ll, 0), group)


def loss_fn(params, tokens, cfg: LMConfig, axes=None):
    """Next-token cross entropy (+ router aux + z-loss) -> (loss,
    {"ce", "aux"}).  Sharded, every rank returns the global values (the
    means over the data blocks)."""
    logits, aux = forward(params, tokens, cfg, axes)
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    if _sharded(axes):
        lse, ll = _vocab_ce(logits, targets, axes)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (lse - ll).mean()
    zl = cfg.z_loss * torch.mean(lse ** 2)
    loss = ce + zl + aux
    if _sharded(axes):
        dp = axes.group("dp")
        loss, ce, aux = (all_reduce(v, dp) / axes.dp_size
                         for v in (loss, ce, aux))
    return loss, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------- #
# Decode path
# --------------------------------------------------------------------- #
@f32_reductions
def serve_step(params, tokens, cache, cfg: LMConfig, *, axes=None):
    """One decode step.

    tokens [B, 1]; cache = (k [L, B, S, Hkv, hd], v [...], length [B]).
    The new K/V are written into ``k`` and ``v`` in place.  Returns
    (logits [B, V], (k, v, length + 1)).

    ``axes`` over a process-group mesh (a port keyword: the reference's
    partitioner reads the shardings): ``params`` and the cache are the
    rank's blocks, which stay where they are (see the module docstring);
    tokens, length and logits are whole on every rank.
    """
    kc, vc, length = cache
    if _sharded(axes):
        return _stationary_step(params, tokens, cache, cfg, axes)
    x = _embed(params, tokens, cfg)
    positions = length[:, None]
    for l, lp in enumerate(_unbind_layers(params["layers"])):
        x, _, _ = _layer(x, _cast(lp, cfg.dtype), cfg,
                         kv_cache=(kc[l], vc[l], length),
                         positions=positions)
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    return logits, (kc, vc, length + tokens.shape[1])


def _stationary_ffn(x, p, cfg: LMConfig, axes):
    """The dense FFN of a decode step on the rank's blocks (``w1``/``w3``
    ``[d/fsdp, d_ff/tp]``, ``w2`` ``[d_ff/tp, d/fsdp]``): its d_ff block
    never leaves it.  ``x`` [..., d] the same on every rank; so is the
    result."""
    xb = axes.block(x, "fsdp")
    a = torch.cat([partial_product(xb, p["w1"]),
                   partial_product(xb, p["w3"])], -1)
    a1, a3 = all_reduce(a, axes.group("fsdp")).to(x.dtype).chunk(2, -1)
    y = partial_product(F.silu(a1) * a3, p["w2"])
    y = all_reduce(y, axes.group("tp")).to(x.dtype)
    return all_gather(y, -1, axes.group("fsdp"))


def _stationary_logits(params, x, cfg: LMConfig, axes):
    """The whole logits [B, s, V] on every rank from the head's blocks:
    ``lm_head`` ``[d/fsdp, V/tp]`` gives the rank's vocabulary block,
    gathered over ``model``; the tied head is the embedding table's
    ``[V, d/fsdp]`` block."""
    x = rms_norm(x, params["final_norm"].to(cfg.dtype))
    xb = axes.block(x, "fsdp")
    head = params["embed"].to(cfg.dtype).T if cfg.tie_embeddings \
        else params["lm_head"].to(cfg.dtype)
    logits = all_reduce(partial_product(xb, head),
                        axes.group("fsdp")).to(cfg.dtype)
    if cfg.tie_embeddings:
        return logits
    return all_gather(logits, -1, axes.group("tp"))


def _stationary_step(params, tokens, cache, cfg: LMConfig, axes):
    """``serve_step`` on a process-group mesh: each layer's products on
    the rank's stored blocks (``stationary_attention``,
    ``_stationary_ffn``, ``stationary_moe``), the activations gathered
    or summed between them."""
    kc, vc, length = cache
    b, s = tokens.shape
    # the rank's column block of the tokens' rows, then every block
    x = all_gather(F.embedding(tokens.long(), params["embed"]).to(cfg.dtype),
                   -1, axes.group("fsdp"))
    positions = length[:, None]
    for l, lp in enumerate(_unbind_layers(params["layers"])):
        lp = _cast(lp, cfg.dtype)
        x = x + stationary_attention(rms_norm(x, lp["ln1"]), lp["attn"],
                                     cfg, (kc[l], vc[l], length),
                                     positions, axes)
        xin = rms_norm(x, lp["ln2"])
        if cfg.moe:
            y = stationary_moe(xin.reshape(b * s, -1), lp["moe"], cfg,
                               axes).view(xin.shape)
            if cfg.dense_residual:
                y = y + _stationary_ffn(xin, lp["ffn"], cfg, axes)
        else:
            y = _stationary_ffn(xin, lp["ffn"], cfg, axes)
        x = x + y
    logits = _stationary_logits(params, x[:, -1:], cfg, axes)[:, 0]
    return logits, (kc, vc, length + s)


@f32_reductions
def prefill(params, tokens, cfg: LMConfig, axes=None):
    """Serving prefill: one forward pass that captures the post-RoPE KV
    cache of every layer and returns only the last position's logits.

    Returns (logits [B, V], k [L, B, S, Hkv, hd], v [L, B, S, Hkv, hd]).
    Sharded, the rank's blocks: logits ``P(dp, tp)``, the caches
    ``P(None, dp, tp, None, None)`` (its positions' block).
    """
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, axes)
    x = constrain(x, axes, "dp", None, None)
    s_l, s0 = s, 0
    if _sharded(axes):
        s_l = s // axes.tp_size
        s0 = axes.index("tp") * s_l
    shape = (cfg.n_layers, b, s_l, cfg.n_kv_heads, cfg.head_dim)
    k_all, v_all = x.new_empty(shape), x.new_empty(shape)
    for l, lp in enumerate(_unbind_layers(params["layers"])):
        x, _, (k, v, _) = _layer(x, _layer_weights(lp, cfg, axes), cfg,
                                 axes=axes)
        x = constrain(x, axes, "dp", None, None)
        k_all[l], v_all[l] = k[:, s0:s0 + s_l], v[:, s0:s0 + s_l]
        del k, v
    logits = _logits(params, x[:, -1:], cfg, axes)[:, 0]
    return logits, k_all, v_all


# --------------------------------------------------------------------- #
# Sharding specs
# --------------------------------------------------------------------- #
def param_specs(cfg: LMConfig, axes) -> Any:
    """PartitionSpec tree matching init()'s structure.

    fsdp = axes.fsdp (ZeRO-3 over data axes), tp = axes.tp.
    Layer-stacked params get a leading None for the layer dim.
    """
    fsdp, tp = axes.fsdp, axes.tp

    def L(*s):  # layer-stacked
        return P(None, *s)

    attn = {
        "wq": L(fsdp, tp),           # heads flattened: [d, Hq*hd]
        "wk": L(fsdp, tp),           # [d, Hkv*hd]
        "wv": L(fsdp, tp),
        "wo": L(tp, fsdp),
    }
    if cfg.qk_norm:
        attn["q_norm"] = L(None)
        attn["k_norm"] = L(None)
    layer = {"ln1": L(None), "ln2": L(None), "attn": attn}
    dense_ffn = {"w1": L(fsdp, tp), "w3": L(fsdp, tp), "w2": L(tp, fsdp)}
    if cfg.moe:
        if cfg.expert_shard == "expert":
            layer["moe"] = {
                "wg": L(fsdp, None),
                "w1": L(tp, fsdp, None),
                "w3": L(tp, fsdp, None),
                "w2": L(tp, None, fsdp),
            }
        else:  # shard the ffn dim (few-expert models: grok)
            layer["moe"] = {
                "wg": L(fsdp, None),
                "w1": L(None, fsdp, tp),
                "w3": L(None, fsdp, tp),
                "w2": L(None, tp, fsdp),
            }
        if cfg.dense_residual:
            layer["ffn"] = dense_ffn
    else:
        layer["ffn"] = dense_ffn
    specs = {
        # vocab replicated over tp: the token gather stays local; the d
        # axis is FSDP-sharded so the table still scales
        "embed": P(None, fsdp),
        "final_norm": P(None),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fsdp, tp)
    return specs


def cache_specs(cfg: LMConfig, axes):
    """KV cache (k, v, length): batch over dp, seq over tp (flash-decode)."""
    dp, tp = axes.dp, axes.tp
    kv = P(None, dp, tp, None, None)
    return (kv, kv, P(dp))


# --------------------------------------------------------------------- #
# Module
# --------------------------------------------------------------------- #
class LM(nn.Module):
    """A decoder LM on ``device`` (None means the card): ``params`` in
    the reference's layout (``init`` or ``params_from_numpy``), or drawn
    from a generator seeded with ``seed`` on the device.  ``forward``,
    ``prefill`` and ``serve_step`` are the module-level functions on
    ``params()``."""

    def __init__(self, cfg: LMConfig, *, device=None, seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init(gen, cfg, device=device)
        for k in ("embed", "final_norm", "lm_head"):
            if k in params:
                setattr(self, k, nn.Parameter(params[k].to(device)))
        layers = params["layers"]
        self.layer_norms = nn.ParameterDict(
            {k: nn.Parameter(layers[k].to(device)) for k in ("ln1", "ln2")})
        self.layer_blocks = nn.ModuleDict(
            {k: nn.ParameterDict({n: nn.Parameter(x.to(device))
                                  for n, x in layers[k].items()})
             for k in ("attn", "moe", "ffn") if k in layers})

    def params(self) -> dict:
        """The parameters as the reference's tree (the module's own
        tensors, not copies)."""
        layers = dict(self.layer_norms.items())
        for k, blk in self.layer_blocks.items():
            layers[k] = dict(blk.items())
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "layers": layers}
        if hasattr(self, "lm_head"):
            tree["lm_head"] = self.lm_head
        return tree

    def forward(self, tokens):
        return forward(self.params(), tokens, self.cfg)

    def prefill(self, tokens):
        return prefill(self.params(), tokens, self.cfg)

    def serve_step(self, tokens, cache):
        return serve_step(self.params(), tokens, cache, self.cfg)
