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
(``f32_reductions``), as the reference's do.  ``param_specs`` and
``cache_specs`` are JAX sharding and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.state import resolve_device
from repro_torch.models.attention import attention_block
from repro_torch.models.common import dense_init, f32_reductions, rms_norm
from repro_torch.models.moe import moe_ffn
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


def _embed(params, tokens, cfg: LMConfig):
    # the gather, then the cast: the reference's cast-then-gather values
    return F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)


def _logits(params, x, cfg: LMConfig):
    x = rms_norm(x, params["final_norm"].to(cfg.dtype))
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    return x @ head


def _dense_ffn(x, p):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def _layer(x, lp, cfg: LMConfig, kv_cache=None, positions=None):
    h, new_cache = attention_block(
        rms_norm(x, lp["ln1"]), lp["attn"], cfg,
        positions=positions, kv_cache=kv_cache)
    x = x + h
    xin = rms_norm(x, lp["ln2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        b, s, d = xin.shape
        y, aux = moe_ffn(xin.reshape(b * s, d), lp["moe"], cfg)
        y = y.view(b, s, d)
        if cfg.dense_residual:
            y = y + _dense_ffn(xin, lp["ffn"])
    else:
        y = _dense_ffn(xin, lp["ffn"])
    return x + y, aux, new_cache


def _body(x, lp, cfg: LMConfig):
    y, aux, _ = _layer(x, _cast(lp, cfg.dtype), cfg)
    return y, aux


@f32_reductions
def forward(params, tokens, cfg: LMConfig):
    """tokens [B, S] -> (logits [B, S, V], aux loss).  Under
    ``remat="full"`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``) while autograd records; the outputs are
    the same.  The recompute reads the same per-layer views (no copy of
    a stack); it runs in the backward, outside this function's
    reduction scope, so a train step holds the scope around its
    backward too (``launch.cells.make_lm_train_step``)."""
    x = _embed(params, tokens, cfg)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    auxs = []
    for lp in _unbind_layers(params["layers"]):
        if remat:
            x, aux = checkpoint(_body, x, lp, cfg, use_reentrant=False)
        else:
            x, aux = _body(x, lp, cfg)
        auxs.append(aux)
    return _logits(params, x, cfg), torch.stack(auxs).sum()


def loss_fn(params, tokens, cfg: LMConfig):
    """Next-token cross entropy (+ router aux + z-loss) -> (loss,
    {"ce", "aux"})."""
    logits, aux = forward(params, tokens, cfg)
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (lse - ll).mean()
    zl = cfg.z_loss * torch.mean(lse ** 2)
    return ce + zl + aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------- #
# Decode path
# --------------------------------------------------------------------- #
@f32_reductions
def serve_step(params, tokens, cache, cfg: LMConfig):
    """One decode step.

    tokens [B, 1]; cache = (k [L, B, S, Hkv, hd], v [...], length [B]).
    The new K/V are written into ``k`` and ``v`` in place.  Returns
    (logits [B, V], (k, v, length + 1)).
    """
    kc, vc, length = cache
    x = _embed(params, tokens, cfg)
    positions = length[:, None]
    for l, lp in enumerate(_unbind_layers(params["layers"])):
        x, _, _ = _layer(x, _cast(lp, cfg.dtype), cfg,
                         kv_cache=(kc[l], vc[l], length),
                         positions=positions)
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    return logits, (kc, vc, length + tokens.shape[1])


@f32_reductions
def prefill(params, tokens, cfg: LMConfig):
    """Serving prefill: one forward pass that captures the post-RoPE KV
    cache of every layer and returns only the last position's logits.

    Returns (logits [B, V], k [L, B, S, Hkv, hd], v [L, B, S, Hkv, hd]).
    """
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    k_all, v_all = x.new_empty(shape), x.new_empty(shape)
    for l, lp in enumerate(_unbind_layers(params["layers"])):
        x, _, (k, v, _) = _layer(x, _cast(lp, cfg.dtype), cfg)
        k_all[l], v_all[l] = k, v
        del k, v
    logits = _logits(params, x[:, -1:], cfg)[:, 0]
    return logits, k_all, v_all


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
