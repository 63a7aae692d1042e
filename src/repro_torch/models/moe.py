"""Mixture-of-Experts FFN: top-k routing with static-shape capacity
dispatch (the port of ``repro.models.moe``).

The reference splits the tokens into G groups, G the JAX mesh's
data-parallel degree, so that each group's dispatch stays on one shard.
The port runs on one device: one group (G = 1), with the reference's
capacity, sort, rank-within-expert and sentinel row:

  1. route: softmax gates in float32, top-k, renormalised;
  2. a stable sort of the (token, choice) pairs by expert; a pair's rank
     within its expert is its position past the expert's first
     (``searchsorted``); ranks at or past the capacity are dropped into
     the sentinel row ``e * cap``;
  3. the expert buffers [E, cap, d] go through the experts as batched
     products ([E, cap, d] x [E, d, f]);
  4. each pair's output, weighted by its gate, is summed back into token
     order.

Aux losses: Switch load balance and router z-loss.  The reference's
``axes`` (JAX sharding) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import f32_reductions


def _dispatch_group(xl, p, cfg, cap: int):
    """Route one token group. xl: [Tg, d] -> (xe [E, cap, d], (slot, st,
    sw), lb, z)."""
    tg, d = xl.shape
    e, k = cfg.n_experts, cfg.moe_topk
    dev = xl.device

    logits = (xl @ p["wg"]).float()
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, k, dim=-1)         # [Tg, k]
    if cfg.moe_renorm:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(-1)                          # [Tg*k]
    flat_t = torch.arange(tg, device=dev).repeat_interleave(k)
    flat_w = topw.reshape(-1)

    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(tg * k, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)  # sentinel = dropped

    # every dropped pair writes the sentinel row, which is discarded
    xe = xl.new_zeros((e * cap + 1, d))
    xe[slot] = xl[st]
    xe = xe[:-1].view(e, cap, d)

    # aux-loss statistics
    me = gates.mean(dim=0)
    # each expert's share of the assignments: a scatter of ones gives
    # bincount's integers on every device, the meta device included
    # (bincount has no meta kernel)
    cnt = torch.zeros(e, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = cnt.float() / (tg * k)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return xe, (slot, st, sw), lb, z


def _combine_group(y, route, tg: int, cap: int, cfg):
    slot, st, sw = route
    e = cfg.n_experts
    d = y.shape[-1]
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))], dim=0)
    contrib = y_flat[slot] * sw[:, None].to(y.dtype)
    return y.new_zeros((tg, d)).index_add_(0, st, contrib)


def _capacity(cfg, t: int) -> int:
    """Expert capacity for ``t`` tokens in one group (the reference's
    rule)."""
    cap = int(cfg.capacity_factor * cfg.moe_topk * t / cfg.n_experts)
    return max(4, min(cap, t * cfg.moe_topk))


@f32_reductions
def moe_ffn(x, p, cfg):
    """x: [T, d] tokens; returns ([T, d], aux_loss scalar)."""
    t, d = x.shape
    cap = _capacity(cfg, t)
    xe, route, lb, z = _dispatch_group(x, p, cfg, cap)

    h = torch.matmul(xe, p["w1"])                      # [E, cap, f]
    if "w3" in p:
        h = F.silu(h) * torch.matmul(xe, p["w3"])
    else:
        h = F.silu(h)
    del xe
    y = torch.matmul(h, p["w2"])                       # [E, cap, d]
    del h
    out = _combine_group(y, route, t, cap, cfg)
    aux = cfg.moe_lb_coef * lb + cfg.moe_z_coef * z
    return out.to(x.dtype), aux
