"""Mixture-of-Experts FFN: top-k routing with static-shape capacity
dispatch (the port of ``repro.models.moe``).

The tokens split into G groups, G the mesh's data-parallel degree
(``axes.dp_size``; 1 without ``axes``), so that each group's dispatch
stays on one shard; each group is routed with the reference's capacity,
sort, rank-within-expert and sentinel row:

  1. route: softmax gates in float32, top-k, renormalised;
  2. a stable sort of the (token, choice) pairs by expert; a pair's rank
     within its expert is its position past the expert's first
     (``searchsorted``); ranks at or past the capacity are dropped into
     the sentinel row ``e * cap``;
  3. the expert buffers [E, cap, d] go through the experts as batched
     products ([E, cap, d] x [E, d, f]);
  4. each pair's output, weighted by its gate, is summed back into token
     order.

Aux losses: Switch load balance and router z-loss (per-group
averages).

Sharded (``axes`` over a process-group mesh): a rank's tokens (its
data block) are its one group, and the experts' weights are the rank's
``model`` block, gathered over the FSDP axes by ``transformer``: with
``expert_shard="expert"`` the rank holds E / tp whole experts, runs
their buffers and combines only their pairs; with ``"ffn"`` it holds
every expert's d_ff / tp slice.  Either way the combined output is a
partial sum, summed over ``model`` (the reference's dp<->tp exchange).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_reduce
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


def _experts(xe, p):
    h = torch.matmul(xe, p["w1"])                      # [E, cap, f]
    if "w3" in p:
        h = F.silu(h) * torch.matmul(xe, p["w3"])
    else:
        h = F.silu(h)
    del xe
    return torch.matmul(h, p["w2"])                    # [E, cap, d]


def _group_ffn(xl, p, cfg, cap: int, axes):
    """One group's dispatch, experts and combine -> ([Tg, d], lb, z)."""
    tg = xl.shape[0]
    xe, route, lb, z = _dispatch_group(xl, p, cfg, cap)
    e_l = p["w1"].shape[0]
    if e_l < cfg.n_experts:          # this rank's experts only
        e0 = axes.index("tp") * e_l
        slot, st, sw = route
        lo, hi = e0 * cap, (e0 + e_l) * cap
        slot = torch.where((slot >= lo) & (slot < hi), slot - lo, e_l * cap)
        y = _experts(xe[e0:e0 + e_l], p)
        del xe
        out = _combine_group(y, (slot, st, sw), tg, cap,
                             _Experts(e_l))
    else:
        y = _experts(xe, p)
        del xe
        out = _combine_group(y, route, tg, cap, cfg)
    return out, lb, z


class _Experts:
    """A config's stand-in with ``n_experts`` the rank's count."""

    def __init__(self, n: int):
        self.n_experts = n


@f32_reductions
def moe_ffn(x, p, cfg, axes=None):
    """x: [T, d] tokens; returns ([T, d], aux_loss scalar).  Sharded
    (``axes`` over a process-group mesh), ``x`` is this rank's tokens
    and the aux loss its group's."""
    t, d = x.shape
    if axes is not None and axes.sharded():
        cap = _capacity(cfg, t)
        out, lb, z = _group_ffn(x, p, cfg, cap, axes)
        partial = p["w1"].shape[0] < cfg.n_experts or \
            p["w2"].shape[-2] < cfg.d_ff
        if partial:
            out = all_reduce(out, axes.group("tp"))
        aux = cfg.moe_lb_coef * lb + cfg.moe_z_coef * z
        return out.to(x.dtype), aux
    g = math.gcd(t, axes.dp_size) if axes is not None else 1
    tg = t // g
    cap = _capacity(cfg, tg)
    outs, lbs, zs = [], [], []
    for xl in x.view(g, tg, d):
        out, lb, z = _group_ffn(xl, p, cfg, cap, None)
        outs.append(out)
        lbs.append(lb)
        zs.append(z)
    out = outs[0] if g == 1 else torch.cat(outs)
    aux = cfg.moe_lb_coef * torch.stack(lbs).mean() \
        + cfg.moe_z_coef * torch.stack(zs).mean()
    return out.to(x.dtype), aux
