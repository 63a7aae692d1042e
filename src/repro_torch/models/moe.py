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

Sharded (``axes`` over a process-group mesh), training and prefill: a
rank's tokens (its data block) are its one group, and the experts' weights are the rank's
``model`` block, gathered over the FSDP axes by ``transformer``: with
``expert_shard="expert"`` the rank holds E / tp whole experts, runs
their buffers and combines only their pairs; with ``"ffn"`` it holds
every expert's d_ff / tp slice.  Either way the combined output is a
partial sum, summed over ``model`` (the reference's dp<->tp exchange).
Decode keeps every weight in its stored block and moves activations
(``stationary_moe``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_gather, all_reduce
from repro_torch.models.common import f32_reductions, partial_product


def _route(logits, cfg, cap: int):
    """Route one token group from its float32 gate logits [Tg, E] ->
    ((slot, st, sw), lb, z): each (token, choice) pair's buffer row
    ``slot`` (``E * cap`` when dropped), token and gate."""
    tg = logits.shape[0]
    e, k = cfg.n_experts, cfg.moe_topk
    dev = logits.device

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
    return (slot, st, sw), lb, z


def _buffers(xl, route, n_experts: int, cap: int):
    """The expert buffers [E, cap, d] of a group's rows ``xl`` [Tg, d]:
    every dropped pair writes the sentinel row, which is discarded."""
    slot, st, _ = route
    xe = xl.new_zeros((n_experts * cap + 1, xl.shape[-1]))
    xe[slot] = xl[st]
    return xe[:-1].view(n_experts, cap, -1)


def _dispatch_group(xl, p, cfg, cap: int):
    """Route one token group. xl: [Tg, d] -> (xe [E, cap, d], (slot, st,
    sw), lb, z)."""
    route, lb, z = _route((xl @ p["wg"]).float(), cfg, cap)
    return _buffers(xl, route, cfg.n_experts, cap), route, lb, z


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


def _own_slots(slot, e0: int, e_l: int, cap: int):
    """Buffer rows of experts ``e0 .. e0 + e_l - 1`` relative to the
    first; every other pair to the sentinel row ``e_l * cap``."""
    lo, hi = e0 * cap, (e0 + e_l) * cap
    return torch.where((slot >= lo) & (slot < hi), slot - lo, e_l * cap)


def _group_ffn(xl, p, cfg, cap: int, axes):
    """One group's dispatch, experts and combine -> ([Tg, d], lb, z)."""
    tg = xl.shape[0]
    xe, route, lb, z = _dispatch_group(xl, p, cfg, cap)
    e_l = p["w1"].shape[0]
    if e_l < cfg.n_experts:          # this rank's experts only
        e0 = axes.index("tp") * e_l
        slot, st, sw = route
        slot = _own_slots(slot, e0, e_l, cap)
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


def stationary_moe(x, p, cfg, axes):
    """The MoE FFN of a decode step on the rank's stored blocks: ``x``
    [T, d] the same on every rank (so is the result), routed as one
    group, as the reference's decode routes it, on gate logits summed
    over the FSDP axes (``wg`` ``[d/fsdp, E]``).  The rank runs its own
    experts (``expert_shard="expert"``: E/tp whole ones, ``w1``/``w3``
    ``[E/tp, d/fsdp, d_ff]``; ``"ffn"``: every expert's d_ff/tp block)
    on its FSDP block of the dispatched rows, their partial sums summed
    over the FSDP axes, combines their pairs into its ``[T, d/fsdp]``
    block of the output, sums it over ``model`` and gathers the FSDP
    blocks.  Partial sums are float32, cast to ``x``'s dtype once."""
    t = x.shape[0]
    cap = _capacity(cfg, t)
    fsdp, tp = axes.group("fsdp"), axes.group("tp")
    xb = axes.block(x, "fsdp")
    logits = all_reduce(partial_product(xb, p["wg"]), fsdp).to(x.dtype)
    route, _, _ = _route(logits.float(), cfg, cap)
    e_l = p["w1"].shape[0]
    e0 = axes.index("tp") * e_l if e_l < cfg.n_experts else 0
    xe = _buffers(xb, route, cfg.n_experts, cap)[e0:e0 + e_l]
    h = torch.cat([partial_product(xe, p["w1"]),
                   partial_product(xe, p["w3"])], -1)
    h1, h3 = all_reduce(h, fsdp).to(x.dtype).chunk(2, -1)
    y = partial_product(F.silu(h1) * h3, p["w2"])      # [E_l, cap, d/f]
    if p["w2"].shape[-2] == cfg.d_ff:
        # whole experts' outputs: rounded, and weighted, as the
        # one-process combine rounds them (a d_ff block's stay partial)
        y = y.to(x.dtype)
    slot, st, sw = route
    y = torch.cat([y.reshape(e_l * cap, -1), y.new_zeros((1, y.shape[-1]))])
    contrib = y[_own_slots(slot, e0, e_l, cap)] * sw[:, None].to(y.dtype)
    out = x.new_zeros((t, y.shape[-1]), dtype=torch.float32).index_add_(
        0, st, contrib.float())
    out = all_reduce(out, tp).to(x.dtype)
    return all_gather(out, -1, fsdp)
