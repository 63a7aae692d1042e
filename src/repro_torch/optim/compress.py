"""Gradient compression for the data-parallel all-reduce: the port of
``repro.optim.compress``.

int8 quantized all-reduce with error feedback (1-bit-Adam family): each
step quantizes (grad + residual) to int8 with a per-tensor scale,
all-reduces the int8 payload, dequantizes, and keeps the quantization
error as residual for the next step.

Two forms of ``compressed_psum``.  One controller: the reference's
``axis_name`` mesh axis is a leading axis of n per-shard values on every
leaf (as ``core.distributed`` holds its shard axis); the psum is a sum
over that axis, broadcast back to every shard.  Process group
(``group=``): each rank holds its own leaves, with no shard axis, and
the int8 payloads sum in an ``all_reduce`` (int32, so n ranks of ±127
never overflow), the shared scale in a max ``all_reduce``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.collectives import all_reduce_
from repro_torch.optim.tree import flatten, flatten_up_to, unflatten


def _quantize(x):
    """float32 ``x`` -> (int8, per-tensor scale, residual)."""
    s = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    qi = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return qi, s, x - qi.float() * s


def quantize_tree(grads, residual=None):
    """-> (int8 tree, scale tree, new residual tree)."""
    flat_g = flatten(grads)
    flat_r = ([torch.zeros_like(g, dtype=torch.float32) for g in flat_g]
              if residual is None else flatten_up_to(grads, residual))
    qs, ss, rs = zip(*[_quantize(g.float() + r)
                       for g, r in zip(flat_g, flat_r)])
    return (unflatten(grads, qs), unflatten(grads, ss),
            unflatten(grads, rs))


def dequantize_tree(q_tree, scale_tree):
    return unflatten(q_tree, [q.float() * s for q, s in zip(
        flatten(q_tree), flatten_up_to(q_tree, scale_tree))])


def compressed_psum(grads, axis_name, residual=None, *, group=None):
    """Error-feedback int8 psum over the shard axis (the leading axis of
    every leaf, n shards; ``axis_name`` names it, as in the reference's
    ``shard_map``).  Each shard quantizes its own values with its own
    scale and keeps its own residual; the int8 payloads sum in int32,
    the shared scale is the largest shard's, and the sum is divided by
    n.  -> (mean tree [n, ...], each shard's row the same; new residual
    tree [n, ...]).

    With ``group`` (a ``torch.distributed`` process group: the ranks
    along ``axis_name``) every leaf is this rank's own, without the
    shard axis, and so are the results: (mean tree, the same on every
    rank; this rank's new residual tree)."""
    if group is not None:
        return _group_psum(grads, residual, group)
    del axis_name               # one shard axis per leaf, the leading one
    flat_g = flatten(grads)
    flat_r = ([torch.zeros_like(g, dtype=torch.float32) for g in flat_g]
              if residual is None else flatten_up_to(grads, residual))
    outs, res = [], []
    for g, r in zip(flat_g, flat_r):
        n = g.shape[0]
        parts = [_quantize(g[k].float() + r[k]) for k in range(n)]
        q_sum = torch.stack([q.to(torch.int32) for q, _, _ in parts]).sum(0)
        s_max = torch.stack([s for _, s, _ in parts]).max()
        outs.append((q_sum.float() * s_max / n).expand(g.shape))
        res.append(torch.stack([x for _, _, x in parts]))
    return unflatten(grads, outs), unflatten(grads, res)


def _group_psum(grads, residual, group):
    n = dist.get_world_size(group)
    q, s, new_res = quantize_tree(grads, residual)
    outs = []
    for qi, si in zip(flatten(q), flatten_up_to(q, s)):
        q_sum = all_reduce_(qi.to(torch.int32), group)
        s_max = all_reduce_(si.reshape(1).clone(), group, "max")[0]
        outs.append(q_sum.float() * s_max / n)
    return unflatten(grads, outs), new_res
