"""AdamW with memory-scalable state variants: the port of
``repro.optim.adamw``.

State modes:
  * ``fp32``     — standard m, v in fp32 (12 B/param with fp32 master).
  * ``factored`` — Adafactor-style factored second moment for tensors
                   with >= 2 dims (row+col statistics), fp32 first
                   moment (≈8 B/param).
  * ``int8``     — first moment quantized to int8 with per-tensor scale,
                   factored second moment (≈5 B/param).

Trees are the reference's (dicts and lists of tensors; ``optim.tree``).
``adamw_update`` writes the new parameters and state into their tensors
in place under ``no_grad`` (the torch idiom: a module keeps its own
parameters) and returns the same trees.  A stacked leaf is updated a
chunk of whole slices at a time (``_CHUNK_ELEMS``), as the reference's
``lax.map`` over its leading axis.  The reference's sharding specs
(``state_specs``) are JAX sharding and are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.tree import flatten, flatten_up_to, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    state_mode: str = "fp32"      # fp32 | factored | int8


def _factored_shape(shape):
    """Factor the last two dims; leading dims (layer stack) kept."""
    return shape[:-1], shape[:-2] + shape[-1:]


def _use_factored(x) -> bool:
    return x.ndim >= 2 and x.shape[-1] >= 8 and x.shape[-2] >= 8


def _stacked(x) -> bool:
    """Layer-stacked leaf (leading scan dim) -> updated slice by slice,
    with per-slice quantization scales."""
    return x.ndim >= 3 and x.shape[0] > 1


# A stacked leaf is updated a chunk of whole slices at a time, each of
# the update's float32 temporaries at most this many elements (128 MB:
# one Wide&Deep field of 1,000,000 x 32), as the reference's lax.map
# keeps one slice's live.  Every reduction of the update is per slice,
# so a chunk of many small slices (GAT's [1433, 8, 8] weight) is one
# vectorized update instead of a host loop of small launches.
_CHUNK_ELEMS = 1 << 25


def adamw_init(params, cfg: AdamWConfig):
    """Zero state beside ``params`` (on their devices)."""
    f32 = torch.float32

    def init_leaf(x):
        st = {}
        if cfg.state_mode in ("factored", "int8") and _use_factored(x):
            r, c = _factored_shape(tuple(x.shape))
            st["vr"] = torch.zeros(r, dtype=f32, device=x.device)
            st["vc"] = torch.zeros(c, dtype=f32, device=x.device)
        else:
            st["v"] = torch.zeros(x.shape, dtype=f32, device=x.device)
        if cfg.state_mode == "int8":
            st["m_q"] = torch.zeros(x.shape, dtype=torch.int8,
                                    device=x.device)
            st["m_scale"] = torch.zeros(
                (x.shape[0],) if _stacked(x) else (), dtype=f32,
                device=x.device)
        else:
            st["m"] = torch.zeros(x.shape, dtype=f32, device=x.device)
        return st

    first = flatten(params)[0]
    return {"leaves": tree_map(init_leaf, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=first.device)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten(tree)))


def _upd(g, st, p, lr, scale, c1, c2, cfg: AdamWConfig,
         per_slice: bool = False):
    """One leaf, or a chunk of whole slices of a stacked leaf
    (``per_slice``: the int8 scale is per slice): the new state written
    into ``st``'s tensors, the new parameter into ``p``."""
    b1, b2 = cfg.b1, cfg.b2
    lead = (-1,) + (1,) * (g.ndim - 1)     # a per-slice value, broadcast
    g = g.float() * scale
    # second moment
    if "vr" in st:
        g2 = torch.square(g) + 1e-30
        vr = b2 * st["vr"] + (1 - b2) * g2.mean(dim=-1)
        vc = b2 * st["vc"] + (1 - b2) * g2.mean(dim=-2)
        del g2
        st["vr"].copy_(vr)
        st["vc"].copy_(vc)
        # rank-1 reconstruction (Adafactor): vr ⊗ vc / mean(vr)
        denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
        v_hat = (vr[..., :, None] * vc[..., None, :]) / denom[..., None]
    else:
        v_hat = b2 * st["v"] + (1 - b2) * torch.square(g)
        st["v"].copy_(v_hat)
    # first moment
    if "m_q" in st:
        s_prev = st["m_scale"].view(lead) if per_slice else st["m_scale"]
        m = b1 * (st["m_q"].float() * s_prev) + (1 - b1) * g
        top = m.abs().amax(dim=tuple(range(1, m.ndim))) if per_slice \
            else m.abs().max()
        s = torch.clamp(top, min=1e-12) / 127.0
        st["m_q"].copy_(torch.clamp(torch.round(
            m / (s.view(lead) if per_slice else s)), -127, 127))
        st["m_scale"].copy_(s)
    else:
        m = b1 * st["m"] + (1 - b1) * g
        st["m"].copy_(m)
    del g
    step = (m / c1) / (torch.sqrt(v_hat / c2) + cfg.eps)
    del m, v_hat
    if p.ndim >= 2:
        step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * step)


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig):
    """One AdamW step: global-norm clipping to ``cfg.clip_norm``, the
    moments, bias corrections, decoupled weight decay on leaves of two
    or more dims.  Writes into ``params`` and ``state`` in place and
    returns ``(params, state, {"grad_norm": ...})``; ``lr`` is a float
    or a 0-d tensor (``cosine_with_warmup``)."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    c1 = 1 - cfg.b1 ** count.float()
    c2 = 1 - cfg.b2 ** count.float()

    flat_g = flatten_up_to(params, grads)
    flat_s = flatten_up_to(params, state["leaves"])
    for g, st, p in zip(flat_g, flat_s, flatten(params)):
        if _stacked(p):
            k = max(1, _CHUNK_ELEMS // p[0].numel())
            for lo in range(0, p.shape[0], k):
                part = slice(lo, lo + k)
                _upd(g[part], {n: v[part] for n, v in st.items()}, p[part],
                     lr, scale, c1, c2, cfg, per_slice=True)
        else:
            _upd(g, st, p, lr, scale, c1, c2, cfg)
    state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm}
