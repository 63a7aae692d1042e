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
``lax.map`` over its leading axis, and so is a large leaf whose moments
are elementwise (fp32 state: an embedding table), a chunk of rows.

Sharded (``specs`` and ``mesh``, a process-group mesh): every parameter,
gradient and state leaf is the rank's block (``state_specs``), and the
update is the global one: the state's layout is chosen from the global
shapes, the gradient norm sums each block once over the ranks that hold
it, and the factored moments' row and column means, the rank-1
denominator and the int8 scale's maximum reduce over the mesh axes of
the dims they span (``core.collectives``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.collectives import all_reduce_
from repro_torch.optim.tree import flatten, flatten_up_to, unflatten


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


class _Layout:
    """A leaf's place on a process-group mesh: its spec's groups per
    dim, its global shape, and whether this rank counts its block in a
    global sum (the first of the ranks that hold the same block).  With
    no mesh, a leaf that is whole here."""

    def __init__(self, shape, spec=None, mesh=None):
        from repro_torch.core.distributed import global_shape, \
            replicated_axes

        self.mesh, self.spec = mesh, spec
        if mesh is None:
            self.shape, self.counts = tuple(shape), True
            return
        self.shape = global_shape(tuple(shape), spec, mesh)
        c = mesh.coords()
        self.counts = all(c[a] == 0 for a in replicated_axes(spec, mesh))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def group(self, dims):
        """The group over the mesh axes of ``dims``' spec entries (None:
        not split)."""
        if self.mesh is None:
            return None
        parts = self.spec.parts
        axes = tuple(a for d in (d % self.ndim for d in dims)
                     if d < len(parts) for a in (parts[d] or ()))
        return self.mesh.axis_group(axes) if axes else None

    def mean(self, x, dim: int, keepdim: bool = False):
        """The global mean over ``dim`` of the block ``x``."""
        g = self.group((dim,))
        if g is None:
            return x.mean(dim=dim, keepdim=keepdim)
        tot = all_reduce_(x.sum(dim=dim, keepdim=keepdim).contiguous(), g)
        return tot / self.shape[dim % self.ndim]


# A stacked leaf is updated a chunk of whole slices at a time, each of
# the update's float32 temporaries at most this many elements (128 MB:
# one Wide&Deep field of 1,000,000 x 32), as the reference's lax.map
# keeps one slice's live.  Every reduction of the update is per slice,
# so a chunk of many small slices (GAT's [1433, 8, 8] weight) is one
# vectorized update instead of a host loop of small launches.
_CHUNK_ELEMS = 1 << 25


def _layouts(params, specs, mesh) -> list:
    leaves = flatten(params)
    if mesh is None:
        return [_Layout(x.shape) for x in leaves]
    return [_Layout(x.shape, sp, mesh)
            for x, sp in zip(leaves, flatten_up_to(params, specs))]


def adamw_init(params, cfg: AdamWConfig, *, specs=None, mesh=None):
    """Zero state beside ``params`` (on their devices).  With ``specs``
    (the parameters' ``PartitionSpec`` tree) and ``mesh`` (a
    process-group mesh), ``params`` are the rank's blocks and so is the
    state (``state_specs``), its layout chosen from the global shapes."""
    f32 = torch.float32

    def init_leaf(x, lay):
        st = {}
        if cfg.state_mode in ("factored", "int8") and _use_factored(lay):
            r, c = _factored_shape(tuple(x.shape))
            st["vr"] = torch.zeros(r, dtype=f32, device=x.device)
            st["vc"] = torch.zeros(c, dtype=f32, device=x.device)
        else:
            st["v"] = torch.zeros(x.shape, dtype=f32, device=x.device)
        if cfg.state_mode == "int8":
            st["m_q"] = torch.zeros(x.shape, dtype=torch.int8,
                                    device=x.device)
            st["m_scale"] = torch.zeros(
                (x.shape[0],) if _stacked(lay) else (), dtype=f32,
                device=x.device)
        else:
            st["m"] = torch.zeros(x.shape, dtype=f32, device=x.device)
        return st

    leaves = flatten(params)
    return {"leaves": unflatten(params, [
        init_leaf(x, lay)
        for x, lay in zip(leaves, _layouts(params, specs, mesh))]),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}


def global_norm(tree, *, specs=None, mesh=None):
    """The global L2 norm of ``tree``; with ``specs`` and ``mesh`` its
    leaves are blocks, each counted once over the ranks."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in flatten(tree)))
    leaves = flatten(tree)
    mine = [_Layout(x.shape, sp, mesh).counts
            for x, sp in zip(leaves, flatten_up_to(tree, specs))]
    tot = sum(torch.sum(torch.square(x.float()))
              for x, m in zip(leaves, mine) if m)
    tot = torch.zeros((), device=leaves[0].device) + tot
    return torch.sqrt(all_reduce_(tot.reshape(1), mesh.group))[0]


def _upd(g, st, p, lr, scale, c1, c2, cfg: AdamWConfig,
         per_slice: bool = False, lay: _Layout | None = None):
    """One leaf, or a chunk of whole slices of a stacked leaf
    (``per_slice``: the int8 scale is per slice): the new state written
    into ``st``'s tensors, the new parameter into ``p``.  ``lay``: the
    leaf's layout (its reductions span the ranks that hold its dims)."""
    b1, b2 = cfg.b1, cfg.b2
    lay = lay or _Layout(p.shape)
    lead = (-1,) + (1,) * (g.ndim - 1)     # a per-slice value, broadcast
    g = g.float() * scale
    # second moment
    if "vr" in st:
        g2 = torch.square(g) + 1e-30
        vr = b2 * st["vr"] + (1 - b2) * lay.mean(g2, -1)
        vc = b2 * st["vc"] + (1 - b2) * lay.mean(g2, -2)
        del g2
        st["vr"].copy_(vr)
        st["vc"].copy_(vc)
        # rank-1 reconstruction (Adafactor): vr ⊗ vc / mean(vr); vr's
        # last dim is the leaf's second to last
        vr_mean = vr.mean(dim=-1, keepdim=True) if lay.group((-2,)) is None \
            else lay.mean(vr[..., None], -2, keepdim=True)[..., 0]
        denom = torch.clamp(vr_mean, min=1e-30)
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
        grp = lay.group(range(lay.ndim))
        if grp is not None:
            top = all_reduce_(top.reshape(-1).contiguous(), grp,
                              "max").reshape(top.shape)
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
    if lay.ndim >= 2:
        step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * step)


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig, *,
                 specs=None, mesh=None):
    """One AdamW step: global-norm clipping to ``cfg.clip_norm``, the
    moments, bias corrections, decoupled weight decay on leaves of two
    or more dims.  Writes into ``params`` and ``state`` in place and
    returns ``(params, state, {"grad_norm": ...})``; ``lr`` is a float
    or a 0-d tensor (``cosine_with_warmup``).  With ``specs`` and
    ``mesh`` every leaf is the rank's block (see the module docstring);
    the gradients must be complete (summed over the ranks)."""
    count = state["count"] + 1
    gnorm = global_norm(grads, specs=specs, mesh=mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    c1 = 1 - cfg.b1 ** count.float()
    c2 = 1 - cfg.b2 ** count.float()

    flat_g = flatten_up_to(params, grads)
    flat_s = flatten_up_to(params, state["leaves"])
    for g, st, p, lay in zip(flat_g, flat_s, flatten(params),
                             _layouts(params, specs, mesh)):
        elementwise = cfg.state_mode == "fp32" or (
            cfg.state_mode == "factored" and not _use_factored(lay))
        if _stacked(lay) or (elementwise and p.numel() > _CHUNK_ELEMS):
            # a stacked leaf a chunk of whole slices at a time; a large
            # leaf with elementwise moments (fp32) a chunk of rows at a
            # time, each entry's update the same
            k = max(1, _CHUNK_ELEMS // p[0].numel())
            for lo in range(0, p.shape[0], k):
                part = slice(lo, lo + k)
                _upd(g[part], {n: v[part] for n, v in st.items()}, p[part],
                     lr, scale, c1, c2, cfg, per_slice=_stacked(lay),
                     lay=lay)
        else:
            _upd(g, st, p, lr, scale, c1, c2, cfg, lay=lay)
    state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm}


def state_specs(param_specs_tree, params, cfg: AdamWConfig):
    """Optimizer-state PartitionSpecs mirroring each parameter's spec
    (``params``: the global leaves, or anything with their ``ndim`` and
    ``shape``)."""
    from repro_torch.core.distributed import P

    def leaf(spec, x):
        st = {}
        if cfg.state_mode in ("factored", "int8") and _use_factored(x):
            st["vr"] = P(*spec[:-1]) if len(spec) else P()
            st["vc"] = P(*(spec[:-2] + spec[-1:])) if len(spec) else P()
        else:
            st["v"] = spec
        if cfg.state_mode == "int8":
            st["m_q"] = spec
            st["m_scale"] = P(None) if _stacked(x) else P()
        else:
            st["m"] = spec
        return st

    return {
        "leaves": unflatten(params, [leaf(s, x) for s, x in zip(
            flatten_up_to(params, param_specs_tree), flatten(params))]),
        "count": P(),
    }
