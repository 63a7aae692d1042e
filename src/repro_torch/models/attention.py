"""Attention: GQA with RoPE / qk-norm, the chunked online-softmax path of
training and prefill, and KV-cache decode (the port of
``repro.models.attention``).

* Training and prefill run an online softmax over KV chunks, so the
  [S, S] score matrix never exists (a 32k prefill holds one
  [B, H, S, chunk] float32 block at a time, masked and exponentiated in
  place).
* Decode computes the new positions against the whole [S_max] cache,
  masked past each sequence's length.

The reference repeats each KV head over its query heads (``_repeat_kv``);
here the query heads are grouped over their KV head instead (query head
``h = kv * n_rep + r``, the reference's order), which gives the same
products without copying K and V ``n_rep`` times.

The scores are float32 products of the compute dtype's operands, as the
reference's ``preferred_element_type=float32``: the operands are upcast
to float32.  When the operands are bfloat16, each upcast value is exact
in TF32, so the score product runs on the tensor cores in TF32 with
exact products and float32 accumulation: the reference's numbers.  The
P·V product is float32 × float32, as in the reference, and runs in IEEE
float32, never TF32: rounding P to TF32 (2^-11 relative) would move the
bfloat16 attention output past a rounding boundary far more often than
float32 reordering does, and the decode path (P normalised before the
product) would drift from the prefill path (after it).  In float32
nothing runs in TF32.  The TF32 switch is set around the score products
only (``matmul_flags``) and restored.

Sharded (``axes`` over a process-group mesh):

* training and prefill (``attention_block``; ``transformer`` hands each
  rank its layer's weights gathered over the FSDP axes) shard the query
  heads over ``model`` in padded groups, as the reference's partitioner
  pads them: rank ``t`` computes heads ``[t·c, min(H, (t+1)·c))``,
  ``c = ⌈H / tp⌉`` (``head_block``; 40 heads on a 16-way axis: 3 a
  rank, none on the last two).  When the heads divide ``model`` its
  ``wq`` columns and ``wo`` rows are its ``model`` block; otherwise they
  come whole and the rank slices its heads' out.  K and V are computed
  for every KV head (``wk``/``wv`` whole) and the rank's heads read
  theirs; the output projection's partial sums are summed over
  ``model`` (a rank without heads adds zeros);
* decode (``stationary_attention``) keeps every weight in its stored
  block: the rank's FSDP block of the activations times its ``wq`` /
  ``wk`` / ``wv`` block gives partial sums over the FSDP axes, which are
  summed, and its ``model`` column blocks of q, k and v are gathered
  over ``model``.  It then reads the rank's block of the cache (the
  batch over the data axes and the positions over ``model``, or the
  positions over every axis when the batch is smaller than the data
  axes): the new K/V are written where their position falls in the
  block, each rank computes its positions' partial softmax (max, sum,
  weighted values) and the parts combine over the position axes,
  flash-decoding's split-KV scheme, which the reference's partitioner
  derives from the shardings.  The rank's ``model`` rows of the output
  times its ``wo`` block are partial sums over ``model``, summed, and
  the FSDP blocks gathered: only activations move.
"""

from __future__ import annotations

import torch

from repro_torch.core.collectives import all_gather, all_reduce
from repro_torch.models.common import (
    apply_rope,
    constrain,
    matmul_flags,
    partial_product,
    rms_norm,
    rope_freqs,
)

NEG_INF = -1e30


def _repeat_kv(k, n_rep: int):
    """[B, S, Hkv, hd] -> [B, S, Hkv * n_rep, hd], head ``h`` holding KV
    head ``h // n_rep`` (the attention paths group the query heads
    instead; kept for the reference's public name)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _f32(x):
    """``x`` as a contiguous float32 tensor, in one pass (a copy even
    where ``x`` is float32 already)."""
    return torch.empty(x.shape, dtype=torch.float32,
                       device=x.device).copy_(x)


def _grouped_q(q, hkv: int):
    """q [B, S, Hq, hd] (already scaled) -> float32 [B, Hkv, n_rep * S,
    hd]: the query heads of each KV head, row ``r * S + s``."""
    b, s, hq, hd = q.shape
    rep = hq // hkv
    return _f32(q.view(b, s, hkv, rep, hd).permute(0, 2, 3, 1, 4)).view(
        b, hkv, rep * s, hd)


def _heads_out(acc, s: int, dtype):
    """float32 [B, Hkv, n_rep * S, hd] -> [B, S, Hq, hd] in ``dtype``."""
    b, hkv, rs, hd = acc.shape
    rep = rs // s
    return acc.view(b, hkv, rep, s, hd).permute(0, 3, 1, 2, 4).reshape(
        b, s, hkv * rep, hd).to(dtype)


def _kv_f32(x):
    """[B, S, Hkv, hd] -> float32 [B, Hkv, S, hd], contiguous."""
    return _f32(x.transpose(1, 2))


def gqa_attention(
    q,             # [B, S, Hq, hd]
    k,             # [B, S, Hkv, hd]
    v,             # [B, S, Hkv, hd]
    *,
    causal: bool = True,
    chunk_size: int = 1024,
    window: int | None = None,   # sliding-window attention
    axes=None,
):
    """Online-softmax chunked attention; exact, O(S·chunk) memory.

    With ``axes``, q/k/v are head-sharded over tp (the sharded cells
    hand each rank its heads)."""
    q = constrain(q, axes, "dp", None, "tp", None)
    k = constrain(k, axes, "dp", None, "tp", None)
    v = constrain(v, axes, "dp", None, "tp", None)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    tf32 = q.dtype == torch.bfloat16
    q = q * hd ** -0.5
    qf = _grouped_q(q, hkv)                    # [B, Hkv, rep * S, hd]

    n_chunks = max(1, s // chunk_size)
    cs = s // n_chunks
    if cs * n_chunks != s:       # the reference's reshape refuses it too
        raise ValueError(f"sequence {s} does not split into {n_chunks} "
                         f"chunks of {chunk_size} or more")
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, hkv, rep, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, rep * s, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        kb = _kv_f32(k[:, c * cs:(c + 1) * cs])    # [B, Hkv, cs, hd]
        vb = _kv_f32(v[:, c * cs:(c + 1) * cs])
        # the switch covers this forward product (and its recompute under
        # remat, which runs this code again); its backward runs outside
        # it, in IEEE float32 (the train step holds TF32 off): float32
        # gradients are not exact in TF32
        with matmul_flags(allow_tf32=tf32):
            sc = torch.matmul(qf, kb.transpose(-1, -2))
        sc = sc.view(b, hkv, rep, s, cs)
        kpos = c * cs + torch.arange(cs, device=q.device)
        masked = None
        if causal:
            masked = qpos[:, None] < kpos[None, :]
        if window is not None:
            far = qpos[:, None] - kpos[None, :] >= window
            masked = far if masked is None else masked | far
        if masked is not None:
            sc.masked_fill_(masked, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        if sc.requires_grad:       # amax's backward reads sc
            p = torch.exp(sc - m_new[..., None])
        else:
            p = sc.sub_(m_new[..., None]).exp_()   # in place: sc is p
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.view(b, hkv, rep * s, cs), vb)
        del sc, p
        acc = acc * corr.view(b, hkv, rep * s, 1) + pv
        m = m_new
    out = acc / torch.clamp(l.view(b, hkv, rep * s, 1), min=1e-30)
    return _heads_out(out, s, q.dtype)         # [B, S, Hq, hd]


def decode_attention(
    q,          # [B, s, Hq, hd]
    k_cache,    # [B, S_max, Hkv, hd]
    v_cache,    # [B, S_max, Hkv, hd]
    length,     # int [B]: valid cache length per sequence
):
    """The new positions against the whole cache, masked at ``length``."""
    b, smax, hkv, hd = k_cache.shape
    s = q.shape[1]
    tf32 = q.dtype == torch.bfloat16
    qf = _grouped_q(q * hd ** -0.5, hkv)       # [B, Hkv, rep * s, hd]
    kf = _kv_f32(k_cache)                      # [B, Hkv, S_max, hd]
    with matmul_flags(allow_tf32=tf32):
        sc = torch.matmul(qf, kf.transpose(-1, -2))
    del kf
    pos = torch.arange(smax, device=q.device)
    masked = pos[None, :] >= length[:, None]   # [B, S_max]
    sc.masked_fill_(masked[:, None, None, :], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    del sc
    vf = _kv_f32(v_cache)
    out = torch.matmul(p, vf)                  # [B, Hkv, rep * s, hd]
    return _heads_out(out, s, q.dtype)


def _sharded_decode(q, k, v, kv_cache, axes):
    """Decode against this rank's block of the cache (see the module
    docstring): q/k/v [B, s, H, hd] for the whole batch -> the attention
    output [B, s, Hq, hd], every rank the same.  The softmax's sums and
    weighted values combine in one all-reduce."""
    kc, vc, length = kv_cache
    b, s = q.shape[:2]
    bl, sl = kc.shape[:2]
    batch_split = bl < b
    b0 = axes.index("dp") * bl if batch_split else 0
    seq_axes = ("tp",) if batch_split else ("dp", "tp")
    mesh = axes.mesh
    phys = [a for n in seq_axes for a in (
        (getattr(axes, n),) if isinstance(getattr(axes, n), str)
        else getattr(axes, n))]
    s0 = mesh.axis_index(tuple(phys)) * sl
    seq_group = mesh.axis_group(tuple(phys))
    q, k, v, length = (q[b0:b0 + bl], k[b0:b0 + bl], v[b0:b0 + bl],
                       length[b0:b0 + bl])
    # the new K/V at positions length .. length + s - 1, where this
    # rank's block holds them
    pos = length[:, None].long() + torch.arange(s, device=q.device)
    mine = (pos >= s0) & (pos < s0 + sl)
    bidx = torch.arange(bl, device=q.device)
    for j in range(s):          # one position a row at a time: no clash
        at = (pos[:, j] - s0).clamp(0, sl - 1)
        keep = mine[:, j, None, None]
        kc[bidx, at] = torch.where(keep, k[:, j].to(kc.dtype), kc[bidx, at])
        vc[bidx, at] = torch.where(keep, v[:, j].to(vc.dtype), vc[bidx, at])
    hkv, hd = kc.shape[2], kc.shape[3]
    tf32 = q.dtype == torch.bfloat16
    qf = _grouped_q(q * hd ** -0.5, hkv)       # [Bl, Hkv, rep * s, hd]
    with matmul_flags(allow_tf32=tf32):
        sc = torch.matmul(qf, _kv_f32(kc).transpose(-1, -2))
    kpos = s0 + torch.arange(sl, device=q.device)
    sc.masked_fill_((kpos[None, :] >= (length + s)[:, None])[:, None,
                                                             None, :],
                    NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    mx = all_reduce(m, seq_group, "max")
    p = torch.exp(sc - mx)
    acc = all_reduce(torch.cat([torch.matmul(p, _kv_f32(vc)),
                                p.sum(dim=-1, keepdim=True)], -1),
                     seq_group)
    out = _heads_out(acc[..., :hd] / acc[..., hd:], s, q.dtype)
    del acc                                    # out: [Bl, s, Hq, hd]
    if batch_split:
        out = all_gather(out, 0, axes.group("dp"))
    return out


def head_block(n_heads: int, tp_size: int, index: int) -> tuple:
    """The query heads ``[h0, h1)`` that rank ``index`` of a
    ``tp_size``-way ``model`` axis computes: padded groups of
    ``⌈n_heads / tp_size⌉``, the last ranks' cut short or empty (the
    reference's partitioner pads 40 heads to 48 on a 16-way axis)."""
    c = -(-n_heads // tp_size)
    h0 = min(n_heads, index * c)
    return h0, min(n_heads, h0 + c)


def stationary_attention(x, p, cfg, kv_cache, positions, axes):
    """The decode attention block on the rank's stored blocks (see the
    module docstring): ``x`` [B, s, d] the same on every rank, ``p`` the
    rank's ``wq``/``wk``/``wv`` ``[d/fsdp, ·/tp]`` and ``wo``
    ``[Hq·hd/tp, d/fsdp]`` blocks in ``cfg.dtype``; the new K/V are
    written into the rank's cache block.  Returns the block's output
    [B, s, d], every rank the same."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xb = axes.block(x, "fsdp")
    widths = [p[n].shape[-1] for n in ("wq", "wk", "wv")]
    qkv = torch.cat([partial_product(xb, p[n]) for n in ("wq", "wk", "wv")],
                    -1)
    qkv = all_reduce(qkv, axes.group("fsdp")).to(x.dtype)
    # every model rank's columns of q | k | v, in block order
    qkv = all_gather(qkv, -1, axes.group("tp")).view(b, s, -1, sum(widths))
    q, k, v = (t.reshape(b, s, -1, hd)
               for t in qkv.split(widths, -1))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _sharded_decode(q, k, v, kv_cache, axes).reshape(b, s, hq * hd)
    y = partial_product(axes.block(out, "tp"), p["wo"])
    y = all_reduce(y, axes.group("tp")).to(x.dtype)
    return all_gather(y, -1, axes.group("fsdp"))


def _kv_heads_of(k, h0: int, hq_l: int, rep: int):
    """The KV heads that query heads ``h0 .. h0 + hq_l - 1`` read: a
    slice when the block holds whole groups, else one per query head."""
    if h0 % rep == 0 and hq_l % rep == 0:
        return k[:, :, h0 // rep:(h0 + hq_l) // rep]
    idx = torch.arange(h0, h0 + hq_l, device=k.device) // rep
    return k.index_select(2, idx)


def attention_block(
    x,                  # [B, S, d]
    p,                  # params dict: wq, wk, wv, wo (+ q_norm/k_norm)
    cfg,
    positions=None,
    kv_cache=None,      # (k, v, length) for decode
    axes=None,
):
    """The attention block shared by the train, prefill and decode
    paths.  Projection weights hold the heads flattened into the feature
    dim ([d, H*hd]).

    With ``kv_cache`` the new K/V are written into the caller's cache
    tensors in place at positions ``length .. length + S - 1`` (the
    reference returns updated copies); returns ``(y, (k_cache, v_cache,
    length + S))``.  Without it, ``(y, (k, v, None))`` with the
    post-RoPE K/V, for the prefill's cache capture.

    ``axes`` over a process-group mesh (training and prefill): ``p`` is
    the rank's (see the module docstring); it computes its query heads
    ``head_block`` only, ``wq`` and ``wo`` either their ``model`` block
    or whole.  Decode on a mesh is ``stationary_attention``.
    """
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sharded = axes is not None and axes.sharded()
    wq, wo = p["wq"], p["wo"]
    h0, h1 = 0, hq
    if sharded:
        h0, h1 = head_block(hq, axes.tp_size, axes.index("tp"))
        if wq.shape[-1] == hq * hd and h1 - h0 < hq:   # whole: its heads
            wq, wo = wq[:, h0 * hd:h1 * hd], wo[h0 * hd:h1 * hd]
    hq_l = h1 - h0                           # this rank's query heads
    q = (x @ wq).view(b, s, hq_l, hd)
    k = (x @ p["wk"]).view(b, s, hkv, hd)
    v = (x @ p["wv"]).view(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if kv_cache is not None:
        kc, vc, length = kv_cache
        # write the new K/V at position `length` (decode: s == 1)
        idx = length[:, None].long() + torch.arange(s, device=x.device)
        bidx = torch.arange(b, device=x.device)[:, None]
        kc[bidx, idx] = k.to(kc.dtype)
        vc[bidx, idx] = v.to(vc.dtype)
        out = decode_attention(q, kc, vc, length + s)
        new_cache = (kc, vc, length + s)
    elif hq_l == 0:
        # a padded rank: no heads, so a zero partial; K and V reach it
        # through empty slices, so that their weights' gradients are
        # reduced on every rank as on the others
        out = q + (k[:, :, :0].sum() + v[:, :, :0].sum())
        new_cache = (k, v, None)
    else:
        ka, va = k, v
        if hq_l < hq:            # this rank's heads read their KV heads
            ka = _kv_heads_of(k, h0, hq_l, hq // hkv)
            va = _kv_heads_of(v, h0, hq_l, hq // hkv)
        out = gqa_attention(q, ka, va, causal=True,
                            chunk_size=cfg.attn_chunk,
                            window=cfg.attn_window, axes=axes)
        del ka, va
        new_cache = (k, v, None)   # post-RoPE K/V for prefill cache capture

    y = out.reshape(b, s, hq_l * hd) @ wo
    if sharded:                  # the heads' partial sums
        y = all_reduce(y, axes.group("tp"))
    return y, new_cache
