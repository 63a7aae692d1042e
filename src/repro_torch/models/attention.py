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
only (``matmul_flags``) and restored.  The reference's ``axes`` (JAX
sharding constraints) is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import (
    apply_rope,
    matmul_flags,
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
):
    """Online-softmax chunked attention; exact, O(S·chunk) memory."""
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


def attention_block(
    x,                  # [B, S, d]
    p,                  # params dict: wq, wk, wv, wo (+ q_norm/k_norm)
    cfg,
    positions=None,
    kv_cache=None,      # (k, v, length) for decode
):
    """The attention block shared by the train, prefill and decode
    paths.  Projection weights hold the heads flattened into the feature
    dim ([d, H*hd]).

    With ``kv_cache`` the new K/V are written into the caller's cache
    tensors in place at positions ``length .. length + S - 1`` (the
    reference returns updated copies); returns ``(y, (k_cache, v_cache,
    length + S))``.  Without it, ``(y, (k, v, None))`` with the
    post-RoPE K/V, for the prefill's cache capture.
    """
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).view(b, s, hq, hd)
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
    else:
        out = gqa_attention(q, k, v, causal=True, chunk_size=cfg.attn_chunk,
                            window=cfg.attn_window)
        new_cache = (k, v, None)   # post-RoPE K/V for prefill cache capture

    y = out.reshape(b, s, hq * hd) @ p["wo"]
    return y, new_cache
