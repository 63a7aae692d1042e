"""Shared model building blocks (the port of ``repro.models.common``):
norms, RoPE, parameter init, and the reference's parameter trees carried
across.  ``MeshAxes``, ``with_sharding`` and ``constrain`` are JAX
sharding and are not ported."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.optim.tree import flatten, tree_map


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, *, device=None):
    """Normal(0, 1 / fan_in) weights drawn from ``gen`` (a generator on
    ``device``).  The numbers differ from ``jax.random``'s; tests carry
    the reference's weights across with ``params_from_numpy``."""
    fan_in = shape[in_axis]
    # scaled in place: no second copy of a leaf at its full size
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(fan_in ** -0.5)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with float32 statistics: the squares are summed in float32
    (exact products of ``x``'s values, the reference's
    ``preferred_element_type``), then ``x * inv * scale`` is computed in
    ``x``'s dtype, rounding where the reference rounds."""
    xf = x.float()
    ss = (xf * xf).sum(-1)
    del xf
    inv = torch.rsqrt(ss / x.shape[-1] + eps)
    return x * inv[..., None].to(x.dtype) * scale


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, positions):
    """(cos, sin) [..., S, head_dim / 2] in float32 for integer
    ``positions`` [..., S]."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions[..., None].float() * inv          # [..., S, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, hd]; cos/sin: [..., S, half] broadcast over heads.
    The rotation is computed in float32 (a bfloat16 ``x`` promotes), the
    result cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


@contextlib.contextmanager
def matmul_flags(**flags):
    """``torch.backends.cuda.matmul``'s flags (``allow_tf32``,
    ``allow_bf16_reduced_precision_reduction``) set inside the block only;
    the process's settings are restored on exit."""
    mm = torch.backends.cuda.matmul
    prev = {k: getattr(mm, k) for k in flags}
    try:
        for k, v in flags.items():
            setattr(mm, k, v)
        yield
    finally:
        for k, v in prev.items():
            setattr(mm, k, v)


def f32_reductions(fn):
    """``fn`` with its bfloat16 products reduced in float32 on the card,
    as the reference accumulates them: cuBLAS may otherwise sum a split-K
    product's partial results in bfloat16
    (``allow_bf16_reduced_precision_reduction``)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with matmul_flags(allow_bf16_reduced_precision_reduction=False):
            return fn(*args, **kwargs)
    return run


def params_from_numpy(tree, device=None):
    """The reference's parameter tree (dicts and lists of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the same tree of
    tensors on ``device`` (None means the card)."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.tensor(np.asarray(x), device=device)   # a copy

    return conv(tree)



def count_params(params) -> int:
    return sum(x.numel() for x in flatten(params))


def cast_tree(params, dtype):
    """The tree with every floating leaf cast to ``dtype`` (integer
    leaves kept)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)
