"""Shared model building blocks (the port of ``repro.models.common``):
norms, RoPE, parameter init, the reference's parameter trees carried
across, and the sharding helpers ``MeshAxes``, ``with_sharding`` and
``constrain``."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

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


# --------------------------------------------------------------------- #
# Sharding helpers
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical -> physical axis mapping for the production meshes.

    ``dp``: pure data-parallel axes (batch). ``fsdp``: parameter/optimizer
    sharding axes (ZeRO-3 style; same physical axes as dp on our meshes).
    ``tp``: tensor/expert-parallel axis. ``dp_size``/``tp_size``: device
    counts, needed by grouped-dispatch MoE.  ``mesh``: the port's
    process-group mesh (``core.distributed.Mesh``) whose ranks run the
    sharded program, None for the one-process program; it takes no part
    in equality."""

    dp: Any = ("data",)
    fsdp: Any = ("data",)
    tp: Any = "model"
    dp_size: int = 1
    tp_size: int = 1
    _: dataclasses.KW_ONLY
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        names = mesh.axis_names
        tp_size = mesh.shape["model"]
        dp_size = mesh.devices.size // tp_size
        group_mesh = mesh if getattr(mesh, "group", None) is not None \
            else None
        if "pod" in names:
            return MeshAxes(dp=("pod", "data"), fsdp=("pod", "data"),
                            tp="model", dp_size=dp_size, tp_size=tp_size,
                            mesh=group_mesh)
        return MeshAxes(dp=("data",), fsdp=("data",), tp="model",
                        dp_size=dp_size, tp_size=tp_size, mesh=group_mesh)

    def sharded(self) -> bool:
        """Whether the program runs on the ranks of a process group."""
        return self.mesh is not None

    def group(self, *logical):
        """The process group over the physical axes of the logical axes
        ``logical`` ("dp", "fsdp", "tp")."""
        phys = []
        for name in logical:
            a = getattr(self, name)
            phys += [a] if isinstance(a, str) else list(a)
        return self.mesh.axis_group(tuple(phys))

    def index(self, logical: str) -> int:
        """This rank's block along the logical axis ``logical``."""
        return self.mesh.axis_index(getattr(self, logical))

    def size(self, logical: str) -> int:
        """The number of blocks along the logical axis ``logical``."""
        return self.mesh.axis_size(getattr(self, logical))

    def block(self, x, logical: str, dim: int = -1):
        """This rank's block of ``x``'s ``dim`` along ``logical``."""
        w = x.shape[dim] // self.size(logical)
        return x.narrow(dim, self.index(logical) * w, w)


def partial_product(x, w):
    """``x @ w`` as float32 partial sums, to be summed over the ranks
    that hold the other blocks of the contracted dim and cast once.
    ``w`` is a 2-D block or a stack of them ([E, k, n], ``x`` then
    [E, m, k]).  bfloat16 operands go into one GEMM that writes float32
    (``out_dtype``): exact products and float32 sums, as one product of
    the whole operands accumulates, with no float32 copy of the weight
    block.  CPU tensors, which have no such GEMM, are upcast."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cpu":
        return x.float() @ w.float()
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.view(*x.shape[:-1], w.shape[-1])


def _spec(axes: MeshAxes, entries):
    from repro_torch.core.distributed import PartitionSpec

    return PartitionSpec(*(getattr(axes, e) if isinstance(e, str) else e
                           for e in entries))


def with_sharding(x, mesh, spec):
    """``x`` (a DTensor on ``mesh``'s ``device_mesh``) redistributed to
    ``spec``'s placements; a plain tensor is a rank's block already and
    is returned as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.distributed import placements

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh.device_mesh,
                          placements(spec, mesh.device_mesh))


def constrain(x, axes: "MeshAxes | None", *entries):
    """Sharding constraint at a point of the program.

    ``entries`` are logical-axis names ('dp'/'tp') or None per dim; no-op
    when ``axes`` is None (single-device smoke paths) or names no
    process-group mesh.  On one, a DTensor is redistributed to the
    spec's placements (``with_sharding``); the sharded cells run each
    rank's program on plain local tensors, which hold the named block
    already."""
    if axes is None or axes.mesh is None:
        return x
    return with_sharding(x, axes.mesh, _spec(axes, entries))


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
