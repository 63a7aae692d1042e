"""Shared model building blocks (the port of ``repro.models.common``):
parameter init, and the reference's parameter trees carried across."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import resolve_device


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, *, device=None):
    """Normal(0, 1 / fan_in) weights drawn from ``gen`` (a generator on
    ``device``).  The numbers differ from ``jax.random``'s; tests carry
    the reference's weights across with ``params_from_numpy``."""
    fan_in = shape[in_axis]
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device) * (fan_in ** -0.5)


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
