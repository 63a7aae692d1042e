"""Production mesh construction.

The port of ``repro.launch.mesh``.  A FUNCTION, not a module-level
constant: importing this module touches no device, and neither does a
call that lists its ``devices``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 chips per pod; 2x16x16 = 512 across two pods.

    ``devices`` None means the machine's cards (``torch.cuda.
    device_count()``); as ``jax.make_mesh`` does, fewer devices than the
    shape raises ``ValueError``.  Otherwise the first ``prod(shape)``
    entries of ``devices`` are used (a device may repeat)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < size:
        raise ValueError(f"mesh shape {shape} needs {size} devices, got "
                         f"{len(devices)}")
    return make_mesh(shape, axes, devices=devices[:size])


def engine_axes(mesh) -> tuple[str, ...]:
    """The axes the streaming engine shards table capacity over."""
    return tuple(a for a in mesh.axis_names if a != "model") + ("model",)
