"""Production mesh construction.

The port of ``repro.launch.mesh``.  A FUNCTION, not a module-level
constant: importing this module touches no device, and neither does a
call that lists its ``devices``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None,
                         group=None) -> Mesh:
    """16x16 = 256 chips per pod; 2x16x16 = 512 across two pods.

    ``devices`` None means the machine's cards (``torch.cuda.
    device_count()``); as ``jax.make_mesh`` does, fewer devices than the
    shape raises ``ValueError``.  Otherwise the first ``prod(shape)``
    entries of ``devices`` are used (a device may repeat).

    ``group`` (a ``torch.distributed`` process group of 256 or 512
    ranks) makes the process-group mesh: rank r at the row-major mesh
    coordinates of r, on ``devices[r]`` (``devices`` None: the rank's
    card, ``cuda:<rank % cards>``, or the CPU under a backend without
    one).  Its ``device_mesh`` is the DTensor mesh with the same axis
    names."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = math.prod(shape)
    if group is not None and devices is None:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", r % n) if n else torch.device("cpu")
                   for r in range(size)]
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < size:
        raise ValueError(f"mesh shape {shape} needs {size} devices, got "
                         f"{len(devices)}")
    return make_mesh(shape, axes, devices=devices[:size], group=group)


def engine_axes(mesh) -> tuple[str, ...]:
    """The axes the streaming engine shards table capacity over."""
    return tuple(a for a in mesh.axis_names if a != "model") + ("model",)
