"""Published configurations of the ported models, one module per
architecture (the five LMs, ``nequip``, ``gat_cora``, ``gin_tu``,
``pna``, ``wide_deep``), and the registry of all ten with the shape sets
they are served at (``registry``)."""

from repro_torch.configs.registry import ARCHS, ArchSpec, ShapeSpec, get_arch
