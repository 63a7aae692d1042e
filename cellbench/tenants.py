"""Tenant patterns from a configuration file.

A configuration lists its tenants as data: named vertices with integer
labels, labelled edges, ``before`` pairs (edge i strictly before edge j)
and a window in timestamp units.
"""

from __future__ import annotations


def pattern(spec: dict):
    """The ``repro_torch.api.Pattern`` of a tenant."""
    from repro_torch.api import Pattern

    p = Pattern(spec["name"])
    for v, lab in spec["vertices"]:
        p = p.vertex(v, label=lab)
    for u, v, lab in spec["edges"]:
        p = p.edge(u, v, label=lab)
    for i, j in spec["before"]:
        p = p.before(i, j)
    return p.window(spec["window"])
