"""Tiny cells for the benchmark's CPU tests: the configurations' tenant
rules over a small dense stream, served by the port's REF backend."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

CONFIGS = ("caida_c2", "lsbench_share")


def tiny(name: str, share=None):
    """``(cfg, traffic)`` of configuration ``name`` cut to a CPU test:
    20 vertices of the configuration's labels (300 where they all take
    one, so that the tables hold the matches), 4 edge labels (each
    tenant's taken mod 4), windows of ~300 timestamp units, tables of
    1,024 rows, batches of 64 edges, ~20 window ticks."""
    cfg = json.loads((ROOT / "cellbench" / "configs" / f"{name}.json")
                     .read_text())
    one = cfg["stream"]["n_vertex_labels"] == 1
    cfg["stream"].update(n_vertices=300 if one else 20, n_edge_labels=4)
    for t in cfg["tenants"]:
        t["window"] = 300 + t["window"] % 10_000 // 100
        t["edges"] = [[u, v, lab % 4] for u, v, lab in t["edges"]]
    cfg["service"].update(level_capacity=1024, l0_capacity=1024, max_new=512)
    if share is not None:
        cfg["service"]["share_prefixes"] = share
    return cfg, {"batch": 64, "ceiling_edges_per_s": 1280}


@pytest.fixture
def tiny_cell():
    return tiny
