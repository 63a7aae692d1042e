"""Config and shape records, copied from ``repro.configs.registry``:
``ShapeSpec``, ``ArchSpec`` and the shape sets of the ported families
(recsys, gnn).  The reference's registry of all architectures waits for
the slices that port them."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train | prefill | decode | serve | retrieval
    global_batch: int = 1
    seq_len: int = 0
    microbatches: int = 1        # grad-accumulation splits (train)
    skip_reason: str | None = None
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | gnn | nequip | recsys
    config: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(name)


def gnn_shapes() -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("full_graph_sm", "train",
                  extra=dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                             n_classes=7)),
        ShapeSpec("minibatch_lg", "train",
                  extra=dict(n_nodes=232_965, n_edges=114_615_892,
                             batch_nodes=1024, fanout=(15, 10), d_feat=602,
                             n_classes=41)),
        ShapeSpec("ogb_products", "train",
                  extra=dict(n_nodes=2_449_029, n_edges=61_859_140,
                             d_feat=100, n_classes=47)),
        ShapeSpec("molecule", "train",
                  extra=dict(n_nodes=30, n_edges=64, batch=128,
                             d_feat=16, n_classes=8)),
    )


def recsys_shapes() -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_batch", "train", global_batch=65536),
        ShapeSpec("serve_p99", "serve", global_batch=512),
        ShapeSpec("serve_bulk", "serve", global_batch=262_144),
        ShapeSpec("retrieval_cand", "retrieval", global_batch=1,
                  extra=dict(n_candidates=1_000_000)),
    )
