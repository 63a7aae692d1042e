"""Architecture registry (the port of ``repro.configs.registry``): arch
id -> config + per-shape cell definitions.

Each architecture contributes an ``ArchSpec`` with its published
configuration and its shape set: the five LM architectures at
``lm_shapes``, the GNNs and NequIP at ``gnn_shapes``, Wide&Deep at
``recsys_shapes``; ``ARCHS`` holds all ten, ``get_arch`` reads one."""

from __future__ import annotations

import dataclasses
import importlib
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
    opt_state_mode: str = "fp32"   # fp32 | factored | int8 (AdamW memory)

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(name)


_MODULES = [
    "deepseek_coder_33b",
    "qwen3_14b",
    "internlm2_20b",
    "arctic_480b",
    "grok1_314b",
    "nequip",
    "gat_cora",
    "gin_tu",
    "pna",
    "wide_deep",
]

ARCHS: dict[str, ArchSpec] = {}


def _load():
    for m in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        spec = mod.ARCH
        ARCHS[spec.arch_id] = spec


def get_arch(arch_id: str) -> ArchSpec:
    if not ARCHS:
        _load()
    return ARCHS[arch_id]


def lm_shapes(microbatches_train: int = 8) -> tuple[ShapeSpec, ...]:
    """The LM-family shape set (identical across the five LM archs)."""
    return (
        ShapeSpec("train_4k", "train", global_batch=256, seq_len=4096,
                  microbatches=microbatches_train),
        ShapeSpec("prefill_32k", "prefill", global_batch=32, seq_len=32768),
        ShapeSpec("decode_32k", "decode", global_batch=128, seq_len=32768),
        ShapeSpec(
            "long_500k", "decode", global_batch=1, seq_len=524288,
            skip_reason=(
                "pure full-attention arch: long-context shape requires "
                "sub-quadratic attention per the assignment spec (decode "
                "itself is O(S); we additionally report the cell as a "
                "non-required extra — see EXPERIMENTS.md §Dry-run)"),
        ),
    )


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


# populate the registry once all helpers above exist (arch modules import
# this module back, so loading must be the final statement)
_load()
