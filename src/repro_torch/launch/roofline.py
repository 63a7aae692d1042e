"""Roofline terms of a cell on one NVIDIA H100 (the port of
``repro.launch.roofline``, re-targeted from a TPU v5e).

Three terms per (arch × shape), in seconds:

    compute    = FLOPs / 989e12          (dense bf16 peak, no sparsity)
    memory     = bytes accessed / 3.35e12 (HBM3 rate)
    collective = bytes on the wire / 450e9 (NVLink, each way)

The constants are NVIDIA's H100 SXM data sheet at its 700 W power limit
(a card set below it runs slower under load).  FLOPs and bytes come from
the dry run's trace of the cell (``launch.dryrun``).  There is no HLO
text in torch, so ``collective_bytes`` takes one record per collective,
``(kind, result_bytes, group_size)``, and sums the reference's ring
rules for wire traffic per device:

    all-reduce          2 x result bytes x (n-1)/n
    all-gather          1 x result bytes x (n-1)/n
    reduce-scatter      1 x result bytes x (n-1)   (the operand is n results)
    all-to-all          1 x result bytes x (n-1)/n
    collective-permute  1 x result bytes

On one card a cell runs no collective.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12      # bf16, dense / card
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s, NVLink, each way

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _wire_bytes(kind: str, rbytes: float, n: int) -> float:
    ring = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return 2 * rbytes * ring
    if kind in ("all-gather", "all-to-all"):
        return rbytes * ring
    if kind == "reduce-scatter":
        return rbytes * (n - 1)
    if kind == "collective-permute":
        return rbytes
    raise ValueError(f"unknown collective {kind!r}")


def collective_bytes(records) -> dict:
    """Per-device wire bytes by collective kind, from ``(kind,
    result_bytes, group_size)`` records."""
    out = {k: 0.0 for k in KINDS}
    out["n_ops"] = 0
    for kind, rbytes, n in records:
        out[kind] += _wire_bytes(kind, float(rbytes), max(int(n), 1))
        out["n_ops"] += 1
    out["total"] = sum(out[k] for k in KINDS)
    return out


def roofline_terms(cost: dict, coll: dict, n_chips: int,
                   model_flops: float | None = None) -> dict:
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll["total"] / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    out = {
        **terms,
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "wire_bytes_per_device": coll["total"],
        "n_chips": n_chips,
    }
    if model_flops:
        hlo_total = flops_dev * n_chips
        out["model_flops"] = float(model_flops)
        out["useful_flops_ratio"] = (
            float(model_flops) / hlo_total if hlo_total else 0.0)
        # roofline fraction: useful work at peak vs. the binding term
        out["roofline_fraction"] = (
            (model_flops / n_chips / PEAK_FLOPS) / bound if bound else 0.0)
    return out
