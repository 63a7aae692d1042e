"""Dry run of every (arch × shape) cell on one H100, traced on the meta
device (the port of ``repro.launch.dryrun``).

A cell's arguments are meta tensors (``launch.cells``, shapes and dtypes
without storage), and its step runs once on them: every aten op
dispatches with no memory behind it and no card, as the reference lowers
and compiles on virtual CPU devices.  Per cell it records

* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  (the products, forward and backward, a recomputed layer again);
* ``cost["bytes accessed"]``: every aten op's tensor inputs and outputs,
  view ops skipped.  Nothing is fused, so this is an upper bound on the
  bytes a step must move;
* ``memory``: the argument bytes, the output bytes (those aliasing an
  argument, as an in-place train step's do, also as ``alias``), and the
  peak of live bytes: each storage counted from the op that makes it
  until it is freed, the arguments throughout, in the order the
  program runs (``_Reckoner``); ``fits`` against the card's 80 GB;
* the roofline terms of ``launch.roofline`` at one card, with no
  collective;
* ``ok``, ``error``, ``skipped`` and ``wall_s``, as the reference's: a
  failure is recorded and the sweep goes on; the exit code is 1 if a cell
  that is not skipped failed.

The mesh is one card, ``h100x1``.  A kernel wrapper on meta tensors runs
its plain version, so a cell whose path reaches a kernel on the card
(the GNNs' segment sums, Wide&Deep's bags) is reckoned through the plain
version's temporaries.  The reference's ``bf16_emulation_f32_bytes`` and
``tpu_native_peak_estimate`` are XLA:CPU artefacts and are not ported;
per-device figures for the production meshes wait for meshes of distinct
devices.

Usage:
    python -m repro_torch.launch.dryrun --arch gat-cora --shape full_graph_sm
    python -m repro_torch.launch.dryrun --all [--force]
Results: build/dryrun/h100x1/<arch>__<shape>.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import roofline as RL
from repro_torch.launch.cells import Cell, all_cells, build_cell, cell_leaves

MESH_NAME = "h100x1"
N_CHIPS = 1
HBM_BYTES = 80e9
RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Reckoner(TorchDispatchMode):
    """Bytes accessed and live bytes over the aten ops that run under it.

    A storage is counted live from the first op that returns it until it
    is freed (a ``weakref.finalize`` on the storage, whose Python object
    lives exactly as long as the storage does); storages registered
    with ``hold`` (the arguments) count from the start."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._sizes = {}

    def hold(self, tensors) -> int:
        """Count ``tensors``' storages live; returns their bytes."""
        before = self.live
        for t in tensors:
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """A matrix-vector product (retrieval's scores), which the flop
    counter's registry leaves out."""
    return 2 * a_shape[0] * a_shape[1]


def trace_cell(cell: Cell) -> dict:
    """``cell.fn(*cell.args)`` once, counted: {"cost", "memory",
    "collectives", "roofline"}."""
    flops = FlopCounterMode(display=False,
                            custom_mapping={torch.ops.aten.mv: _mv_flop})
    reck = _Reckoner()
    with flops, reck:
        args_bytes = reck.hold(cell_leaves(cell))
        out = cell.fn(*cell.args)
        # what the step returns and what it was given (a module's
        # parameters, the optimiser state) are the same storages
        args_ids = {id(t.untyped_storage()) for t in cell_leaves(cell)}
        outs = {id(s): s for s in (t.untyped_storage() for t in _tensors(
            [o.params() if hasattr(o, "params") else o for o in out]
            if isinstance(out, tuple) else out))}
        out_bytes = sum(s.nbytes() for s in outs.values())
        alias = sum(s.nbytes() for k, s in outs.items() if k in args_ids)
        del out, outs
    cost = {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(reck.bytes_accessed)}
    memory = {"argument_size_in_bytes": args_bytes,
              "output_size_in_bytes": out_bytes,
              "alias_size_in_bytes": alias,
              "peak_bytes_per_device": reck.peak,
              "fits": reck.peak <= HBM_BYTES}
    coll = RL.collective_bytes([])
    return {"cost": cost, "memory": memory, "collectives": coll,
            "roofline": RL.roofline_terms(cost, coll, N_CHIPS,
                                          cell.meta.get("model_flops"))}


def run_cell(arch_id: str, shape_name: str, *, out_dir: str = RESULTS_DIR,
             force: bool = False, cell: Cell | None = None) -> dict:
    """Trace one cell (``build_cell(arch_id, shape_name)``, or ``cell``,
    a cut one) and write its record to
    ``<out_dir>/h100x1/<arch>__<shape>.json``; an existing record is
    read back unless ``force``."""
    os.makedirs(os.path.join(out_dir, MESH_NAME), exist_ok=True)
    path = os.path.join(out_dir, MESH_NAME, f"{arch_id}__{shape_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec = {"arch": arch_id, "shape": shape_name, "mesh": MESH_NAME,
           "n_chips": N_CHIPS}
    t0 = time.time()
    try:
        if cell is None:
            cell = build_cell(arch_id, shape_name)
        rec["meta"] = {k: float(v) for k, v in cell.meta.items()}
        if cell.skip_reason:
            rec["skipped"] = cell.skip_reason
            rec["extra_cell"] = True   # run anyway, marked non-required
        rec.update(trace_cell(cell))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    if rec["ok"]:
        peak = rec["memory"]["peak_bytes_per_device"] / 2**30
        status = (f"OK peak {peak:.2f} GiB, {rec['roofline']['dominant']}"
                  f"-bound {rec['roofline']['bound_s']:.4g} s")
    else:
        status = f"FAIL ({rec['error'][:120]})"
    print(f"[{MESH_NAME}] {arch_id} x {shape_name}: {status} "
          f"({rec['wall_s']}s)", flush=True)
    return rec


def main(*, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for arch_id, shape_name in cells:
        rec = run_cell(arch_id, shape_name, out_dir=args.out,
                       force=args.force)
        n_fail += 0 if rec.get("ok") or rec.get("skipped") else 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
