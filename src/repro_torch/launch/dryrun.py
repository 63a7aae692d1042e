"""Dry run of every (arch × shape) cell, traced on the meta device (the
port of ``repro.launch.dryrun``): on one H100 (``h100x1``), and per
device on the production meshes ``pod16x16`` (256 ranks) and
``pod2x16x16`` (512).

A cell's arguments are meta tensors (``launch.cells``, shapes and dtypes
without storage), and its step runs once on them: every aten op
dispatches with no memory behind it and no card, as the reference lowers
and compiles on virtual CPU devices.  On a production mesh the cell is
rank 0's program: this process is rank 0 of a process group of the
mesh's size under the "fake" backend (``torch.testing._internal.
distributed.fake_pg``), whose collectives return at once, and the cell
is built on ``launch.mesh.make_production_mesh(group=)``: its arguments
are rank 0's blocks and its step calls the collectives a rank calls.
Per cell it records

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
* ``collectives``: every collective the rank issues, recorded as
  ``(kind, result_bytes, group_size)`` (``core.collectives``) and summed
  by ``launch.roofline.collective_bytes``;
* the roofline terms of ``launch.roofline`` at the mesh's card count;
* ``ok``, ``error``, ``skipped`` and ``wall_s``, as the reference's: a
  failure is recorded and the sweep goes on; the exit code is 1 if a cell
  that is not skipped failed.

A kernel wrapper on meta tensors runs its plain version, so a cell whose
path reaches a kernel on the card (the GNNs' segment sums, Wide&Deep's
bags) is reckoned through the plain version's temporaries.  The
reference's ``bf16_emulation_f32_bytes`` and ``tpu_native_peak_estimate``
are XLA:CPU artefacts and are not ported.  A 256- or 512-card mesh here
is the reference's production shape reckoned with one H100's constants,
not a machine that was run.

Usage:
    python -m repro_torch.launch.dryrun --arch gat-cora --shape full_graph_sm
    python -m repro_torch.launch.dryrun --all [--multi-pod | --one-card]
        [--force]
Results: build/dryrun/{h100x1,pod16x16,pod2x16x16}/<arch>__<shape>.json
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

import torch.distributed as dist

from repro_torch.core.collectives import recording
from repro_torch.launch import roofline as RL
from repro_torch.launch.cells import Cell, all_cells, build_cell, cell_leaves

MESHES = {None: ("h100x1", 1), False: ("pod16x16", 256),
          True: ("pod2x16x16", 512)}
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


def fake_mesh(multi_pod: bool):
    """The production mesh over a "fake" process group of its size, this
    process rank 0 (an existing group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    n = MESHES[multi_pod][1]
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != n):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_production_mesh(multi_pod=multi_pod,
                                devices=("meta",) * n,
                                group=dist.group.WORLD)


def trace_cell(cell: Cell, n_chips: int = 1) -> dict:
    """``cell.fn(*cell.args)`` once, counted: {"cost", "memory",
    "collectives", "roofline"}; ``n_chips`` the mesh's card count."""
    flops = FlopCounterMode(display=False,
                            custom_mapping={torch.ops.aten.mv: _mv_flop})
    reck = _Reckoner()
    with flops, reck, recording() as records:
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
    coll = RL.collective_bytes(records)
    coll["records"] = [list(r) for r in records]
    return {"cost": cost, "memory": memory, "collectives": coll,
            "roofline": RL.roofline_terms(cost, coll, n_chips,
                                          cell.meta.get("model_flops"))}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool | None = None,
             *, out_dir: str = RESULTS_DIR, force: bool = False,
             cell: Cell | None = None, cell_fn=None) -> dict:
    """Trace one cell and write its record to
    ``<out_dir>/<mesh>/<arch>__<shape>.json``; an existing record is
    read back unless ``force``.  ``multi_pod`` None is one card
    (``h100x1``); False and True are rank 0 of ``pod16x16`` and
    ``pod2x16x16`` (``fake_mesh``).  The cell is ``build_cell(arch_id,
    shape_name[, mesh])``, or ``cell`` (a cut one, one card), or
    ``cell_fn(mesh)`` (a cut one built on the mesh)."""
    mesh_name, n_chips = MESHES[multi_pod]
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch_id}__{shape_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "n_chips": n_chips}
    t0 = time.time()
    try:
        mesh = None if multi_pod is None else fake_mesh(multi_pod)
        if cell_fn is not None:
            cell = cell_fn(mesh)
        elif cell is None:
            cell = build_cell(arch_id, shape_name, mesh)
        rec["meta"] = {k: float(v) for k, v in cell.meta.items()}
        if cell.skip_reason:
            rec["skipped"] = cell.skip_reason
            rec["extra_cell"] = True   # run anyway, marked non-required
        rec.update(trace_cell(cell, n_chips))
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
    print(f"[{mesh_name}] {arch_id} x {shape_name}: {status} "
          f"({rec['wall_s']}s)", flush=True)
    return rec


def main(*, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of pod2x16x16 (default: of pod16x16)")
    ap.add_argument("--one-card", action="store_true",
                    help="the one-card program (h100x1)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    mp = None if args.one_card else args.multi_pod
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for arch_id, shape_name in cells:
        rec = run_cell(arch_id, shape_name, mp, out_dir=args.out,
                       force=args.force)
        n_fail += 0 if rec.get("ok") or rec.get("skipped") else 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
