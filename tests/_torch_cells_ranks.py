"""Rank processes of tests/test_torch_sharded_cells.py: the port's model
cells on a process-group mesh, one gloo rank a device, on the CPU.

``CASES`` names each cell cut to size (plain data, read by both sides:
``tests/_torch_cells_ref.py`` builds the reference's cell from it).  This
module imports neither JAX nor the JAX package: ``run(job)`` spawns the
ranks (start method "spawn", a ``FileStore`` in the job's directory),
and each rank, for every case of the job, builds the port's cell on the
mesh (``launch.cells.cell_for(..., mesh=)``), fills its argument blocks
from the reference's global arguments (``ref_args.npz``), checks every
block against the reference's device block at the rank's mesh
coordinates, runs the step ``steps`` times and gathers the outputs.
Rank 0 writes ``port.npz``: ``{case}|out{i}`` (the global outputs),
``{case}|blocks`` (the number of blocks checked on every rank), for a
decode ``{case}|records`` (its step's collectives, ``(KINDS index,
result bytes, group size)``) and ``{case}|weight_bytes``
(``layer_weight_bytes``) and, for
``DTENSOR_CASES``, ``{case}|dtensor``: the leaves whose DTensor block
(``distribute_tensor`` under ``core.distributed.placements`` of the
spec) was also checked against the reference's.  A rank that fails
fails the spawn.
"""

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESH_2x2 = ((2, 2), ("data", "model"))
MESH_POD = ((2, 1, 2), ("pod", "data", "model"))

WD = dict(n_sparse=4, vocab_per_field=64, embed_dim=8, n_dense=13,
          mlp=(32, 16), wide_vocab=256, n_wide_crosses=4)
LM_F32 = dict(vocab=512, dtype="float32")

SMOKE = {"qwen3-14b": "qwen3_14b", "arctic-480b": "arctic_480b",
         "grok-1-314b": "grok1_314b",
         "gin-tu": "gin_tu", "gat-cora": "gat_cora", "pna": "pna",
         "nequip": "nequip"}
# ogb_products cut to a few hundred nodes: the reference's cells shard
# the node-dim tensors there (mesh_axes, remat; bf16 for the GNNs)
PRODUCTS = dict(extra=dict(n_nodes=301, n_edges=1000, d_feat=16,
                           n_classes=7))

# name -> arch id, config overrides (over the smoke config for the LM
# and GNN archs, over the full one for Wide&Deep), shape name and
# overrides, mesh, steps
CASES = {
    "wd_train": dict(arch="wide-deep", config=WD, shape="train_batch",
                     shape_kw=dict(global_batch=8), mesh=MESH_2x2, steps=1),
    "wd_train_pod": dict(arch="wide-deep", config=WD, shape="train_batch",
                         shape_kw=dict(global_batch=8), mesh=MESH_POD,
                         steps=1),
    "wd_serve": dict(arch="wide-deep", config=WD, shape="serve_p99",
                     shape_kw=dict(global_batch=8), mesh=MESH_2x2, steps=1),
    "wd_retrieval": dict(arch="wide-deep", config=WD,
                         shape="retrieval_cand",
                         shape_kw=dict(extra=dict(n_candidates=1000)),
                         mesh=MESH_2x2, steps=1),
    "gin_train": dict(arch="gin-tu", config={}, shape="full_graph_sm",
                      shape_kw=dict(extra=dict(n_nodes=300, n_edges=1000,
                                               d_feat=16, n_classes=7)),
                      mesh=MESH_2x2, steps=1),
    "gin_products": dict(arch="gin-tu", config={}, shape="ogb_products",
                         shape_kw=PRODUCTS, mesh=MESH_2x2, steps=1),
    "gat_products": dict(arch="gat-cora", config={}, shape="ogb_products",
                         shape_kw=PRODUCTS, mesh=MESH_2x2, steps=1),
    "pna_products": dict(arch="pna", config={}, shape="ogb_products",
                         shape_kw=PRODUCTS, mesh=MESH_2x2, steps=1),
    "nequip_products": dict(arch="nequip", config={}, shape="ogb_products",
                            shape_kw=PRODUCTS, mesh=MESH_2x2, steps=1),
    # the same three GNN cells with float32 activations on both sides
    # (``float32``: the cell's step rebuilt with its config's dtype
    # float32), where the optimiser states are held as tightly as GIN's
    # full-graph cell's: bf16 sums reorder too far for a state check
    "gin_products_f32": dict(arch="gin-tu", config={}, shape="ogb_products",
                             shape_kw=PRODUCTS, mesh=MESH_2x2, steps=1,
                             float32=True),
    "gat_products_f32": dict(arch="gat-cora", config={},
                             shape="ogb_products", shape_kw=PRODUCTS,
                             mesh=MESH_2x2, steps=1, float32=True),
    "pna_products_f32": dict(arch="pna", config={}, shape="ogb_products",
                             shape_kw=PRODUCTS, mesh=MESH_2x2, steps=1,
                             float32=True),
    "qwen_train": dict(arch="qwen3-14b", config=LM_F32, shape="train_4k",
                       shape_kw=dict(global_batch=4, seq_len=16,
                                     microbatches=2),
                       mesh=MESH_2x2, steps=1),
    "qwen_train_pod": dict(arch="qwen3-14b", config=LM_F32,
                           shape="train_4k",
                           shape_kw=dict(global_batch=4, seq_len=16,
                                         microbatches=2),
                           mesh=MESH_POD, steps=1),
    # 2 x 256 tokens: a rank's FSDP group reads as many rows as the
    # vocabulary has, so the table's blocks are gathered, not the rows
    "qwen_prefill": dict(arch="qwen3-14b", config=LM_F32,
                         shape="prefill_32k",
                         shape_kw=dict(global_batch=2, seq_len=256),
                         mesh=MESH_2x2, steps=1),
    "qwen_decode": dict(arch="qwen3-14b", config=LM_F32, shape="decode_32k",
                        shape_kw=dict(global_batch=4, seq_len=16),
                        mesh=MESH_2x2, steps=1),
    "qwen_decode_b1": dict(arch="qwen3-14b", config=LM_F32,
                           shape="decode_32k",
                           shape_kw=dict(global_batch=1, seq_len=16),
                           mesh=MESH_2x2, steps=1),
    "arctic_train": dict(arch="arctic-480b", config=LM_F32,
                         shape="train_4k",
                         shape_kw=dict(global_batch=4, seq_len=8,
                                       microbatches=1),
                         mesh=MESH_2x2, steps=1),
    # d_ff sharded over model, each expert on every model rank
    # (expert_shard="ffn"), the int8 optimiser state
    "grok_train": dict(arch="grok-1-314b", config=LM_F32, shape="train_4k",
                       shape_kw=dict(global_batch=4, seq_len=8,
                                     microbatches=1),
                       mesh=MESH_2x2, steps=1),
    # the MoE decodes: arctic's experts over model, grok's d_ff over
    # model, the tokens routed as one group (the reference's decode
    # passes no mesh axes to the MoE); and a decode on the 3-axis mesh
    "arctic_decode": dict(arch="arctic-480b", config=LM_F32,
                          shape="decode_32k",
                          shape_kw=dict(global_batch=4, seq_len=16),
                          mesh=MESH_2x2, steps=1),
    "grok_decode": dict(arch="grok-1-314b", config=LM_F32,
                        shape="decode_32k",
                        shape_kw=dict(global_batch=4, seq_len=16),
                        mesh=MESH_2x2, steps=1),
    "qwen_decode_pod": dict(arch="qwen3-14b", config=LM_F32,
                            shape="decode_32k",
                            shape_kw=dict(global_batch=4, seq_len=16),
                            mesh=MESH_POD, steps=1),
    # 3 heads on the 2-way model axis (qwen3-14b's 40 on 16): the
    # attention weights gathered over model, each rank its padded group
    # of 2 heads, the last cut to 1
    "qwen_train_h3": dict(arch="qwen3-14b",
                          config=dict(LM_F32, n_heads=3, n_kv_heads=1),
                          shape="train_4k",
                          shape_kw=dict(global_batch=4, seq_len=16,
                                        microbatches=2),
                          mesh=MESH_2x2, steps=1),
    "qwen_prefill_h3": dict(arch="qwen3-14b",
                            config=dict(LM_F32, n_heads=3, n_kv_heads=1),
                            shape="prefill_32k",
                            shape_kw=dict(global_batch=2, seq_len=32),
                            mesh=MESH_2x2, steps=1),
    # 1 head on the 2-way model axis: model rank 1 computes none
    "qwen_train_h1": dict(arch="qwen3-14b",
                          config=dict(LM_F32, n_heads=1, n_kv_heads=1),
                          shape="train_4k",
                          shape_kw=dict(global_batch=4, seq_len=16,
                                        microbatches=2),
                          mesh=MESH_2x2, steps=1),
    # the head read from the embedding table, the logits' vocabulary
    # block sliced on each model rank
    "qwen_train_tied": dict(arch="qwen3-14b",
                            config=dict(LM_F32, tie_embeddings=True),
                            shape="train_4k",
                            shape_kw=dict(global_batch=4, seq_len=16,
                                          microbatches=2),
                            mesh=MESH_2x2, steps=1),
    "qwen_decode_tied": dict(arch="qwen3-14b",
                             config=dict(LM_F32, tie_embeddings=True),
                             shape="decode_32k",
                             shape_kw=dict(global_batch=4, seq_len=16),
                             mesh=MESH_2x2, steps=1),
}


def port_cell_spec(case: dict):
    """The port's (arch, shape) of a case, cut as ``CASES`` says."""
    import importlib

    from repro_torch.configs.registry import get_arch

    arch = get_arch(case["arch"])
    kw = dict(case["config"])
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    if arch.family in ("lm", "gnn", "nequip"):
        base = importlib.import_module(
            "repro_torch.configs." + SMOKE[case["arch"]]).smoke_config()
    else:
        base = arch.config
    shape = dataclasses.replace(arch.shape(case["shape"]), **case["shape_kw"])
    arch = dataclasses.replace(arch, config=dataclasses.replace(base, **kw),
                               shapes=(shape,))
    return arch, shape


def run(job: dict) -> None:
    mp.spawn(_main, args=(job,), nprocs=4, join=True)


def _out_leaves(out) -> list:
    from repro_torch.optim.tree import flatten

    items = out if isinstance(out, tuple) else (out,)
    return flatten([o.params() if hasattr(o, "params") else o
                    for o in items])


def gather_block(x, spec, mesh):
    """The global tensor of which ``x`` is this rank's block."""
    from repro_torch.core.collectives import all_gather

    for d, entry in enumerate(spec.parts):
        if entry is not None:
            x = all_gather(x.contiguous(), d, mesh.axis_group(entry))
    return x


def _main(rank: int, job: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(job["dir"], "store"), 4)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=4)
    out = {}
    try:
        ref = np.load(job["ref"])
        for name in job["cases"]:
            _case(name, CASES[name], ref, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(job["dir"], "port.npz"), **out)


DTENSOR_CASES = ("wd_train", "wd_train_pod", "qwen_train_pod")
KINDS = ("all-reduce", "all-gather", "reduce-scatter")   # record codes


def layer_weight_bytes(params, specs, cfg, mesh) -> int:
    """The whole bytes, in the compute dtype, of the layers' weights
    whose blocks ``params`` holds under ``specs``."""
    from repro_torch.core.distributed import global_shape
    from repro_torch.optim.tree import flatten, flatten_up_to

    size = torch.empty((), dtype=cfg.dtype).element_size()
    layers = params["layers"]
    return sum(math.prod(global_shape(x.shape, sp, mesh)) * size
               for x, sp in zip(flatten(layers),
                                flatten_up_to(layers, specs["layers"])))


def _case(name: str, case: dict, ref, out: dict) -> None:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.collectives import recording
    from repro_torch.core.distributed import local_block, make_mesh, \
        placements
    from repro_torch.launch.cells import cell_for, cell_leaves
    from repro_torch.optim.tree import flatten

    shape, axes = case["mesh"]
    mesh = make_mesh(shape, axes, devices=("cpu",) * 4,
                     group=dist.group.WORLD)
    arch, sh = port_cell_spec(case)
    cell = cell_for(arch, sh, mesh=mesh, device="cpu")
    if case.get("float32"):
        model = cell.args[0]
        model.cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    leaves = cell_leaves(cell)
    specs = flatten(list(cell.in_shardings))
    assert len(leaves) == len(specs), (name, len(leaves), len(specs))
    n_checked = 0
    with torch.no_grad():
        for i, (x, spec) in enumerate(zip(leaves, specs)):
            g = torch.from_numpy(ref[f"{name}|arg{i}"])
            block = local_block(g, spec, mesh)
            # the reference's block at this rank's mesh coordinates
            idx = ref[f"{name}|arg{i}|dev{mesh.rank}"]
            want = g[tuple(slice(int(a), int(b)) for a, b in idx)]
            assert torch.equal(block, want), (name, i)
            assert tuple(x.shape) == tuple(block.shape), (name, i)
            if name in DTENSOR_CASES and any(spec.parts):
                # DTensor's block under the spec's placements is the same
                dt = distribute_tensor(g, mesh.device_mesh,
                                       placements(spec, mesh.device_mesh))
                assert torch.equal(dt.to_local(), want), (name, i)
                n_dtensor = out.get(f"{name}|dtensor", 0) + 1
                out[f"{name}|dtensor"] = np.asarray(n_dtensor)
            x.copy_(block)
            n_checked += 1
    with recording() as records:
        for _ in range(case["steps"]):
            res = cell.fn(*cell.args)
    if sh.kind == "decode":
        # the step's collectives, and the bytes a step that gathered
        # the layers' weights would take in
        out[f"{name}|records"] = np.asarray(
            [(KINDS.index(k), n, g) for k, n, g in records], np.int64)
        out[f"{name}|weight_bytes"] = np.asarray(layer_weight_bytes(
            cell.args[0], cell.in_shardings[0], arch.config, mesh))
    for i, (x, spec) in enumerate(zip(_out_leaves(res),
                                      flatten(cell.out_shardings))):
        if not torch.is_tensor(x):
            x = torch.as_tensor(x)
        x = gather_block(x.detach(), spec, mesh)
        # bfloat16 as float32 (exact), as the reference's recording
        out[f"{name}|out{i}"] = (x.float() if x.dtype == torch.bfloat16
                                 else x).numpy()
    out[f"{name}|blocks"] = np.asarray(n_checked)


def run_psum(job: dict) -> None:
    """``compressed_psum(group=)`` on 2 ranks: rank r holds row r of
    each leaf of ``job["data"]`` (two steps, the reference's residual of
    the previous step carried in); rank 0 writes ``psum.npz``."""
    mp.spawn(_psum_main, args=(job,), nprocs=2, join=True)


def _psum_main(rank: int, job: dict) -> None:
    from repro_torch.optim.compress import compressed_psum

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(job["dir"], "psum_store"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    data, ref = np.load(job["data"]), np.load(job["ref"])
    out = {}
    try:
        for step in range(2):
            g = {k: torch.tensor(data[f"{k}{step}"][rank])
                 for k in ("a", "b")}
            carried = ({k: torch.tensor(ref[f"res_{k}{step - 1}"][rank])
                        for k in ("a", "b")} if step else None)
            mean, res = compressed_psum(g, "data", carried,
                                        group=dist.group.WORLD)
            for k in ("a", "b"):
                parts = [torch.empty_like(mean[k]) for _ in range(2)]
                dist.all_gather(parts, mean[k])
                out[f"mean_{k}{step}"] = torch.stack(parts).numpy()
                parts = [torch.empty_like(res[k]) for _ in range(2)]
                dist.all_gather(parts, res[k])
                out[f"res_{k}{step}"] = torch.stack(parts).numpy()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(job["dir"], "psum.npz"), **out)
