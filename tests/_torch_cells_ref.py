"""Subprocess helper of tests/test_torch_sharded_cells.py: the reference's
sharded model cells (``repro.launch.cells``) on 4 virtual CPU devices,
recorded for the port's ranks to be held against.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_cells_ref.py OUT_DIR CASE [CASE ...]

For every case of ``tests/_torch_cells_ranks.CASES`` named, the
reference's cell is built at the cut configuration on an ``Auto``-typed
mesh (JAX 0.9's default ``Explicit`` axes make ``constrain`` raise),
its arguments are drawn from fixed seeds (parameters from the
reference's init, batches from numpy, optimiser state zero), and the
jitted step runs ``steps`` times under the cell's shardings.  Writes
``OUT_DIR/ref_args.npz``: ``{case}|arg{i}`` (every global argument leaf,
in ``jax.tree.leaves`` order) and ``{case}|arg{i}|dev{k}`` (the
[start, stop) of every dim of the block device k holds, k the device's
row-major mesh position), and ``OUT_DIR/ref_out.npz``: ``{case}|out{i}``
(every global output leaf).
"""

import dataclasses
import importlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from _torch_cells_ranks import CASES, SMOKE  # noqa: E402


def _arch(case: dict):
    import jax.numpy as jnp

    from repro.configs.registry import get_arch

    arch = get_arch(case["arch"])
    kw = dict(case["config"])
    if "dtype" in kw:
        kw["dtype"] = getattr(jnp, kw["dtype"])
    if arch.family in ("lm", "gnn", "nequip"):
        base = importlib.import_module(
            "repro.configs." + SMOKE[case["arch"]]).smoke_config()
    else:
        base = arch.config
    shape = dataclasses.replace(arch.shape(case["shape"]), **case["shape_kw"])
    arch = dataclasses.replace(arch, config=dataclasses.replace(base, **kw),
                               shapes=(shape,))
    return arch, shape


def _args(arch, shape, cell, rng):
    """The cell's arguments, drawn from fixed seeds."""
    import jax

    from repro.models import transformer as tfm
    from repro.models.gnn import models as gnn
    from repro.models.recsys import wide_deep as wd
    from repro.optim import AdamWConfig, adamw_init

    key = jax.random.PRNGKey(3)
    cfg = arch.config
    if arch.family == "lm":
        params = tfm.init(key, cfg)
        if shape.kind == "train":
            ocfg = AdamWConfig(state_mode=arch.opt_state_mode)
            tokens = rng.integers(0, cfg.vocab, (shape.global_batch,
                                                 shape.seq_len))
            return (params, adamw_init(params, ocfg),
                    tokens.astype(np.int32))
        if shape.kind == "prefill":
            return (params, rng.integers(0, cfg.vocab, (
                shape.global_batch, shape.seq_len)).astype(np.int32))
        b, s = shape.global_batch, shape.seq_len
        kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        return (params,
                rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32),
                jax.numpy.asarray(rng.normal(size=kv), jax.numpy.bfloat16),
                jax.numpy.asarray(rng.normal(size=kv), jax.numpy.bfloat16),
                rng.integers(1, s - 1, (b,)).astype(np.int32))
    if arch.family == "recsys":
        if shape.kind == "retrieval":
            nc = cell.args[1].shape[0]
            return (rng.normal(size=(cfg.embed_dim,)).astype(np.float32),
                    rng.normal(size=(nc, cfg.embed_dim)).astype(np.float32))
        b = shape.global_batch
        wide = rng.integers(-1, cfg.wide_vocab, (b, cfg.n_wide_crosses))
        batch = {
            "sparse_ids": rng.integers(0, cfg.vocab_per_field,
                                       (b, cfg.n_sparse)).astype(np.int32),
            "dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            "wide_ids": wide.astype(np.int32),
            "labels": rng.integers(0, 2, (b,)).astype(np.int32)}
        params = wd.init(key, cfg)
        if shape.kind == "train":
            return (params, adamw_init(params, AdamWConfig(
                state_mode="factored")), batch)
        return (params, batch)
    # a GNN: the cell's own config (d_in and n_classes from the shape)
    ex = shape.extra
    e_pad = cell.args[2]["edge_src"].shape[0]
    n, e = ex["n_nodes"], ex["n_edges"]
    src = np.full(e_pad, -1, np.int32)
    dst = np.full(e_pad, -1, np.int32)
    src[:e] = rng.integers(0, n, e)
    dst[:e] = rng.integers(0, n, e)
    g = {"edge_src": src, "edge_dst": dst}
    if arch.family == "nequip":
        from repro.models.gnn import nequip as nq

        params = nq.init(key, cfg)
        g.update(species=rng.integers(0, cfg.n_species, n).astype(np.int32),
                 pos=(3 * rng.normal(size=(n, 3))).astype(np.float32),
                 energy=rng.normal(size=(1,)).astype(np.float32))
    else:
        gcfg = dataclasses.replace(cfg, d_in=ex["d_feat"],
                                   n_classes=ex["n_classes"])
        params = gnn.INITS[cfg.arch](key, gcfg)
        g.update(x=rng.normal(size=(n, ex["d_feat"])).astype(np.float32),
                 labels=rng.integers(0, ex["n_classes"], n).astype(np.int32))
    return (params, adamw_init(params, AdamWConfig(state_mode="fp32")), g)


def _float32_step(fn):
    """A GNN cell's step rebuilt with its config's activations in
    float32: the same config, loss, optimiser and learning rate, read
    from the step's closure (``make_gnn_train_step``)."""
    import jax.numpy as jnp

    from repro.launch.cells import make_gnn_train_step

    free = dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))
    return make_gnn_train_step(
        dataclasses.replace(free["cfg"], dtype=jnp.float32), free["loss"],
        free["ocfg"], free["lr"])


def _np(x):
    """A leaf as numpy; bfloat16 as float32 (exact), which npz keeps."""
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _index(sharding, shape, mesh) -> list:
    """Each device's block as [(start, stop), ...], row-major over the
    mesh."""
    by_dev = sharding.devices_indices_map(tuple(shape))
    out = []
    for dev in mesh.devices.reshape(-1):
        idx = by_dev[dev]
        out.append([(sl.start or 0, shape[d] if sl.stop is None else sl.stop)
                    for d, sl in enumerate(idx)] if idx else [])
    return out


def main(out_dir: str, names: list) -> None:
    import jax
    from jax.sharding import AxisType

    from repro.launch import cells as C

    builders = {"lm": C._lm_cell, "gnn": C._gnn_cell, "nequip": C._gnn_cell,
                "recsys": C._recsys_cell}
    args_out, outs = {}, {}
    for name in names:
        case = CASES[name]
        shape, axes = case["mesh"]
        mesh = jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(axes))
        arch, sh = _arch(case)
        cell = builders[arch.family](arch, sh, mesh)
        fn = _float32_step(cell.fn) if case.get("float32") else cell.fn
        args = _args(arch, sh, cell, np.random.default_rng(5))
        leaves = jax.tree.leaves(args)
        shard_leaves = jax.tree.leaves(
            cell.in_shardings,
            is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
        assert len(leaves) == len(shard_leaves), name
        for i, (x, shd) in enumerate(zip(leaves, shard_leaves)):
            x = _np(x)
            args_out[f"{name}|arg{i}"] = x
            for k, idx in enumerate(_index(shd, x.shape, mesh)):
                args_out[f"{name}|arg{i}|dev{k}"] = np.asarray(
                    idx, np.int64).reshape(-1, 2)
        with mesh:
            step = jax.jit(fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings)
            for _ in range(case["steps"]):
                res = step(*args)
                if sh.kind == "train":
                    args = (res[0], res[1]) + tuple(args[2:])
        for i, x in enumerate(jax.tree.leaves(res)):
            outs[f"{name}|out{i}"] = _np(x)
    np.savez(os.path.join(out_dir, "ref_args.npz"), **args_out)
    np.savez(os.path.join(out_dir, "ref_out.npz"), **outs)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
