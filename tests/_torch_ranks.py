"""Rank processes of tests/test_torch_ranks.py: the port's two meshes over
a ``torch.distributed`` gloo group, one process a rank, on the CPU.

This module imports neither JAX nor the JAX package: the test hands
every input over as plain data (query specs, stream batches as numpy
dicts, edge tuples) and compares what the ranks write with the
reference's recording.  ``run(world, job)`` spawns ``world`` ranks
(start method "spawn"), which meet through a ``FileStore`` in the job's
directory, run every part of ``job`` and each write
``w{world}_r{rank}.npz`` (arrays) and ``w{world}_r{rank}.pkl`` (match
reports).  A rank that fails fails the spawn.
"""

import os
import pickle
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CPU = "cpu"


def run(world: int, job: dict) -> None:
    mp.spawn(_main, args=(world, job), nprocs=world, join=True)


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree.detach().cpu().numpy() if torch.is_tensor(tree)
            else np.asarray(tree)]


def _record(out: dict, prefix: str, state, res=None) -> None:
    for kind, tree in (("s", state), ("r", res)):
        if tree is not None:
            for i, x in enumerate(_leaves(tree)):
                out[f"{prefix}|{kind}{i}"] = x


def _main(rank: int, world: int, job: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(job["dir"], f"store{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    arrays, reports = {}, {}
    try:
        _capacity(rank, world, job, arrays)
        _replicas(rank, world, job, reports)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(job["dir"], f"w{world}_r{rank}.npz"), **arrays)
    with open(os.path.join(job["dir"], f"w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(reports, f)


# --------------------------------------------------------------------- #
# capacity sharding: repro_torch.core.distributed on a process group
# --------------------------------------------------------------------- #
def _plan(spec: dict):
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.query import QueryGraph

    return compile_plan(QueryGraph.from_spec(spec["query"]), spec["window"],
                        **spec["cap"])


def _batches(spec: dict) -> list:
    from repro_torch.core.state import make_batch

    return [make_batch(**b, device=CPU) for b in spec["batches"]]


def _mesh(n: int, group=None):
    from repro_torch.core.distributed import make_mesh

    return make_mesh((n,), ("data",), devices=(CPU,) * n,
                     group=dist.group.WORLD if group is None else group)


def _case_run(spec: dict, mesh, state=None, start: int = 0):
    """Yields (tick, state, result) of ``spec``'s stream on ``mesh``,
    from tick ``start`` (the forest, when there is one, advances on
    every tick)."""
    from repro_torch.core.distributed import build_sharded_tick
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.share import SharedPrefixForest

    plan = _plan(spec)
    forest = node = None
    depth = 0
    if spec["prefix"]:
        forest = SharedPrefixForest(SlotTickCache(), "ref", device=CPU)
        leaf = forest.acquire(plan, epoch=0)
        node = leaf if spec["prefix"] == "full" else leaf.parent
        depth = node.depth
    tick, s0 = build_sharded_tick(plan, mesh, extract_matches=True,
                                  prefix_depth=depth)
    state = s0 if state is None else state
    for t, batch in enumerate(_batches(spec)):
        if forest is not None:
            views, _ = forest.advance(batch)
        if t < start:
            continue
        if forest is None:
            state, res = tick(state, batch)
        else:
            state, res = tick(state, batch, views[node.pid])
        yield t, state, res


def _specs(state):
    from repro_torch.core.distributed import _state_specs

    return _state_specs(state, ("data",))


def _capacity(rank: int, world: int, job: dict, out: dict) -> None:
    from repro_torch.checkpoint import (
        mesh_save_kwargs,
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.core.distributed import (
        _sharded_current_matches,
        build_sharded_tick,
    )
    from repro_torch.runtime.elastic import scale_to_mesh
    from repro_torch.runtime.fault import FaultTolerantLoop, SimulatedFailure

    mesh = _mesh(world)
    ck = job["ckpt"]
    calls = _count_collectives()
    for name, spec in job["cases"].items():
        calls.clear()
        for t, state, res in _case_run(spec, mesh):
            _record(out, f"{name}|t{t}", state, res)
            if name == ck["case"] and t + 1 == ck["tick"] and world == 4:
                save_checkpoint(ck["ranks"], ck["tick"], state,
                                **mesh_save_kwargs(state, mesh,
                                                   _specs(state)))
        out[f"{name}|collectives"] = np.array(
            [calls["all_gather_into_tensor"], calls["all_reduce"], t + 1])
        if spec["prefix"]:
            continue            # the fold reads whole chains
        out[f"{name}|fold"] = np.array(sorted(
            repr(sorted(m)) for m in _sharded_current_matches(
                _plan(spec), state, world, group=dist.group.WORLD)))

    spec = job["cases"][ck["case"]]
    plan = _plan(spec)
    _, like = build_sharded_tick(plan, mesh)
    if world == 4:
        # the reference's single-file checkpoint of its 4-device state,
        # restored onto 4 ranks
        state = restore_checkpoint(ck["jax"], ck["tick"], like, mesh=mesh,
                                   specs=_specs(like))
        for t, state, res in _case_run(spec, mesh, state, ck["tick"]):
            _record(out, f"jax_on_ranks|t{t}", state, res)
    else:
        # the 4-rank checkpoint on 2 ranks: the global state read on each
        # rank, re-homed onto 2 shards, each rank keeping its block
        from repro_torch.core.state import init_state

        full = restore_checkpoint(ck["ranks"], ck["tick"],
                                  init_state(plan, device=CPU))
        four = _one_process_mesh(4)
        state = scale_to_mesh(full, four, mesh, _specs(full))
        for t, state, res in _case_run(spec, mesh, state, ck["tick"]):
            _record(out, f"ranks4_on_2|t{t}", None, res)

    if world == 4:
        _scale(rank, job["scale"], out)
        # a crash after tick 9 on every rank, restored from step 8
        batches = _batches(spec)
        tick, _ = build_sharded_tick(plan, mesh)
        crashed = []

        def step(state, i):
            if i == 9 and not crashed:
                crashed.append(i)
                raise SimulatedFailure("crash after tick 9")
            return tick(state, batches[i])[0]

        loop = FaultTolerantLoop(
            ck["fault"], step, lambda: build_sharded_tick(plan, mesh)[1],
            ckpt_every=4, mesh=mesh, specs=_specs(like))
        got = loop.run(len(batches))
        assert loop.restarts == 1 and crashed == [9]
        _record(out, "fault", got)


def _count_collectives() -> Counter:
    """Count this process's tensor collectives by name from now on."""
    calls = Counter()
    for name in ("all_gather_into_tensor", "all_reduce"):
        real = getattr(dist, name)

        def counted(*a, real=real, name=name, **k):
            calls[name] += 1
            return real(*a, **k)
        setattr(dist, name, counted)
    return calls


def _one_process_mesh(n: int):
    from repro_torch.core.distributed import make_mesh

    return make_mesh((n,), ("data",), devices=(CPU,) * n)


def _scale(rank: int, spec: dict, out: dict) -> None:
    """``scale_to_mesh`` from the 4 ranks onto a group of ranks 0 and 1
    before tick ``spec["at"]``; ranks 2 and 3 drop out."""
    from repro_torch.core.distributed import build_sharded_tick

    plan = _plan(spec)
    old = _mesh(4)
    sub = dist.new_group([0, 1])
    new = _mesh(2, sub)
    tick_old, state = build_sharded_tick(plan, old, extract_matches=True)
    tick_new = build_sharded_tick(plan, new, extract_matches=True)[0] \
        if new.rank is not None else None
    from repro_torch.runtime.elastic import scale_to_mesh

    specs = _specs(state)
    for t, b in enumerate(_batches(spec)):
        if t == spec["at"]:
            state = scale_to_mesh(state, old, new, specs)
            if state is None:
                return
        state, res = (tick_old if t < spec["at"] else tick_new)(state, b)
        _record(out, f"scale|t{t}", None, res)
    _record(out, "scale|end", state)


# --------------------------------------------------------------------- #
# replica sharding: ShardedSearchService over a process group
# --------------------------------------------------------------------- #
def _event_key(plan, b, t) -> frozenset:
    q = plan.query
    vslot = {v: s for s, v in enumerate(plan.final_vertex_layout)}
    epos = {e: s for s, e in enumerate(plan.final_edge_layout)}
    return frozenset(
        (eid, (int(b[vslot[q.edges[eid][0]]]), int(b[vslot[q.edges[eid][1]]]),
               int(t[epos[eid]])))
        for eid in range(q.n_edges))


def _serve(svc, edges, serve: dict) -> Counter:
    events = []

    def on_match(qid, bindings, ets):
        plan = svc.registry.get(qid).plan
        events.extend((qid, _event_key(plan, b, t))
                      for b, t in zip(bindings, ets))

    svc.serve_stream(edges, on_match=on_match, **serve)
    return Counter(events)


def _replicas(rank: int, world: int, job: dict, out: dict) -> None:
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.oracle import DataEdge
    from repro_torch.core.query import QueryGraph
    from repro_torch.runtime.mesh import ShardedSearchService

    rj = job["replicas"]
    edges = [DataEdge(*e) for e in rj["edges"]]
    first, rest = edges[:rj["half"]], edges[rj["half"]:]
    queries = [QueryGraph.from_spec(q) for q in rj["queries"]]
    group = dist.group.WORLD

    def churn(svc, qids):
        svc.unregister(qids[1])
        svc.unregister(qids[4])
        svc.register(QueryGraph.from_spec(rj["late"]), rj["window"])

    for n_rep, spr in rj["meshes"][world]:
        ckpt = os.path.join(job["dir"], f"svc_w{world}_R{n_rep}")
        svc = ShardedSearchService(
            n_rep, spr, device=CPU, group=group, tick_cache=SlotTickCache(),
            enable_sharing=True, ckpt_dir=ckpt, **rj["cap"])
        qids = [svc.register(q, rj["window"]) for q in queries]
        count = _serve(svc, first, rj["serve"])
        svc.checkpoint()
        svc.ckpt.wait()
        churn(svc, qids)
        count += _serve(svc, rest, rj["serve"])
        out[f"R{n_rep}"] = count
        out[f"R{n_rep}|stats"] = svc.last_mesh_stats()
        out[f"R{n_rep}|local"] = list(svc.local)
    from repro_torch.api.session import StreamSession

    sess = StreamSession(mesh={"n_replicas": 2 * world,
                               "slots_per_replica": 1},
                         device=CPU, group=group, **rj["cap"])
    out["session"] = (type(sess.service).__name__,
                      sess.service.group is group, list(sess.service.local))
    if world == 2:
        # the 4-rank, 8-replica checkpoint: onto 8 replicas on 2 ranks
        # (each rank reads its own replicas' rows) and onto 2 replicas
        # (the repack), then the churn and the second half
        src = os.path.join(job["dir"], "svc_w4_R8")
        for n_rep in (8, 2):
            svc = ShardedSearchService.restore(
                src, n_replicas=n_rep, tick_cache=SlotTickCache(),
                device=CPU, group=group)
            qids = sorted(svc.registry.qids())
            churn(svc, qids)
            out[f"restored_R{n_rep}"] = _serve(svc, rest, rj["serve"])
