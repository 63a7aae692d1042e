"""The port's capacity sharding (``repro_torch.core.distributed``,
``runtime.elastic``, ``launch.mesh``, ``checkpoint.reshard``) against
the JAX package.

The reference's ``build_sharded_tick`` runs on 4 virtual CPU devices in
one subprocess (``tests/_torch_dist_ref.py``; the device count must be
set before JAX starts, and this process keeps one device).  The port
runs the same cases on a mesh of ``("cpu",) * n`` — n logical shards on
the CPU — and must be bit-identical, tick by tick: every global state
leaf and every ``TickResult`` leaf, on REF, for n in {1, 2, 4}, with and
without a shared prefix view, overflow included.  Then:

* the shard-aware fold of a sharded state equals the unsharded engine's
  ``current_matches`` on every tick (``current_matches`` of the
  concatenated state misreads the shard-local ``parent`` pointers);
* ``scale_to_mesh`` 4 -> 2, 2 -> 4 and 4 -> 1 mid-stream reports the
  single-device JAX engine's matches tick by tick (the reference's
  blind re-split does not);
* checkpoints both ways: the reference's checkpoint of its sharded state
  restores into the port with ``mesh=``/``specs=`` and continues
  bit-identically, and the reverse;
* ``FaultTolerantLoop(mesh=, specs=)`` through a crash;
* the meshes (production, degraded) against the reference's shapes and
  axis names, and the errors.
"""

import os
import pathlib
import subprocess
import sys
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro.core import compile_plan as ref_compile_plan
from repro.core.engine import build_tick as ref_build_tick
from repro.core.state import init_state as ref_init_state
from repro.core.state import make_batch as ref_make_batch

import _torch_dist_ref as R
from _torch_util import assert_same_tree, leaves, port_query
from repro_torch.checkpoint import (
    reshard,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.distributed import (
    P,
    _sharded_current_matches,
    _state_specs,
    build_sharded_tick,
    make_mesh,
)
from repro_torch.core.engine import build_tick, current_matches
from repro_torch.core.multi import SlotTickCache
from repro_torch.core.plan import compile_plan
from repro_torch.core.share import SharedPrefixForest
from repro_torch.core.state import init_state, make_batch
from repro_torch.launch.mesh import engine_axes, make_production_mesh
from repro_torch.runtime.elastic import degraded_mesh, scale_to_mesh
from repro_torch.runtime.fault import FaultTolerantLoop, SimulatedFailure

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def mesh(n: int):
    return make_mesh((n,), ("data",), devices=(CPU,) * n)


def port_plan(query, window, cap):
    return compile_plan(port_query(query), window, **cap)


def port_batches(stream_cfg, batch):
    return [make_batch(**b, device=CPU) for b in R.batches(stream_cfg,
                                                           batch)]


def run_port(case: str, n: int, state=None, start: int = 0):
    """The port's sharded run of ``case`` on ``n`` CPU shards: yields
    (tick, state, result) after every tick from ``start``."""
    query, window, cap, scfg, bsz, _, prefix = R.CASES[case]
    plan = port_plan(query(), window, cap)
    forest = node = None
    depth = 0
    if prefix:
        forest = SharedPrefixForest(SlotTickCache(), "ref", device=CPU)
        leaf = forest.acquire(plan, epoch=0)
        node = leaf if prefix == "full" else leaf.parent
        depth = node.depth
    tick, s0 = build_sharded_tick(plan, mesh(n), extract_matches=True,
                                  prefix_depth=depth)
    state = s0 if state is None else state
    for t, batch in enumerate(port_batches(scfg, bsz)):
        if forest is not None:
            views, _ = forest.advance(batch)
        if t < start:
            continue
        if forest is None:
            state, res = tick(state, batch)
        else:
            state, res = tick(state, batch, views[node.pid])
        yield t, state, res


def assert_same_as_ref(ref, case, n, t, state, res):
    """Every leaf of the port's state and result after tick ``t`` equals
    the reference's recorded one."""
    for kind, tree in (("s", state), ("r", res)):
        got = leaves(tree)
        for i, y in enumerate(got):
            x = ref[R.key(case, n, t, kind, i)]
            where = f"{case} n={n} tick {t} {kind}{i}"
            assert x.shape == y.shape, f"{where}: {x.shape} vs {y.shape}"
            assert (x.dtype == np.bool_) == (y.dtype == np.bool_), where
            assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), \
                f"{where} differs"
        assert R.key(case, n, t, kind, len(got)) not in ref, \
            f"{case} n={n} tick {t}: the reference has more {kind} leaves"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's recorded runs (one subprocess), after the port's
    4-shard checkpoint of the checkpoint case has been written for it to
    restore."""
    out = tmp_path_factory.mktemp("torch_dist")
    for t, state, _ in run_port(R.CKPT_CASE, 4):
        if t + 1 == R.CKPT_TICK:
            save_checkpoint(str(out / "port_ckpt"), R.CKPT_TICK, state)
            break
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ref.py"),
         str(out)], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    assert "TORCH-DIST-REF-OK" in proc.stdout
    data = np.load(out / "ref.npz")
    yield {"arrays": {k: data[k] for k in data.files}, "dir": out}


SHARDED_CASES = [(c, n) for c, spec in R.CASES.items() if not spec[6]
                 for n in spec[5]]
PREFIX_CASES = [(c, n) for c, spec in R.CASES.items() if spec[6]
                for n in spec[5]]


@pytest.mark.parametrize("case,n", SHARDED_CASES,
                         ids=[f"{c}-n{n}" for c, n in SHARDED_CASES])
def test_sharded_tick_bit_identical_to_reference(ref, case, n):
    overflow = matches = 0
    for t, state, res in run_port(case, n):
        assert_same_as_ref(ref["arrays"], case, n, t, state, res)
        overflow = int(state.stats.n_overflow)
        matches = int(state.stats.n_matches_total)
    assert matches > 0, "the stream must produce matches"
    assert (overflow > 0) == case.startswith("overflow"), overflow


@pytest.mark.parametrize("case,n", PREFIX_CASES,
                         ids=[f"{c}-n{n}" for c, n in PREFIX_CASES])
def test_prefix_lift_bit_identical_to_reference(ref, case, n):
    """The shared prefix view replicated into every shard (full depth:
    the replicated-table ownership path through emission, and through
    the L0 joins for the two-chain; partial: suffix joins against a
    replicated parent view; the two-chain overflows, its replicated
    drops counted once)."""
    for t, state, res in run_port(case, n):
        assert_same_as_ref(ref["arrays"], case, n, t, state, res)
    assert int(state.stats.n_matches_total) > 0
    assert (int(state.stats.n_overflow) > 0) == (case == "prefix_two_chain")


def test_unsharded_and_one_shard_ticks_agree():
    """n = 1 is the unsharded tick, leaf for leaf."""
    query, window, cap, scfg, bsz, _, _ = R.CASES["serve_two_chain"]
    plan = port_plan(query(), window, cap)
    t1, s1 = build_tick(plan, device=CPU), init_state(plan, device=CPU)
    for t, state, res in run_port("serve_two_chain", 1):
        s1, r1 = t1(s1, port_batches(scfg, bsz)[t])
        assert_same_tree(s1, state, f"tick {t}")
        assert_same_tree(r1, res, f"tick {t} result")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_aware_fold_equals_unsharded_engine(n):
    """On every tick of the timed 2-edge chain: the fold of each shard's
    block equals the unsharded ``current_matches``; the concatenated
    arrays, whose shard-local pointers it misreads, differ on the ticks
    whose window holds a match (7 of 13 at n = 4, as the reference's
    state does)."""
    query, window, cap, scfg, bsz, _, _ = R.CASES["dist_chain2"]
    plan = port_plan(query(), window, cap)
    t1, s1 = build_tick(plan, device=CPU), init_state(plan, device=CPU)
    batches = port_batches(scfg, bsz)
    misread = nonempty = 0
    for t, state, _ in run_port("dist_chain2", n):
        s1, _ = t1(s1, batches[t])
        want = current_matches(plan, s1)
        assert _sharded_current_matches(plan, state, n) == want, t
        misread += current_matches(plan, state) != want
        nonempty += bool(want)
    assert len(batches) == 13 and nonempty == 7
    assert misread == (7 if n == 4 else 5)


# fact 3's stream: a timed 3-edge chain rescaled at batch 12 of 25
SCALE_QUERY = (lambda: R.QueryGraph(4, (0, 1, 0, 1), ((0, 1), (1, 2), (2, 3)),
                                    prec=frozenset({(0, 1), (1, 2)})))
SCALE_STREAM = dict(n_edges=400, n_vertices=8, n_vertex_labels=2,
                    n_edge_labels=1, seed=11, ts_step_max=2)
SCALE_CAP = dict(level_capacity=2048, l0_capacity=2048, max_new=512)
SCALE_AT = 12


def _rows(bind, ets, valid) -> Counter:
    bind, ets, valid = (np.asarray(x) for x in (bind, ets, valid))
    return Counter(tuple(map(int, b)) + tuple(map(int, e))
                   for b, e in zip(bind[valid], ets[valid]))


@pytest.fixture(scope="module")
def single_device_scale_run():
    """The single-device JAX engine's per-tick (count, match rows)."""
    plan = ref_compile_plan(SCALE_QUERY(), 60, **SCALE_CAP)
    tick = jax.jit(ref_build_tick(plan, extract_matches=True))
    state, out = ref_init_state(plan), []
    for b in R.batches(SCALE_STREAM, 16):
        state, res = tick(state, ref_make_batch(**b))
        out.append((int(res.n_new_matches),
                    _rows(res.match_bindings, res.match_ets,
                          res.match_valid)))
    assert int(state.stats.n_overflow) == 0
    return out


@pytest.mark.parametrize("n_old,n_new", [(4, 2), (2, 4), (4, 1)])
def test_scale_to_mesh_keeps_the_single_device_answer(
        single_device_scale_run, n_old, n_new):
    plan = port_plan(SCALE_QUERY(), 60, SCALE_CAP)
    m_old, m_new = mesh(n_old), mesh(n_new)
    tick_old, state = build_sharded_tick(plan, m_old, extract_matches=True)
    tick_new, _ = build_sharded_tick(plan, m_new, extract_matches=True)
    got = []
    for t, b in enumerate(port_batches(SCALE_STREAM, 16)):
        if t == SCALE_AT:
            state = scale_to_mesh(state, m_old, m_new,
                                  _state_specs(state, ("data",)))
        state, res = (tick_old if t < SCALE_AT else tick_new)(state, b)
        got.append((int(res.n_new_matches),
                    _rows(res.match_bindings, res.match_ets,
                          res.match_valid)))
    assert got == single_device_scale_run
    assert sum(c for c, _ in got[SCALE_AT:]) == 245
    assert int(state.stats.n_overflow) == 0


def test_scale_to_mesh_raises_when_a_shard_overflows():
    """Repacking onto more shards puts each chain on one shard: a shard
    that cannot hold its chains raises."""
    plan = port_plan(SCALE_QUERY(), 60, dict(
        level_capacity=64, l0_capacity=64, max_new=64))
    tick, state = build_sharded_tick(plan, mesh(1))
    for b in port_batches(SCALE_STREAM, 16)[:10]:
        state, _ = tick(state, b)
    live = int(state.levels[0][0].valid.sum())
    assert live > 16
    with pytest.raises(ValueError, match="capacity"):
        scale_to_mesh(state, mesh(1), mesh(4),
                      _state_specs(state, ("data",)))


def test_reference_checkpoint_restores_into_the_port(ref):
    """The reference's checkpoint of its 4-shard state (the concatenated
    global arrays) restores into the port onto a 4-shard mesh and
    continues bit-identically to the reference's run."""
    m = mesh(4)
    query, window, cap, _, _, _, _ = R.CASES[R.CKPT_CASE]
    _, like = build_sharded_tick(port_plan(query(), window, cap), m)
    state = restore_checkpoint(str(ref["dir"] / "jax_ckpt"), R.CKPT_TICK,
                               like, mesh=m,
                               specs=_state_specs(like, ("data",)))
    n = 0
    for t, state, res in run_port(R.CKPT_CASE, 4, state, R.CKPT_TICK):
        assert_same_as_ref(ref["arrays"], R.CKPT_CASE, 4, t, state, res)
        n += 1
    assert n > 3


def test_port_checkpoint_restores_into_the_reference(ref):
    """The reverse: the port's checkpoint, restored by the reference onto
    its 4-device mesh, continues as the port's own run does."""
    n = 0
    for t, state, res in run_port(R.CKPT_CASE, 4):
        if t >= R.CKPT_TICK:
            assert_same_as_ref(ref["arrays"], "rev", 4, t, state, res)
            n += 1
    assert n > 3


def test_fault_tolerant_loop_restores_onto_the_mesh(tmp_path):
    query, window, cap, scfg, bsz, _, _ = R.CASES["serve_chain3"]
    plan = port_plan(query(), window, cap)
    m = mesh(4)
    tick, s0 = build_sharded_tick(plan, m)
    specs = _state_specs(s0, ("data",))
    batches = port_batches(scfg, bsz)
    crashed = []

    def step(state, i):
        if i == 9 and not crashed:
            crashed.append(i)
            raise SimulatedFailure("crash after tick 9")
        return tick(state, batches[i])[0]

    def init():
        return build_sharded_tick(plan, m)[1]

    loop = FaultTolerantLoop(str(tmp_path), step, init, ckpt_every=4,
                             mesh=m, specs=specs)
    got = loop.run(len(batches))
    want = s0
    for b in batches:
        want, _ = tick(want, b)
    assert loop.restarts == 1 and crashed == [9]
    assert_same_tree(want, got, "after crash + restore")
    assert int(got.stats.n_matches_total) > 0


def test_reshard_places_and_checks_the_split(tmp_path):
    m = mesh(4)
    tree = {"table": np.arange(8, dtype=np.int32),
            "clock": torch.tensor(3, dtype=torch.int32)}
    specs = {"table": P(("data",)), "clock": P()}
    out = reshard(tree, m, specs)
    assert torch.equal(out["table"], torch.arange(8, dtype=torch.int32))
    assert out["clock"].device == torch.device(CPU)
    with pytest.raises(ValueError, match="not divisible"):
        reshard({"table": torch.zeros(6)}, m, {"table": P("data")})
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="both"):
        restore_checkpoint(str(tmp_path), 1, tree, mesh=m)


def test_meshes_match_the_reference(monkeypatch):
    """Shapes and axis names of the production meshes, ``engine_axes``
    and ``degraded_mesh``, against the reference's (its meshes built
    abstractly: this process has one device)."""
    import repro.launch.mesh as ref_mesh
    import repro.runtime.elastic as ref_elastic

    def no_cuda(*args):
        raise AssertionError("a mesh of listed devices touched CUDA")

    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(jax, "make_mesh", jax.sharding.AbstractMesh)
    for multi_pod, n_dev in ((False, 256), (True, 512)):
        want = ref_mesh.make_production_mesh(multi_pod=multi_pod)
        got = make_production_mesh(multi_pod=multi_pod,
                                   devices=(CPU,) * n_dev)
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
        assert engine_axes(got) == ref_mesh.engine_axes(want)
    monkeypatch.setattr(jax.sharding, "Mesh",
                        lambda arr, names: (arr.shape, tuple(names)))
    for n_dev, shape, names, drop in [
            (256, (16, 16), ("data", "model"), 16),
            (256, (16, 16), ("data", "model"), 0),
            (8, (4, 2), ("data", "model"), 3),
            (512, (2, 16, 16), ("pod", "data", "model"), 10)]:
        want = ref_elastic.degraded_mesh(list(range(n_dev)), shape, names,
                                         drop)
        got = degraded_mesh((CPU,) * n_dev, shape, names, drop)
        assert (got.devices.shape, got.axis_names) == want
    with pytest.raises(ValueError, match="not enough"):
        degraded_mesh((CPU,) * 8, (4, 4), ("data", "model"), 5)


def test_mesh_errors():
    """Capacity that n does not divide, too few devices, and a mesh of
    distinct devices (a later item: it has never run)."""
    query, window, _, _, _, _, _ = R.CASES["dist_chain2"]
    plan = port_plan(query(), window, R.DIST_CAP)
    with pytest.raises(ValueError, match="divisible"):
        build_sharded_tick(plan, make_mesh((3,), ("data",),
                                           devices=(CPU,) * 3))
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=(CPU,) * 255)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=(CPU,) * 3)
    with pytest.raises(NotImplementedError, match="distinct"):
        make_mesh((2,), ("data",), devices=(CPU, "meta"))
    two = make_mesh((2, 2), ("pod", "data"), devices=(CPU,) * 4)
    tick, state = build_sharded_tick(plan, two, axes=("pod", "data"))
    assert _state_specs(state, ("pod", "data")).levels[0][0].src \
        .shards(two) == 4
    assert state.levels[0][0].src.shape == (R.DIST_CAP["level_capacity"],)
