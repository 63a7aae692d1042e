"""The port's two meshes over a ``torch.distributed`` process group — one
process a rank, gloo on the CPU — against the reference's multi-device
run.

The reference's recording is the one tests/test_torch_distributed.py
reads (``tests/_torch_dist_ref.py``: ``repro.core.distributed.
build_sharded_tick`` on 4 virtual devices, the global state and
``TickResult`` after every tick).  The ranks run in spawned processes
(``tests/_torch_ranks.py``, which imports no JAX), once for 4 ranks and
once for 2, every case in one spawn; they write what they held, and the
tests compare it here.  Every comparison is an equality:

* capacity ranks: for every case of ``_torch_dist_ref.CASES`` (the
  prefix lifts included) at n = 2 and 4, rank k's leaves after every
  tick are block k of the reference's global leaves, bit for bit; the
  ``TickResult`` scalars are the reference's on every rank and its match
  rows are block k of the reference's; the shard-aware fold gathered
  over the group is the one-process mesh's;
* checkpoints: the 4 ranks' rank-written checkpoint restores onto the
  one-process mesh and continues as the reference does, and saved again
  it is the one-process mesh's own single-file checkpoint, key for key
  (which the reference restores: test_torch_distributed.py); the
  reference's checkpoint restores onto 4 ranks; the 4-rank checkpoint
  restores onto 2 ranks (re-homed) and reports the reference's matches;
* ``scale_to_mesh`` from 4 ranks onto a group of 2 mid-stream reports
  the single-device JAX engine's matches tick by tick;
* ``FaultTolerantLoop`` on 4 ranks through a crash ends in the
  reference's final state;
* replica ranks: ``ShardedSearchService(group=)`` at R = 4 and 8 on 2
  and 4 ranks under churn with prefix sharing: the union of the ranks'
  reported matches is the JAX single-device service's multiset; the 4
  ranks' 8-replica checkpoint restored on 2 ranks (8 replicas, and a
  repack onto 2) reports the reference's second half.
"""

import os
import pickle
from collections import Counter

import numpy as np
import pytest

from repro.core.multi import SlotTickCache as RefSlotTickCache
from repro.runtime.service import ContinuousSearchService as RefService

import _torch_dist_ref as R
import _torch_ranks
from _torch_util import port_query, served_reports
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.distributed import (
    _sharded_current_matches,
    _state_specs,
    build_sharded_tick,
)
from test_share import W, chain2, chain2_other_labels, chain3, fork, \
    stream160, tri
from test_torch_distributed import (  # noqa: F401  (module fixtures)
    SCALE_AT,
    SCALE_CAP,
    SCALE_QUERY,
    SCALE_STREAM,
    assert_same_as_ref,
    mesh,
    port_plan,
    ref,
    run_port,
    single_device_scale_run,
)

WORLDS = (4, 2)          # 4 first: the 2-rank run restores its checkpoint
CASES = list(R.CASES)
SVC_CAP = dict(level_capacity=256, l0_capacity=256, max_new=128)
SVC_SERVE = dict(batch_size=16, min_batch=16, max_batch=16)
SVC_QUERIES = [chain3(), chain2(), chain2(), chain2_other_labels(), fork(),
               tri()]
SVC_HALF = 80
SVC_MESHES = {2: [(4, 2), (8, 1)], 4: [(4, 2), (8, 1)]}


def _case_spec(case: str) -> dict:
    query, window, cap, scfg, bsz, _, prefix = R.CASES[case]
    return {"query": query().to_spec(), "window": window, "cap": cap,
            "batches": R.batches(scfg, bsz), "prefix": prefix}


def _edges(stream) -> list:
    return [(e.src, e.dst, e.ts, e.src_label, e.dst_label, e.edge_label)
            for e in stream]


@pytest.fixture(scope="module")
def ranks(ref):
    """Both spawns' outputs: ``{world: [per rank (arrays, reports)]}``."""
    out = ref["dir"] / "ranks"
    out.mkdir()
    scale = {"query": SCALE_QUERY().to_spec(), "window": 60,
             "cap": SCALE_CAP, "batches": R.batches(SCALE_STREAM, 16),
             "prefix": None, "at": SCALE_AT}
    job = {
        "dir": str(out),
        "cases": {c: _case_spec(c) for c in CASES},
        "ckpt": {"case": R.CKPT_CASE, "tick": R.CKPT_TICK,
                 "jax": str(ref["dir"] / "jax_ckpt"),
                 "ranks": str(out / "ranks_ckpt"),
                 "fault": str(out / "fault_ckpt")},
        "scale": scale,
        "replicas": {"queries": [q.to_spec() for q in SVC_QUERIES],
                     "late": chain2().to_spec(), "window": W,
                     "edges": _edges(stream160()), "half": SVC_HALF,
                     "cap": SVC_CAP, "serve": SVC_SERVE,
                     "meshes": SVC_MESHES},
    }
    got = {}
    for world in WORLDS:
        _torch_ranks.run(world, job)
        got[world] = []
        for r in range(world):
            data = np.load(out / f"w{world}_r{r}.npz")
            arrays = {k: data[k] for k in data.files}
            with open(out / f"w{world}_r{r}.pkl", "rb") as f:
                reports = pickle.load(f)
            got[world].append((arrays, reports))
    yield {"ranks": got, "dir": out, "job": job}


def _block(x: np.ndarray, k: int, n: int) -> np.ndarray:
    if x.ndim == 0:
        return x
    c = x.shape[0] // n
    return x[k * c:(k + 1) * c]


def _assert_block(ref_arrays, case, n, t, k, arrays, prefix):
    """Rank k's leaves after tick t are block k of the reference's."""
    i = 0
    for kind in ("s", "r"):
        i = 0
        while R.key(case, n, t, kind, i) in ref_arrays:
            x = _block(ref_arrays[R.key(case, n, t, kind, i)], k, n)
            y = arrays[f"{prefix}|{kind}{i}"]
            where = f"{case} n={n} tick {t} rank {k} {kind}{i}"
            assert x.shape == y.shape, f"{where}: {x.shape} vs {y.shape}"
            assert (x.dtype == np.bool_) == (y.dtype == np.bool_), where
            assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), \
                f"{where} differs"
            i += 1
        assert f"{prefix}|{kind}{i}" not in arrays, where
    return i


def _ticks(case: str) -> int:
    query, window, cap, scfg, bsz, _, _ = R.CASES[case]
    return len(R.batches(scfg, bsz))


RANK_CASES = [(c, n) for c in CASES for n in (2, 4)]


@pytest.mark.parametrize("case,n", RANK_CASES,
                         ids=[f"{c}-n{n}" for c, n in RANK_CASES])
def test_rank_blocks_equal_the_reference(ref, ranks, case, n):
    """Every tick, every rank: its shard is block k of the reference's
    global state, its result the reference's scalars and block k of its
    match rows; overflow only where the case overflows by design."""
    assert n in R.CASES[case][5]
    per_rank = ranks["ranks"][n]
    for t in range(_ticks(case)):
        for k, (arrays, _) in enumerate(per_rank):
            _assert_block(ref["arrays"], case, n, t, k, arrays,
                          f"{case}|t{t}")
    last = R.key(case, n, _ticks(case) - 1, "s", 0)
    assert last in ref["arrays"]
    overflowing = case in ("overflow_two_chain", "prefix_two_chain")
    # stats are the state's last five leaves: n_matches_total first
    n_leaves = sum(1 for i in range(999)
                   if R.key(case, n, 0, "s", i) in ref["arrays"])
    matches = per_rank[0][0][f"{case}|t{_ticks(case) - 1}|s{n_leaves - 5}"]
    overflow = per_rank[0][0][f"{case}|t{_ticks(case) - 1}|s{n_leaves - 4}"]
    assert int(matches) > 0
    assert (int(overflow) > 0) == overflowing, int(overflow)


@pytest.mark.parametrize("n", [2, 4])
def test_rank_collectives_per_tick_are_the_references(ranks, n):
    """A tick issues the reference's collectives: 2·(k−1) gathers of
    compacted deltas (one fewer when subquery 0 is fully prefixed: its
    delta is replicated, as in the reference) and its scalar psums as one
    all-reduce."""
    for case in CASES:
        query, window, cap, _, _, _, prefix = R.CASES[case]
        k = len(port_plan(query(), window, cap).subqueries)
        gathers = 2 * (k - 1) - (prefix == "full" and k > 1)
        for arrays, _ in ranks["ranks"][n]:
            g, r, ticks = arrays[f"{case}|collectives"]
            assert (g, r) == (gathers * ticks, ticks), case


@pytest.mark.parametrize("n", [2, 4])
def test_rank_fold_is_the_one_process_fold(ranks, n):
    """``_sharded_current_matches(group=)`` gathers every rank's fold:
    the same set on every rank, the one-process mesh's."""
    for case in CASES:
        if R.CASES[case][6]:
            continue
        state = None
        for _, state, _ in run_port(case, n):
            pass
        query, window, cap, _, _, _, _ = R.CASES[case]
        want = sorted(repr(sorted(m)) for m in _sharded_current_matches(
            port_plan(query(), window, cap), state, n))
        for arrays, _ in ranks["ranks"][n]:
            assert list(arrays[f"{case}|fold"]) == want, case


def test_rank_checkpoint_restores_onto_the_one_process_mesh(ref, ranks):
    """The 4 ranks' files (one block each, one manifest) restore onto the
    one-process 4-shard mesh and continue as the reference does; saved
    again, they are the one-process mesh's own checkpoint of that tick,
    key for key — the single-file format the reference restores."""
    m = mesh(4)
    query, window, cap, _, _, _, _ = R.CASES[R.CKPT_CASE]
    _, like = build_sharded_tick(port_plan(query(), window, cap), m)
    src = ranks["job"]["ckpt"]["ranks"]
    assert sorted(os.listdir(src)) == [
        f"step_{R.CKPT_TICK}.json"] + [
        f"step_{R.CKPT_TICK}.shard{r}of4.npz" for r in range(4)]
    state = restore_checkpoint(src, R.CKPT_TICK, like, mesh=m,
                               specs=_state_specs(like, ("data",)))
    again = ranks["dir"] / "again"
    save_checkpoint(str(again), R.CKPT_TICK, state)
    own = ranks["dir"] / "own"
    for t, s, _ in run_port(R.CKPT_CASE, 4):
        if t + 1 == R.CKPT_TICK:
            save_checkpoint(str(own), R.CKPT_TICK, s)
            break
    a = np.load(again / f"step_{R.CKPT_TICK}.npz")
    b = np.load(own / f"step_{R.CKPT_TICK}.npz")
    assert a.files == b.files
    for key in a.files:
        assert np.array_equal(a[key], b[key]), key
    n = 0
    for t, state, res in run_port(R.CKPT_CASE, 4, state, R.CKPT_TICK):
        assert_same_as_ref(ref["arrays"], R.CKPT_CASE, 4, t, state, res)
        n += 1
    assert n > 3


def test_reference_checkpoint_restores_onto_ranks(ref, ranks):
    """The reference's checkpoint of its 4-device state, each rank
    reading its rows, continues as the reference's run, rank by rank."""
    for t in range(R.CKPT_TICK, _ticks(R.CKPT_CASE)):
        for k, (arrays, _) in enumerate(ranks["ranks"][4]):
            _assert_block(ref["arrays"], R.CKPT_CASE, 4, t, k, arrays,
                          f"jax_on_ranks|t{t}")


def _reported(arrays_per_rank, prefix) -> tuple[int, Counter]:
    """(new matches, Counter of match rows) of one tick over ranks."""
    count, rows = None, Counter()
    for arrays in arrays_per_rank:
        n_new = int(arrays[f"{prefix}|r0"])
        assert count in (None, n_new), "the ranks disagree on n_new"
        count = n_new
        b, e, v = (arrays[f"{prefix}|r{i}"] for i in (2, 3, 4))
        rows += Counter(tuple(map(int, x)) + tuple(map(int, y))
                        for x, y in zip(b[v], e[v]))
    return count, rows


def test_four_rank_checkpoint_restores_onto_two_ranks(ref, ranks):
    """Re-homed onto 2 shards (every chain on one), the 4-rank checkpoint
    reports on 2 ranks what the reference's 4 devices report."""
    for t in range(R.CKPT_TICK, _ticks(R.CKPT_CASE)):
        count, rows = _reported([a for a, _ in ranks["ranks"][2]],
                                f"ranks4_on_2|t{t}")
        want = _reported([{f"x|r{i}": _block(
            ref["arrays"][R.key(R.CKPT_CASE, 4, t, "r", i)], k, 4)
            for i in range(5)} for k in range(4)], "x")
        assert (count, rows) == want, t


def test_scale_to_mesh_across_ranks_keeps_the_single_device_answer(
        ranks, single_device_scale_run):
    """4 ranks -> a group of 2 before batch 12 of 25: the matches of
    every tick are the single-device JAX engine's."""
    arrays = [a for a, _ in ranks["ranks"][4]]
    for t, want in enumerate(single_device_scale_run):
        on = arrays if t < SCALE_AT else arrays[:2]
        assert _reported(on, f"scale|t{t}") == want, t
        if t >= SCALE_AT:
            assert all(f"scale|t{t}|r0" not in a for a in arrays[2:])
    assert sum(c for c, _ in single_device_scale_run[SCALE_AT:]) == 245


def test_fault_tolerant_loop_on_ranks(ref, ranks):
    """A crash after tick 9 on all 4 ranks, restored from step 8: each
    rank ends in block k of the reference's final state."""
    last = _ticks(R.CKPT_CASE) - 1
    for k, (arrays, _) in enumerate(ranks["ranks"][4]):
        i = 0
        while R.key(R.CKPT_CASE, 4, last, "s", i) in ref["arrays"]:
            x = _block(ref["arrays"][R.key(R.CKPT_CASE, 4, last, "s", i)],
                       k, 4)
            assert np.array_equal(x.astype(np.int64),
                                  arrays[f"fault|s{i}"].astype(np.int64)), i
            i += 1
    files = os.listdir(ranks["job"]["ckpt"]["fault"])
    assert "step_8.shard3of4.npz" in files


@pytest.fixture(scope="module")
def service_reference():
    """The JAX single-device service over the churn scenario: reports of
    the first half and of the second."""
    svc = RefService(slots_per_group=8, tick_cache=RefSlotTickCache(),
                     enable_sharing=True, **SVC_CAP)
    stream = stream160()
    qids = [svc.register(q, W) for q in SVC_QUERIES]
    first, _, _ = served_reports(svc, stream[:SVC_HALF], **SVC_SERVE)
    svc.unregister(qids[1])
    svc.unregister(qids[4])
    svc.register(chain2(), W)
    rest, _, _ = served_reports(svc, stream[SVC_HALF:], **SVC_SERVE)
    assert first and rest
    return first, rest


SVC_RUNS = [(w, r) for w in (2, 4) for r, _ in SVC_MESHES[w]]


@pytest.mark.parametrize("world,n_rep", SVC_RUNS,
                         ids=[f"R{r}-w{w}" for w, r in SVC_RUNS])
def test_replica_ranks_equal_the_single_device_service(
        ranks, service_reference, world, n_rep):
    first, rest = service_reference
    per_rank = [rep for _, rep in ranks["ranks"][world]]
    union = sum((rep[f"R{n_rep}"] for rep in per_rank), Counter())
    assert union == first + rest
    held = [rep[f"R{n_rep}|local"] for rep in per_rank]
    assert sorted(r for h in held for r in h) == list(range(n_rep))
    # the all-reduced tick scalars are the same on every rank
    stats = [rep[f"R{n_rep}|stats"] for rep in per_rank]
    assert all(s == stats[0] for s in stats)


@pytest.mark.parametrize("world", [2, 4])
def test_session_passes_the_group_through(ranks, world):
    """``StreamSession(mesh=..., group=)`` serves through a
    ``ShardedSearchService`` over the group, rank r holding replicas
    ``[2r, 2r + 2)``."""
    for r, (_, rep) in enumerate(ranks["ranks"][world]):
        assert rep["session"] == ("ShardedSearchService", True,
                                  [2 * r, 2 * r + 1])


@pytest.mark.parametrize("n_rep", [8, 2])
def test_four_rank_service_checkpoint_restores_on_two(
        ranks, service_reference, n_rep):
    _, rest = service_reference
    per_rank = [rep for _, rep in ranks["ranks"][2]]
    union = sum((rep[f"restored_R{n_rep}"] for rep in per_rank), Counter())
    assert union == rest
    files = os.listdir(ranks["dir"] / "svc_w4_R8")
    assert sum(f.endswith("of8.npz") for f in files) == 8


def test_rank_modules_import_no_jax():
    """The rank processes run the port alone."""
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(_torch_ranks.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "repro"}, names


def test_rank_edges_are_the_port_edges():
    """The edge tuples handed to the ranks rebuild the port's stream."""
    from _torch_util import port_edges
    from repro_torch.core.oracle import DataEdge

    s = stream160()
    assert [DataEdge(*e) for e in _edges(s)] == port_edges(s)
    assert port_query(chain2()).to_spec() == chain2().to_spec()


def test_torchrun_example_on_two_gloo_ranks():
    """``examples/torch_ranks.py`` under ``torch.distributed.run`` (the
    multi-card launch, here two gloo ranks on the CPU): the ranks'
    matches are the unsharded engine's, tick by tick."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(root / "examples" / "torch_ranks.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RANKS-OK world=2 backend=gloo ticks=15 matches=68" in proc.stdout
