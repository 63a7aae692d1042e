"""The launch checks of ``chip_smoke.py``, on the CPU: how a kernel's name
is read from a profiler key or a graph node's symbol, and how a profiler
window that dropped launches is taken again.  The profiler and the CUDA
graph themselves need the card; here a fake profiler stands in."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_checks", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()


@pytest.mark.parametrize("symbol,name", [
    ("_Z8cj_countI4DimsILi2ELi2ELi1ELi1ELb1EELi4ELb1EEv6CJArgsPiS3_",
     "cj_count"),
    ("_Z7cj_scanv", "cj_scan"),
    ("_Z7cj_maskI4DimsILi16ELi16ELi16ELi16ELb0EELi1ELb1EEv6CJArgsPh",
     "cj_mask"),
    ("_Z10eb_bag_sumIfLi4EEvPKiS1_PKT_PS2_8EBParams", "eb_bag_sum"),
    ("sr_scan", "sr_scan"),
])
def test_symbol_name(symbol, name):
    assert cs._symbol_name(symbol) == name


@pytest.mark.parametrize("key,name", [
    ("void cj_count<Dims<2, 2, 1, 1, true>, 4, true>(CJArgs, int*, int*)",
     "cj_count"),
    ("void eb_bag_sum<float, 4>(int const*, int const*)", "eb_bag_sum"),
    ("cj_scan", "cj_scan"),
])
def test_kernel_name(key, name):
    assert cs._kernel_name(key) == name


def _fake_profiler(monkeypatch, windows):
    """``_device_profile`` reads ``windows`` in turn; sleeps are skipped.
    Returns the list of the reps each window was asked for."""
    seen = []
    it = iter(windows)

    def profile(torch, fn, reps):
        seen.append(reps)
        by_key = next(it)
        return sum(by_key.values()), by_key

    monkeypatch.setattr(cs, "_device_profile", profile)
    monkeypatch.setattr(cs.time, "sleep", lambda s: None)
    return seen


def test_steps_takes_a_window_again_until_it_catches_every_kernel(
        monkeypatch):
    count = "void cj_count<Dims<2, 2, 1, 1, true>, 4, true>(CJArgs)"
    seen = _fake_profiler(monkeypatch, [
        {}, {count: 0.2}, {"void cj_scan(int*)": 0.01, count: 0.3},
        {"never": 1.0}])
    total, steps, windows = cs._steps(None, None, {"cj_count", "cj_scan"},
                                      "case", reps=5)
    assert windows == 3 and seen == [5, 5, 5]
    assert steps == {"cj_count": 0.3, "cj_scan": 0.01}
    assert total == pytest.approx(0.31)


def test_steps_reads_none_for_a_kernel_no_window_caught(monkeypatch):
    _fake_profiler(monkeypatch, [{}] * cs.PROFILE_TRIES)
    total, steps, windows = cs._steps(None, None, {"eb_bag_sum"}, "case")
    assert (total, steps, windows) == (0, {"eb_bag_sum": None},
                                       cs.PROFILE_TRIES)


def test_steps_fails_on_a_foreign_device_operation(monkeypatch):
    _fake_profiler(monkeypatch, [
        {"void eb_bag_sum<float, 4>()": 0.004,
         "void at::native::elementwise_kernel<128, 4>()": 0.002}])
    with pytest.raises(SystemExit) as e:
        cs._steps(None, None, {"eb_bag_sum"}, "case")
    assert e.value.code != 0


def test_any_profile_takes_an_empty_window_again(monkeypatch):
    _fake_profiler(monkeypatch, [{}, {}, {"index_add": 0.5}, {"x": 1.0}])
    dev_ms, by_key, windows = cs._any_profile(None, None, 3)
    assert (dev_ms, by_key, windows) == (0.5, {"index_add": 0.5}, 3)


def test_session_patterns_share_one_prefix_chain_per_family():
    """The ``session`` phase's tenants, planned on the CPU: each family
    of 8 aliases one depth-1 and one depth-2 forest node, the third edge
    is a second TC-subquery joined in L0, and each family is one slot
    group of the prefix-sharing service."""
    from repro_torch.api import StreamSession
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.share import prefix_chain

    stream = cs.make_stream(0, 4 * 4096)
    patterns = cs.session_patterns(stream)
    assert len(patterns) == 16
    sess = StreamSession(slots_per_group=8, level_capacity=64,
                         l0_capacity=64, max_new=16, share_prefixes=True,
                         tick_cache=SlotTickCache(), device="cpu")
    subs = [sess.register(p) for p in patterns]
    svc = sess.service
    for sub in subs:
        plan = svc.registry.get(sub.qid).plan
        assert len(plan.subqueries) == 2 and len(plan.l0_joins) == 1
        assert prefix_chain(plan).depth == 2
        assert sub.shared_prefix.n_tenants == 8
    fs = svc.forest_stats()
    assert (fs.n_nodes, fs.n_shared_nodes, fs.n_tenants) == (4, 4, 16)
    assert len(svc._iter_groups()) == 2 and svc.n_compiles == 1


def test_make_molecules_is_the_molecule_shape():
    """The ``nequip_infer`` phase's data: ``gnn_shapes``' molecule shape
    (128 molecules of 30 atoms, 64 directed edges each), edges inside
    their molecule, between distinct atoms within the cutoff, each
    ordered pair once; atoms at least 1 A apart; the same seed gives the
    same arrays."""
    import numpy as np

    from repro_torch.configs.nequip import CONFIG
    from repro_torch.configs.registry import gnn_shapes

    shape = {s.name: s for s in gnn_shapes()}["molecule"].extra
    mol = cs.make_molecules(3)
    b, a, e = shape["batch"], shape["n_nodes"], shape["n_edges"]
    assert (cs.MOL_BATCH, cs.MOL_ATOMS, cs.MOL_EDGES) == (b, a, e)
    assert mol["pos"].shape == (b * a, 3) and mol["n_graphs"] == b
    assert mol["edge_src"].shape == mol["edge_dst"].shape == (b * e,)
    src, dst = mol["edge_src"], mol["edge_dst"]
    assert (mol["graph_ids"][src] == mol["graph_ids"][dst]).all()
    assert (np.bincount(mol["graph_ids"][src], minlength=b) == e).all()
    d = np.linalg.norm(mol["pos"][src] - mol["pos"][dst], axis=-1)
    assert (src != dst).all() and (d < CONFIG.cutoff).all()
    assert len(set(zip(src.tolist(), dst.tolist()))) == b * e
    pos = mol["pos"].reshape(b, a, 3)
    gaps = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    assert (gaps + 9 * np.eye(a) >= 1.0 - 1e-5).all()
    assert 0 <= mol["species"].min() and \
        mol["species"].max() < CONFIG.n_species
    again = cs.make_molecules(3)
    assert all(np.array_equal(mol[k], again[k]) for k in mol
               if k != "n_graphs")


def test_infer_checks_flag_each_fault():
    """The GNN phases' checks: a relative error past 1e-2, a launch count
    off the prediction, a non-finite or misshapen output each give a
    problem; agreeing logits give none."""
    import torch

    want = torch.randn((50, 4), generator=torch.Generator().manual_seed(0))
    fields, problems = cs._infer_checks(torch, "m", want * (1 + 1e-4), want,
                                        (50, 4), 6, 6)
    assert problems == [] and fields["logits_rel_err"] < 1e-3
    assert fields["argmax_agreement"] == 1.0
    off = want.clone()
    off[0] += 10.0
    assert len(cs._infer_checks(torch, "m", off, want, (50, 4), 6, 6)[1]) == 1
    assert len(cs._infer_checks(torch, "m", want, want, (50, 4), 5, 6)[1]) == 1
    nan = want.clone()
    nan[1, 1] = float("nan")
    assert cs._infer_checks(torch, "m", nan, want, (50, 4), 6, 6)[1]
    assert cs._infer_checks(torch, "m", want, want, (50, 5), 6, 6)[1]


def _small_sjtree_case():
    """The serve phase's two structures over a small CAIDA-like stream
    (dense enough to fill the tables in 16 ticks of 64 edges)."""
    from repro.core.query import QueryGraph
    from repro.stream.generator import StreamConfig, synth_traffic_stream

    stream = synth_traffic_stream(StreamConfig(
        n_edges=1024, n_vertices=40, n_vertex_labels=3, n_edge_labels=2,
        seed=2, ts_step_max=2))
    queries = {
        "chain": QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                            edge_labels=(0, 1, 0),
                            prec=frozenset({(0, 1), (1, 2)})),
        "two_chain": QueryGraph(5, (0, 1, 2, 1, 0),
                                ((0, 1), (1, 2), (0, 3), (3, 4)),
                                prec=frozenset({(0, 1), (2, 3)}))}
    return stream, queries


@pytest.mark.parametrize("name", ["chain", "two_chain"])
def test_state_bytes_is_the_benchmark_formula(name):
    """``chip_smoke``'s bytes a tick, its table rows (``_table_rows``)
    times their bytes (``_row_bytes``: its own copy of the formula, since
    the script may not import ``benchmarks.common``, which imports JAX),
    equal ``benchmarks.common.state_bytes`` on the same states: the JAX
    engine and the port's (bit-identical on REF), tick by tick, for the
    timing-aware plan and the SJ-tree plan, in both storage models."""
    import sys

    import jax
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from benchmarks.common import state_bytes as ref_state_bytes
    from repro.core import compile_plan as ref_compile_plan
    from repro.core.engine import build_tick as ref_build_tick
    from repro.core.sjtree import compile_sjtree_plan as ref_sjtree
    from repro.core.state import init_state as ref_init_state
    from repro.core.state import make_batch as ref_make_batch
    from repro.stream.generator import to_batches

    from _torch_util import port_query
    from repro_torch.core.engine import build_tick
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.sjtree import compile_sjtree_plan
    from repro_torch.core.state import init_state, make_batch

    stream, queries = _small_sjtree_case()
    q = queries[name]
    cap = dict(level_capacity=512, l0_capacity=512, max_new=256)
    plans = [(ref_compile_plan(q, 40, **cap),
              compile_plan(port_query(q), 40, **cap)),
             (ref_sjtree(q, 40, **cap)[0],
              compile_sjtree_plan(port_query(q), 40, **cap)[0])]
    seen = 0
    for rp, tp in plans:
        jtick, ttick = jax.jit(ref_build_tick(rp)), build_tick(tp,
                                                              device="cpu")
        js, ts = ref_init_state(rp), init_state(tp, device="cpu")
        for b in to_batches(stream, 64):
            js, _ = jtick(js, ref_make_batch(**b))
            ts, _ = ttick(ts, make_batch(**b, device="cpu"))
            rows = cs._table_rows(torch, ts).tolist()
            for mode in ("mstree", "ind"):
                want = ref_state_bytes(rp, js, mode)
                assert sum(r * b for r, b in zip(
                    rows, cs._row_bytes(tp, mode))) == want
                seen += want > 0
        assert len(cs._row_bytes(tp, "ind")) == len(rows) == \
            len(cs._table_patterns(tp))
    assert seen > 0


@pytest.mark.parametrize("name", ["chain", "two_chain"])
def test_sjtree_window_bounds_the_engines(name):
    """The window reckoning on a small stream: ``_hom_rows`` counts a
    pattern's homomorphisms (checked by brute force on a 2-edge path);
    at the reckoned largest window both engines (REF, CPU) run without
    overflow, every table's live rows stay under its reckoned bound and
    within the capacity, and just past that window the reckoning no
    longer fits."""
    import itertools

    import numpy as np
    import torch

    from _torch_util import port_query
    from repro_torch.core.engine import build_tick
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.sjtree import compile_sjtree_plan
    from repro_torch.core.state import init_state, make_batch
    from repro.stream.generator import to_batches

    stream, queries = _small_sjtree_case()
    q = port_query(queries[name])
    arrays = tuple(np.array([getattr(e, k) for e in stream], np.int64)
                   for k in ("src", "dst", "ts", "src_label", "dst_label",
                             "edge_label"))
    # brute force: homomorphisms of edges {0, 1} (a -> b -> c)
    src, dst = arrays[0][:200], arrays[1][:200]
    e0 = [(s, d) for s, d in zip(src, dst)]
    brute = sum(1 for (a, b), (c, d) in itertools.product(e0, e0) if b == c)
    n_v = int(max(src.max(), dst.max())) + 1
    path = type(q)(3, (0, 0, 0), ((0, 1), (1, 2)))
    assert cs._hom_rows(path, frozenset({0, 1}), {0: (src, dst),
                                                  1: (src, dst)}, n_v) == brute
    cap, max_new, batch = 1024, 512, 64
    w, reck = cs.sjtree_window(q, arrays, batch, cap, max_new,
                               int(arrays[2][-1]) + 1)
    kw = dict(level_capacity=cap, l0_capacity=cap, max_new=max_new)
    plans = [compile_plan(q, w, **kw), compile_sjtree_plan(q, w, **kw)[0]]
    assert 0 < w and reck == cs.sjtree_reckoning(q, plans, arrays, w, batch)
    for plan, r in zip(plans, reck):
        tick, state = build_tick(plan, device="cpu"), init_state(
            plan, device="cpu")
        most = np.zeros(len(r["rows"]))
        for b in to_batches(stream, batch):
            state, _ = tick(state, make_batch(**b, device="cpu"))
            most = np.maximum(most, cs._table_rows(torch, state).numpy())
        assert int(state.stats.n_overflow) == 0
        assert (most <= np.array(r["rows"])).all() and (most <= cap).all()
        assert most.max() > 0
    step = max(1, w // 64)
    wider = [compile_plan(q, w + 2 * step, **kw),
             compile_sjtree_plan(q, w + 2 * step, **kw)[0]]
    assert not cs._fits(cs.sjtree_reckoning(q, wider, arrays, w + 2 * step,
                                            batch), cap, max_new)


@pytest.mark.parametrize("mode", ["fp32", "factored"])
def test_table_sample_is_the_leaf_on_its_rows(mode):
    """``recsys_train`` holds the stacked tables to the plain step on a
    sample of rows: ``_wd_sample_rows`` gives, per sampled field, rows
    the batch reads and rows it does not, and ``_table_sample`` gives
    the parameter, the first moment and the second moment (reconstructed
    from the factored ``vr``/``vc`` over the whole field) on exactly
    those rows after an AdamW step."""
    import numpy as np
    import torch

    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    vocab, batch = 3000, 1000
    rng = np.random.default_rng(3)
    ids = torch.tensor(rng.integers(0, vocab, (batch, 40)), dtype=torch.int32)
    rows = cs._wd_sample_rows(torch, ids, vocab, 0)
    n = cs.WD_SAMPLE_TOUCHED + cs.WD_SAMPLE_UNTOUCHED
    assert rows.shape == (len(cs.WD_SAMPLE_FIELDS), n)
    for j, f in enumerate(cs.WD_SAMPLE_FIELDS):
        used = set(ids[:, f].tolist())
        assert len(set(rows[j].tolist())) == n
        assert all(r in used for r in rows[j, :cs.WD_SAMPLE_TOUCHED].tolist())
        assert not any(r in used
                       for r in rows[j, cs.WD_SAMPLE_TOUCHED:].tolist())

    cfg = AdamWConfig(state_mode=mode)
    params = {"tables": torch.tensor(
        rng.standard_normal((40, vocab, 8)), dtype=torch.float32)}
    state = adamw_init(params, cfg)
    grads = {"tables": torch.tensor(
        rng.standard_normal((40, vocab, 8)), dtype=torch.float32)}
    _, state, _ = adamw_update(grads, state, params, 1e-3, cfg)
    p, st = cs._table_sample(torch, params, state, 0, rows)
    f = torch.tensor(cs.WD_SAMPLE_FIELDS)[:, None]
    full = state["leaves"]["tables"]
    assert torch.equal(p, params["tables"][f, rows])
    assert torch.equal(st["m"], full["m"][f, rows])
    if mode == "factored":
        vr, vc = full["vr"].double(), full["vc"].double()
        v = vr[:, :, None] * vc[:, None, :] / vr.mean(-1)[:, None, None]
    else:
        v = full["v"].double()
    torch.testing.assert_close(st["v"].double(), v[f, rows], rtol=1e-12,
                               atol=0)
