"""The port's positional parameters against the JAX package's.

A positional call that both packages accept must mean the same thing in
both: code that follows the reference (``init_state(plan, 1)`` with the
prefix depth in second place) must not hand the port a device, or any
other parameter, in that slot.  For every public callable that the two
packages share — each module of ``repro`` that ``repro_torch`` also has,
each public function and class defined there, each class's public
methods — the port's positional parameters must be a prefix of the
reference's, after two documented adjustments:

* ``JAX_ONLY`` — execution knobs of XLA and Pallas with no meaning in
  the port.  The reference's list is cut at the first of them: every
  parameter the port keeps after that point is keyword-only (the port
  does not accept and ignore them);
* ``RENAMED`` — a slot whose value has another type in the port.

Parameters the port adds (``device`` above all) are keyword-only.  A
call with more positional arguments than the port takes raises
``TypeError``: loud, never a silent shift.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

import repro
import repro_torch
from _torch_util import assert_same_tree, port_query

# execution knobs of the JAX package (jit compilation, buffer donation,
# Pallas interpret mode): nothing in the port corresponds to them
JAX_ONLY = {"jit": "jax.jit compilation", "donate": "jit buffer donation",
            "interpret": "Pallas interpret mode"}
# same slot, another type, where the port's name may differ: a JAX PRNG
# key is a torch.Generator in the port (a numpy Generator keeps its
# name), and the Wide&Deep loss takes the port's nn.Module (which holds
# the params and the config) where the reference takes its params tree
RENAMED = {"rng": "gen"}
RENAMED_IN = {"models.recsys.wide_deep.bce_loss": {"params": "model"}}
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _modules(pkg) -> set:
    return {m.name.split(".", 1)[1]
            for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
            if not m.name.endswith("__main__")}


SHARED_MODULES = sorted(_modules(repro) & _modules(repro_torch))


def _positional(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values() if p.kind in POSITIONAL]


def _unwrap(member):
    return member.__func__ if isinstance(member, (staticmethod,
                                                  classmethod)) else member


def shared_callables(rel: str) -> list:
    """``(name, reference callable, port callable)`` for every public
    callable defined in the reference module ``repro.<rel>`` that the
    port's module of the same path also has."""
    ref = importlib.import_module(f"repro.{rel}")
    port = importlib.import_module(f"repro_torch.{rel}")
    out = []
    for name in sorted(dir(ref)):
        r = getattr(ref, name)
        if name.startswith("_") or not hasattr(port, name) \
                or getattr(r, "__module__", None) != ref.__name__:
            continue
        t = getattr(port, name)
        if inspect.isclass(r) and inspect.isclass(t):
            out.append((name, r, t))
            for mname, m in vars(r).items():
                m = _unwrap(m)
                if mname.startswith("_") or not callable(m) \
                        or not hasattr(t, mname):
                    continue
                out.append((f"{name}.{mname}", m,
                            _unwrap(inspect.getattr_static(t, mname))))
        elif inspect.isfunction(r) and callable(t):
            out.append((name, r, t))
    return out


def expected_prefix(ref_params: list, where: str = "") -> list:
    """The reference's positional parameters cut at the first JAX-only
    one, each as the set of names the port may give that slot."""
    renamed = {**RENAMED, **RENAMED_IN.get(where, {})}
    out = []
    for p in ref_params:
        if p in JAX_ONLY:
            break
        out.append({p, renamed.get(p, p)})
    return out


def follows(port_params: list, ref_params: list, where: str = "") -> bool:
    """The port's positional parameters are a prefix of the
    reference's (``expected_prefix``)."""
    want = expected_prefix(ref_params, where)
    return len(port_params) <= len(want) and all(
        p in names for p, names in zip(port_params, want))


def mismatches(rel: str) -> list:
    bad = []
    for name, r, t in shared_callables(rel):
        rp, tp = _positional(r), _positional(t)
        if rp is None or tp is None:
            continue
        if not follows(tp, rp, f"{rel}.{name}"):
            bad.append(f"{rel}.{name}: port {tp} vs reference {rp}")
    return bad


@pytest.mark.parametrize("rel", SHARED_MODULES)
def test_positional_parameters_follow_the_reference(rel):
    assert mismatches(rel) == []


def test_the_walk_reaches_the_repaired_callables():
    """Not vacuous: the walk compares the callables whose slots were
    shifted, and each now has the reference's positional order with
    ``device`` keyword-only."""
    names = {(rel, n) for rel in SHARED_MODULES
             for n, _, _ in shared_callables(rel)}
    for key in [("core.state", "init_state"),
                ("core.multi", "init_slot_state"),
                ("core.share", "SharedPrefixForest"),
                ("runtime.service", "ContinuousSearchService"),
                ("runtime.service", "ContinuousSearchService.serve_frontier"),
                ("stream.ingest", "IngestFrontier"),
                ("stream.chaos", "ChaosSource"),
                ("runtime.fault", "FaultTolerantLoop")]:
        assert key in names, key
    from repro_torch.core.multi import init_slot_state
    from repro_torch.core.share import SharedPrefixForest
    from repro_torch.core.state import init_state
    from repro_torch.runtime.service import ContinuousSearchService
    kw_only = inspect.Parameter.KEYWORD_ONLY
    for fn in (init_state, init_slot_state, SharedPrefixForest,
               ContinuousSearchService):
        assert inspect.signature(fn).parameters["device"].kind == kw_only
    assert _positional(init_state) == ["plan", "prefix_depth", "watermark"]
    assert _positional(init_slot_state) == ["template_plan", "n_slots",
                                            "prefix_depth"]
    # the reference's jit sits after max_out: everything after is
    # keyword-only in the port
    params = inspect.signature(ContinuousSearchService).parameters
    assert _positional(ContinuousSearchService)[-1] == "max_out"
    assert params["ckpt_dir"].kind == kw_only


def test_a_shifted_slot_is_caught():
    """The check itself: the seed's order (``device`` in the reference's
    ``prefix_depth`` slot) is reported, a trailing keyword-only device
    and a cut at ``jit`` are not."""
    def shifted(plan, device=None, watermark=None, prefix_depth=0):
        pass

    def repaired(plan, prefix_depth=0, watermark=None, *, device=None):
        pass

    ref = ["plan", "prefix_depth", "watermark"]
    assert not follows(_positional(shifted), ref)
    assert follows(_positional(repaired), ref)
    cut = ["a", "max_out", "jit", "donate", "ckpt_dir"]
    assert follows(["a", "max_out"], cut)
    assert not follows(["a", "max_out", "ckpt_dir"], cut)
    assert follows(["gen", "cfg"], ["rng", "cfg"])
    assert not follows(["cfg", "gen"], ["rng", "cfg"])


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_init_state_positional_depth_equals_reference(depth):
    """``init_state(plan, depth)`` — the depth passed positionally, as
    the reference's service passes it — gives the reference's layout,
    leaf for leaf and bit for bit; so does ``init_slot_state``."""
    from repro.core import compile_plan as ref_compile_plan
    from repro.core.multi import init_slot_state as ref_init_slot_state
    from repro.core.state import init_state as ref_init_state
    from repro_torch.core.multi import init_slot_state
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.state import init_state
    from test_engine_oracle import tri_query

    q = tri_query()            # one TC-subquery of three levels
    cap = dict(level_capacity=32, l0_capacity=32, max_new=16)
    rplan = ref_compile_plan(q, 20, **cap)
    plan = compile_plan(port_query(q), 20, **cap)
    ref, got = ref_init_state(rplan, depth), init_state(plan, depth,
                                                        device="cpu")
    assert_same_tree(ref, got, f"init_state depth {depth}")
    assert len(got.levels[0]) == len(plan.subqueries[0].levels) - depth
    wm_ref = ref_init_state(rplan, depth, 7)
    wm = init_state(plan, depth, 7, device="cpu")
    assert_same_tree(wm_ref, wm, "with a watermark")
    assert int(wm.t_now) == 7 and np.asarray(wm_ref.t_now) == 7
    assert_same_tree(ref_init_slot_state(rplan, 3, depth),
                     init_slot_state(plan, 3, depth, device="cpu"),
                     f"init_slot_state depth {depth}")


# --------------------------------------------------------------------- #
# public names the port had left out, each against the reference
# --------------------------------------------------------------------- #
def test_set_active_and_reset_query_equal_reference():
    from repro.core import compile_plan as ref_compile_plan
    from repro.core.multi import build_multi_tick as ref_build_multi_tick
    from repro.core.multi import init_multi_state as ref_init_multi_state
    from repro.core.multi import reset_query as ref_reset_query
    from repro.core.multi import set_active as ref_set_active
    from repro.core.state import make_batch as ref_make_batch
    from repro.stream.generator import to_batches
    from repro_torch.core.multi import (
        build_multi_tick,
        init_multi_state,
        reset_query,
        set_active,
    )
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.state import make_batch
    from test_engine_oracle import small_stream, tri_query
    from test_service_restore import chain_query

    cap = dict(level_capacity=64, l0_capacity=64, max_new=32)
    qs = [(chain_query(), 20), (tri_query(), 25)]
    rplans = [ref_compile_plan(q, w, **cap) for q, w in qs]
    plans = [compile_plan(port_query(q), w, **cap) for q, w in qs]
    rtick = ref_build_multi_tick(rplans)
    tick = build_multi_tick(plans, device="cpu")
    rms = ref_init_multi_state(rplans)
    ms = init_multi_state(plans, device="cpu")
    batches = to_batches(small_stream(96, n_vertices=9, seed=61), 16)
    for i, b in enumerate(batches):
        if i == 2:
            rms, ms0 = ref_set_active(rms, 1, False), ms
            ms = set_active(ms, 1, False)
            assert bool(ms0.active[1])          # the input is unchanged
        if i == 4:
            rms, ms = ref_set_active(rms, 1, True), set_active(ms, 1, True)
            rms = ref_reset_query(rms, rplans, 0)
            ms = reset_query(ms, plans, 0)
            assert_same_tree(rms, ms, "after reset_query")
        rms, rres = rtick(rms, ref_make_batch(**b))
        ms, res = tick(ms, make_batch(**b, device="cpu"))
        assert_same_tree(rms, ms, f"tick {i}")
        assert_same_tree(rres, res, f"tick {i} results")


def test_slot_tick_cache_len_ticks_clear_equal_reference():
    from repro.core import compile_plan as ref_compile_plan
    from repro.core.multi import SlotTickCache as RefSlotTickCache
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.core.plan import compile_plan
    from test_engine_oracle import tri_query
    from test_service_restore import chain_query

    cap = dict(level_capacity=32, l0_capacity=32, max_new=16)
    ref, port = RefSlotTickCache(max_entries=2), SlotTickCache(max_entries=2)
    seen = []
    for q, w in [(chain_query(), 20), (tri_query(), 25), (chain_query(), 9),
                 (tri_query(), 25)]:
        ref.get(ref_compile_plan(q, w, **cap))
        port.get(compile_plan(port_query(q), w, **cap))
        seen.append((len(port), len(port.ticks()), port.n_builds))
        assert seen[-1] == (len(ref), len(ref.ticks()), ref.n_builds)
    assert all(callable(t) for t in port.ticks())
    ref.clear()
    port.clear()
    assert len(port) == len(ref) == 0 and port.ticks() == []
    port.get(compile_plan(port_query(chain_query()), 20, **cap))
    assert port.n_builds == seen[-1][2] + 1     # cleared: built again


def test_forest_total_overflow_equals_reference():
    from repro.core.multi import SlotTickCache as RefSlotTickCache
    from repro.runtime.service import ContinuousSearchService as RefService
    from repro_torch.core.multi import SlotTickCache
    from repro_torch.runtime.service import ContinuousSearchService
    from _torch_util import port_edges
    from test_engine_oracle import small_stream, tri_query
    from test_service_restore import chain_query

    cap = dict(level_capacity=4, l0_capacity=4, max_new=4)   # overflows
    serve = dict(batch_size=16, min_batch=16, max_batch=16)
    stream = small_stream(96, n_vertices=6, seed=61)
    ref = RefService(slots_per_group=2, tick_cache=RefSlotTickCache(),
                     enable_sharing=True, **cap)
    port = ContinuousSearchService(slots_per_group=2,
                                   tick_cache=SlotTickCache(),
                                   enable_sharing=True, device="cpu", **cap)
    from repro.core.query import QueryGraph

    hot = QueryGraph(3, (2, 2, 2), ((0, 1), (1, 2)),
                     prec=frozenset({(0, 1)}))     # the stream's hot labels
    for q, w in [(hot, 200), (chain_query(), 200), (tri_query(), 250)]:
        ref.register(q, w)
        port.register(port_query(q), w)
    totals = []
    for svc, s in ((ref, stream), (port, port_edges(stream))):
        seen = []
        svc.serve_stream(s, on_tick=lambda i, svc=svc, seen=seen:
                         seen.append(svc.forest.total_overflow()), **serve)
        totals.append(seen)
    assert totals[1] == totals[0] and totals[1][-1] > 0
