"""The port's CUDA kernel on the card (marker ``gpu``; skips without a
CUDA device).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The kernel must agree with its plain version element for element
(pairs in row-major order, overflow included), and a CUDA-backend slot
group must tick bit-identically to the REF backend on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.multi import (
    build_slot_tick,
    init_slot_state,
    write_slot,
)
from repro_torch.core.plan import compile_plan
from repro_torch.core.query import QueryGraph
from repro_torch.core.state import make_batch
from repro_torch.kernels.compat_join import ops, ref
from repro_torch.stream.generator import (
    StreamConfig,
    synth_traffic_stream,
    to_batches,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaves(t):
    if isinstance(t, tuple):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("n_slots,ca,cb,max_new,window", [
    (1, 1000, 300, 4096, None),
    (4, 3000, 257, 64, 30),          # overflow, ragged B
    (3, 77, 5000, 2048, 12),
])
@pytest.mark.parametrize("shared_b", [False, True])
def test_kernel_equals_plain_version(cuda, n_slots, ca, cb, max_new, window,
                                     shared_b):
    rng = np.random.default_rng(ca + cb)
    rel = np.array([[True, False, False], [False, False, True]])
    trel = np.array([[-1, 0], [0, 1]], np.int8)
    lead_b = () if shared_b else (n_slots,)

    def t(x):
        return torch.as_tensor(x, device=cuda)

    args = (t(rng.integers(0, 20, (n_slots, ca, 2), dtype=np.int32)),
            t(rng.integers(0, 50, (n_slots, ca, 2), dtype=np.int32)),
            t(rng.random((n_slots, ca)) < 0.8),
            t(rng.integers(0, 20, lead_b + (cb, 3), dtype=np.int32)),
            t(rng.integers(0, 50, lead_b + (cb, 2), dtype=np.int32)),
            t(rng.random((n_slots, cb)) < 0.8))
    win = None if window is None else \
        t(np.full((n_slots,), window, np.int32))
    before = ops.compat_join_pairs.launches
    got = ops.compat_join_pairs(*args, rel, trel, max_new, win)
    assert ops.compat_join_pairs.launches == before + 1
    want = ref.compat_join_pairs(*args, rel, trel, max_new, win)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


def test_cuda_slot_tick_equals_ref_slot_tick(cuda):
    q = QueryGraph(4, (0, 1, 2, 0), ((0, 1), (1, 2), (2, 3)),
                   prec=frozenset({(0, 1), (1, 2)}))
    q2 = QueryGraph(5, (0, 1, 2, 1, 2), ((0, 1), (1, 2), (0, 3), (3, 4)),
                    prec=frozenset({(0, 1), (2, 3)}))
    stream = synth_traffic_stream(StreamConfig(
        n_edges=600, n_vertices=12, n_vertex_labels=3, n_edge_labels=2,
        seed=5, ts_step_max=2))
    for query in (q, q2):
        plans = [compile_plan(query, w, level_capacity=1024,
                              l0_capacity=1024, max_new=256)
                 for w in (20, 35, 50)]
        ticks = {b: build_slot_tick(plans[0], backend=b)
                 for b in ("ref", "cuda")}
        states = {}
        for b in ticks:
            st = init_slot_state(plans[0], 4, device=cuda)
            for k, p in enumerate(plans):
                write_slot(st, plans[0], k, p)
            states[b] = st
        for batch in to_batches(stream, 32):
            eb = make_batch(**batch, device=cuda)
            res = {}
            for b in ticks:
                states[b], res[b] = ticks[b](states[b], eb)
            for x, y in zip(_leaves(states["ref"]) + _leaves(res["ref"]),
                            _leaves(states["cuda"]) + _leaves(res["cuda"])):
                assert torch.equal(x, y)
        assert int(states["cuda"].engines.stats.n_matches_total.sum()) > 0


def test_cuda_single_query_tick_equals_ref_tick(cuda):
    """``build_tick`` (one query, S = 1 of the same launch) on the CUDA
    backend against REF, with a watermark."""
    from repro_torch.core.engine import build_tick
    from repro_torch.core.state import init_state

    q = QueryGraph(5, (0, 1, 2, 1, 2), ((0, 1), (1, 2), (0, 3), (3, 4)),
                   prec=frozenset({(0, 1), (2, 3)}))
    plan = compile_plan(q, 30, level_capacity=512, l0_capacity=512,
                        max_new=128)
    stream = synth_traffic_stream(StreamConfig(
        n_edges=400, n_vertices=10, n_vertex_labels=3, n_edge_labels=2,
        seed=9, ts_step_max=2))
    ticks = {b: build_tick(plan, backend=b, device=cuda)
             for b in ("ref", "cuda")}
    states = {b: init_state(plan, device=cuda) for b in ticks}
    for batch in to_batches(stream, 16):
        eb = make_batch(**batch, device=cuda)
        wm = int(batch["ts"][batch["valid"]].max()) - 2
        res = {}
        for b in ticks:
            states[b], res[b] = ticks[b](states[b], eb, wm)
        for x, y in zip(_leaves(states["ref"]) + _leaves(res["ref"]),
                        _leaves(states["cuda"]) + _leaves(res["cuda"])):
            assert torch.equal(x, y)
    assert int(states["cuda"].stats.n_matches_total) > 0
