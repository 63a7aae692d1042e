"""The port's host-side copies against the reference: stream generators
(same seed, same stream), batching, and the tick coalescer's decisions."""

import numpy as np
import pytest

from repro.runtime.straggler import TickCoalescer as RefCoalescer
from repro.runtime.straggler import quantize_pow2 as ref_quantize_pow2
from repro.stream import generator as ref_gen

from _torch_util import port_edges
from repro_torch.runtime.straggler import TickCoalescer, quantize_pow2
from repro_torch.stream import generator as gen

CONFIGS = [dict(n_edges=300, n_vertices=40, seed=1),
           dict(n_edges=500, n_vertices=1000, n_vertex_labels=8,
                n_edge_labels=4, zipf_a=1.3, seed=7, ts_step_max=2)]


@pytest.mark.parametrize("kind", ["traffic", "social"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=["small", "labelled"])
def test_generators_equal_reference(kind, cfg):
    ref_fn = getattr(ref_gen, f"synth_{kind}_stream")
    fn = getattr(gen, f"synth_{kind}_stream")
    want = ref_fn(ref_gen.StreamConfig(**cfg))
    got = fn(gen.StreamConfig(**cfg))
    assert got == port_edges(want)
    for w, g in zip(ref_gen.to_batches(want, 64), gen.to_batches(got, 64)):
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k])


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_walk_query_equals_reference(seed):
    stream = ref_gen.synth_traffic_stream(ref_gen.StreamConfig(
        n_edges=200, n_vertices=30, seed=seed))
    want = ref_gen.random_walk_query(stream, 3, seed=seed, window=40)
    got = gen.random_walk_query(port_edges(stream), 3, seed=seed, window=40)
    assert (want is None) == (got is None)
    if want is not None:
        assert got.to_spec() == want.to_spec()


def test_coalescer_decisions_equal_reference():
    rng = np.random.default_rng(5)
    ref = RefCoalescer.seeded(64, 8, 1024, 20.0)
    port = TickCoalescer.seeded(64, 8, 1024, 20.0)
    for _ in range(200):
        lat = float(rng.exponential(20.0))
        depth = int(rng.integers(0, 5000))
        over = int(rng.random() < 0.1)
        if rng.random() < 0.1:
            assert port.record_idle() == ref.record_idle()
        assert port.record(lat, depth, over) == ref.record(lat, depth, over)
        assert port.last_action == ref.last_action
    for n in (0, 1, 7, 8, 9, 100, 4096, 4097):
        assert quantize_pow2(n) == ref_quantize_pow2(n)
