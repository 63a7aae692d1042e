"""The stream generator's copy against the port's, and ``label_seed``'s
promise: every seed draws its stream over the same labelled vertices."""

import numpy as np
import pytest

from cellbench import gen


@pytest.mark.parametrize("social", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 3_000_000_019])
def test_stream_equals_port_generator(social, seed):
    from repro_torch.stream.generator import (StreamConfig,
                                              synth_social_stream,
                                              synth_traffic_stream)

    kw = dict(n_vertices=500, n_vertex_labels=3 if social else 8,
              n_edge_labels=4)
    port = (synth_social_stream if social else synth_traffic_stream)(
        StreamConfig(n_edges=3000, seed=seed, **kw))
    cols = gen.stream_columns(3000, seed, social=social, **kw)
    assert gen.edges(cols) == port
    assert gen.edges(cols, 100, 164) == port[100:164]


def test_label_seed_fixes_the_labels_and_nothing_else():
    """With ``label_seed`` every seed's stream runs over one population
    of labelled vertices, drawn uniformly; the other columns are the
    port generator's for the seed."""
    kw = dict(n_vertices=4000, n_vertex_labels=4, n_edge_labels=8,
              social=True)
    want = np.random.default_rng(0).integers(0, 4, kw["n_vertices"])
    for seed in (1, 2, 3_000_000_019):
        cols = gen.stream_columns(20_000, seed, label_seed=0, **kw)
        plain = gen.stream_columns(20_000, seed, **kw)
        for k in ("src", "dst", "ts", "edge_label"):
            assert np.array_equal(cols[k], plain[k])
        assert np.array_equal(cols["src_label"], want[cols["src"]])
        assert np.array_equal(cols["dst_label"], want[cols["dst"]])
