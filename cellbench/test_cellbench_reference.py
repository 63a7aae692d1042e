"""The plain reference against a brute-force search, and the port's
REF-backend ``StreamSession`` (through the harness) against the
reference, for both tenant sets, sharing on and off."""

import numpy as np
import pytest

from cellbench import gen, harness
from cellbench.conftest import CONFIGS, tiny
from cellbench.reference.matches import pattern_matches


def brute(cols, n, batch, spec):
    """Every match by backtracking over the stream edges, one pattern
    edge at a time, every constraint tested on the whole match."""
    lab = dict(spec["vertices"])
    names = [v for v, _ in spec["vertices"]]
    edges = [tuple(e) for e in spec["edges"]]
    src, dst, ts = (cols[k][:n].tolist() for k in ("src", "dst", "ts"))
    cand = [[i for i in range(n)
             if cols["src_label"][i] == lab[u] and cols["dst_label"][i] ==
             lab[v] and (el is None or cols["edge_label"][i] == el)
             and src[i] != dst[i]] for u, v, el in edges]
    out = []

    def rec(k, bind, chosen):
        if k == len(edges):
            t = [ts[i] for i in chosen]
            if (max(t) - min(t) < spec["window"]
                    and all(t[i] < t[j] for i, j in spec["before"])
                    and len(set(bind.values())) == len(bind)):
                out.append((max(chosen) // batch,
                            *[bind[v] for v in names], *t))
            return
        u, v, _ = edges[k]
        for i in cand[k]:
            if bind.get(u, src[i]) == src[i] and bind.get(v, dst[i]) == dst[i]:
                rec(k + 1, {**bind, u: src[i], v: dst[i]}, chosen + [i])

    rec(0, {}, [])
    return sorted(out)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_brute_force(name):
    cfg, _ = tiny(name)
    st = dict(cfg["stream"])
    social = st.pop("generator") == "social"
    n = 1500
    cols = gen.stream_columns(n, 3, social=social, **st)
    found = 0
    for spec in cfg["tenants"]:
        want = brute(cols, n, 16, spec)
        got = [tuple(r) for r in pattern_matches(cols, n, 16, spec).tolist()]
        assert got == want, spec["name"]
        found += len(want)
        some = {r[0] for r in want}
        if some:
            kept = pattern_matches(cols, n, 16, spec, ticks={min(some)})
            assert [tuple(r) for r in kept.tolist()] == \
                [r for r in want if r[0] == min(some)]
    assert found > 10


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_session_equals_reference(name, share):
    cfg, traffic = tiny(name, share)
    run, check = harness.run_cell(cfg, traffic, 2_147_483_659, 1.0, False,
                                  device="cpu")
    assert run.n_matches > 0
    assert len(run.tick_s) > 0 and run.window_edges > 0
    assert check == {"mismatched_matches": {"value": 0, "limit": 0},
                     "n_overflow": {"value": 0, "limit": 0}}
    assert np.isclose(sum(run.tick_s), run.window_s)
