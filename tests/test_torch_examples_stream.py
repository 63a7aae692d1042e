"""The port's streaming examples against the JAX package's, on the CPU.

``examples/torch_quickstart.py``, ``torch_multi_query_service.py`` and
``torch_cybersec_c2_detection.py`` run with ``--device cpu`` (their own
assertions included) beside their JAX twins on the same seeds; the
matches each reports must equal the twin's as multisets: every reported
match row of the quickstart (the JAX side's tick loop is the example's),
every match the api delivers to each tenant of the service example
(``Subscription._deliver`` recorded in both packages: tick sizes follow
the adaptive coalescer's clock, so only the matches can be compared),
and every attack chain the StreamServer reports."""

import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np

import _torch_util  # noqa: F401  (caps torch threads)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_deliveries(monkeypatch, subscription_cls, into: list):
    real = subscription_cls._deliver

    def deliver(self, match):
        into.append((self.name, match.vertices, match.edges))
        return real(self, match)

    monkeypatch.setattr(subscription_cls, "_deliver", deliver)


def test_quickstart_matches_the_jax_example(capsys):
    import jax

    from repro.core import compile_plan
    from repro.core.engine import build_tick
    from repro.core.state import init_state, make_batch
    from repro.stream.generator import to_batches

    port = _load("torch_quickstart").main(["--device", "cpu"])
    ref = _load("quickstart")
    ref.main()
    out = capsys.readouterr().out
    assert out.count("reported 275 timing-constrained matches") == 2
    # the reference example's tick loop, its rows kept
    q = ref.QueryGraph(n_vertices=3, vertex_labels=(0, 1, 2),
                       edges=((0, 1), (1, 2)), prec=frozenset({(0, 1)}))
    plan = compile_plan(q, 30)
    tick, state = jax.jit(build_tick(plan)), init_state(plan)
    stream = ref.synth_traffic_stream(ref.StreamConfig(
        n_edges=2000, n_vertices=30, n_vertex_labels=3, n_edge_labels=2,
        seed=1))
    total, rows = 0, []
    for b in to_batches(stream, 64):
        state, res = tick(state, make_batch(**b))
        total += int(res.n_new_matches)
        valid = np.asarray(res.match_valid)
        rows += [(tuple(b_), tuple(t)) for b_, t in zip(
            np.asarray(res.match_bindings)[valid].tolist(),
            np.asarray(res.match_ets)[valid].tolist())]
    assert port["total"] == total > 0
    assert len(rows) == total
    assert Counter(port["rows"]) == Counter(rows)


def test_multi_query_service_matches_the_jax_example(monkeypatch, capsys):
    from repro.api import session as ref_session

    from repro_torch.api import session as port_session

    ref_got, port_got = [], []
    _record_deliveries(monkeypatch, ref_session.Subscription, ref_got)
    _record_deliveries(monkeypatch, port_session.Subscription, port_got)
    _load("multi_query_service").main()
    port = _load("torch_multi_query_service").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("with NO recompile") == 2
    assert out.count("recompiles on restore: 0") == 2
    assert port_got and Counter(port_got) == Counter(ref_got)
    delivered = Counter(name for name, _, _ in port_got)
    assert delivered["lateral"] == port["first"]["lateral"] \
        + port["resumed"]["lateral"] + port["shared"].get("lateral", 0)
    assert delivered["exfil-chain"] == port["shared"]["exfil-chain"] > 0
    assert delivered["staging-only"] == port["shared"]["staging-only"] > 0
    assert port["n_compiles"] == 0


def test_cybersec_example_matches_the_jax_example(monkeypatch, capsys):
    from repro.launch import stream_serve as ref_serve

    ref_rows = []
    real = ref_serve.StreamServer.ingest

    def ingest(self, edges, on_match=None, **kw):
        def record(bind, ts):
            ref_rows.extend(zip(map(tuple, np.asarray(bind).tolist()),
                                map(tuple, np.asarray(ts).tolist())))
            on_match(bind, ts)
        return real(self, edges, on_match=record, **kw)

    monkeypatch.setattr(ref_serve.StreamServer, "ingest", ingest)
    _load("cybersec_c2_detection").main()
    port = _load("torch_cybersec_c2_detection").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("all planted C&C chains detected") == 2
    assert port["total"] >= 12 and len(port["rows"]) == port["total"]
    assert Counter(port["rows"]) == Counter(ref_rows)
