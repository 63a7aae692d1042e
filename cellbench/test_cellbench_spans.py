"""The readers of the program's tick spans, on a traced CPU run of each
tiny cell: each returns a number, delivery's two parts fit inside it,
and the bytes copied are the groups' whole results."""

import pytest
import torch

from cellbench import harness
from cellbench import trace as T
from cellbench.conftest import CONFIGS, tiny

SPAN_READERS = ("convert_ms", "batch_ms", "copy_ms", "match_ms",
                "copy_mb_per_tick")


@pytest.mark.parametrize("name", CONFIGS)
def test_span_readers_read_a_traced_run(monkeypatch, name):
    # profile no tick: the span readers read every tick after the first,
    # however slowly a loaded host serves them
    monkeypatch.setattr(T, "PROFILED_S", 0.0)
    cfg, traffic = tiny(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as run.py: one host thread
    try:
        run, check = harness.run_cell(cfg, traffic, 2147483659, 2.0, True,
                                      device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert all(c["value"] <= c["limit"] for c in check.values()), check
    assert run.spans, "no ticks after the profiled part"
    got = {m: harness.load_reader(m).read(run) for m in SPAN_READERS}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    deliver = harness.load_reader("deliver_ms").read(run)
    assert got["copy_ms"] + got["match_ms"] <= deliver
    # at least every group's bindings and timestamps, [S, max_out,
    # nv + ne] int32 (a chain of e edges binds e + 1 vertices), and its
    # [S, max_out] mask
    groups = {s["gid"] for s in run.spans if s["span"] == "deliver.copy"}
    sv = cfg["service"]
    rows = sv["slots_per_group"] * sv["max_new"]
    per_group = {len(t["edges"]) for t in cfg["tenants"]}
    assert got["copy_mb_per_tick"] * 1e6 >= len(groups) * rows * (
        4 * (2 * min(per_group) + 1) + 1)
