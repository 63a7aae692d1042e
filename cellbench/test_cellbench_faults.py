"""The check has to fail: the rest of a run (set-up, window, the
comparison) with the timed path broken underneath, and the control,
the program with a pair budget too small to keep every pair."""

import pytest

from cellbench import harness
from cellbench.conftest import CONFIGS, tiny


def _run(name, **kw):
    cfg, traffic = tiny(name)
    return harness.run_cell(cfg, traffic, 4_000_000_007, 1.0, False,
                            device="cpu", **kw)


def _stuck(monkeypatch):
    """Every slot group's tick returns its state unchanged."""
    from repro_torch.runtime import service

    orig = service.ContinuousSearchService._advance_group

    def advance(self, g, *a, **k):
        before = g.sstate
        res = orig(self, g, *a, **k)
        g.sstate = before
        return res

    monkeypatch.setattr(service.ContinuousSearchService, "_advance_group",
                        advance)


def _half_batch(monkeypatch):
    """The second half of every batch is left out."""
    from repro_torch.runtime import service

    orig = service.make_batch

    def make_batch(**cols):
        valid = cols["valid"].copy()
        valid[len(valid) // 2:] = False
        return orig(**{**cols, "valid": valid})

    monkeypatch.setattr(service, "make_batch", make_batch)


def _altered(monkeypatch):
    """Every match's first vertex is delivered one off."""
    from repro_torch.api import session

    orig = session.Subscription._match_from_row

    def match_from_row(self, b_row, t_row):
        m = orig(self, b_row, t_row)
        (name, v), *rest = m.vertices
        return m._replace(vertices=((name, v + 1), *rest))

    monkeypatch.setattr(session.Subscription, "_match_from_row",
                        match_from_row)


@pytest.mark.parametrize("fault", [_stuck, _half_batch, _altered])
@pytest.mark.parametrize("name", CONFIGS)
def test_fault_fails_the_check(name, fault, monkeypatch):
    fault(monkeypatch)
    run, check = _run(name)
    assert run.n_matches > 0 or fault is not _altered
    assert check["mismatched_matches"]["value"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_the_check(name):
    """The program with its pair budget cut to 1 drops appends: both
    numbers read above their limits."""
    run, check = _run(name, max_new=1)
    assert check["n_overflow"]["value"] > check["n_overflow"]["limit"]
    assert check["mismatched_matches"]["value"] > \
        check["mismatched_matches"]["limit"]
