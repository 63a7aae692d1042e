"""The join's yardstick on hand-counted inputs, and the counts the
traced run takes from each join call."""

import numpy as np
import pytest
import torch

from cellbench import trace as T
from cellbench import work as W


def test_predicate_ops():
    assert W.predicate_ops(2, 2, 1, 1, 1, False) == 2 * 2 + 1 + 1
    assert W.predicate_ops(3, 2, 2, 2, 1, True) == 3 * 2 + 2 + 1 + 2 * 3 + 2


def test_join_work_counts_live_rows_and_emitted_pairs():
    nbytes, ops = W.join_work(live_a=3, live_b=5, rows_a=8, rows_b=16,
                              nva=2, nea=1, nvb=2, neb=1, emitted=4,
                              n_slots=1, trel_nonzero=1, windowed=True)
    # masks 8 + 16; live rows 3 x (2 + 1) and 5 x (2 + 1) int32; the
    # window; 4 pairs of two int64 and a bool; one int32 drop count
    assert nbytes == 24 + 4 * (9 + 15) + 4 + 4 * 17 + 4
    assert ops == 4 * (2 * 2 + 1 + 1 + 2 * 2 + 2)


def test_least_seconds_takes_the_larger_bound():
    assert W.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert W.least_seconds(0, 67e12) == pytest.approx(2.0)
    assert W.least_seconds(3.35e9, 33.5e9) == pytest.approx(1e-3)


def test_nested_loop_work_counts_capacity():
    nbytes, ops = W.nested_loop_work(rows_a=8, rows_b=16, nva=2, nea=1,
                                     nvb=2, neb=1, valid_pairs=15,
                                     n_slots=1, trel_nonzero=1,
                                     windowed=False, max_new=4)
    assert nbytes == 8 * 13 + 16 * 13 + 4 * 17 + 4
    assert ops == 15 * (2 * 2 + 1 + 1)


def test_traced_join_counts_live_rows_and_pairs():
    from repro_torch.core import join as J

    s, ca, cb = 2, 6, 5
    g = torch.Generator().manual_seed(0)
    bind_a = torch.randint(0, 3, (s, ca, 2), generator=g, dtype=torch.int32)
    ets_a = torch.arange(s * ca, dtype=torch.int32).reshape(s, ca, 1)
    valid_a = torch.rand(s, ca, generator=g) < 0.5
    bind_b = torch.randint(0, 3, (cb, 2), generator=g, dtype=torch.int32)
    ets_b = torch.arange(cb, dtype=torch.int32).reshape(cb, 1) + 100
    valid_b = torch.rand(cb, generator=g) < 0.7
    rel = np.array([[False, False], [True, False]])
    trel = np.array([[-1]], np.int8)
    p = T.Profile(torch, False)
    p.start()
    _, _, pv, _ = J.join_pairs(bind_a, ets_a, valid_a, bind_b, ets_b,
                               valid_b, rel, trel, 64, None)
    p.stop(1)
    (info, counts), = p.calls
    assert J.join_pairs.__module__ == "repro_torch.core.join"   # unwrapped
    assert counts.tolist() == [int(valid_a.sum()), int(valid_b.sum()),
                               int(pv.sum()),
                               int((valid_a.sum(1) * valid_b.sum()).sum())]
    assert info == dict(rows_a=s * ca, rows_b=cb, nva=2, nea=1, nvb=2,
                        neb=1, n_slots=s, trel_nonzero=1, windowed=False,
                        max_new=64)
    summary = p.summary()
    assert summary.join_calls == summary.join_ranges == 1
    assert summary.join_timed == 0          # no device on the CPU
