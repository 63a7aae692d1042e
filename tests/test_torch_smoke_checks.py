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
