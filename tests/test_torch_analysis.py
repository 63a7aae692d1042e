"""The port's static-analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

* The tick-scope lint: the reference's fixtures, translated to torch one
  function per function and with the same names, give the same
  ``(rule, symbol, severity)`` set as ``repro.analysis.ast_lint`` on
  ``tests/analysis_fixtures`` (every TRC rule has a counterpart); the
  torch-only hazards (a host-built tensor, ``.nonzero()``, ``.cpu()``,
  ...) each fire, and their device-side forms stay silent.  Fixture
  sources are written into ``tmp_path``.
* Baselines and reports: the port reads the reference's baseline to the
  same keys and justifications, refuses the same bad entries, and writes
  the same JSON report for the same findings.
* The real tree: ``src/repro_torch`` has no error, every warning is in
  ``analysis_baseline_torch.json``, every tick builder is a root.
* The kernel pass: clean with four launch contracts; each rule fires on
  a broken input (monkeypatched constants and plans, or a copied source
  under ``tmp_path``); the lattice constants are the reference's.
* The CLI: the reference CLI's exit codes and report.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

import _torch_util  # noqa: F401  (caps torch threads)
from repro.analysis import findings as ref_findings
from repro.analysis import kernel_check as ref_kc
from repro.analysis.ast_lint import lint_tree as ref_lint_tree
from repro_torch.analysis import ERROR, WARNING, Finding, Report, load_baseline
from repro_torch.analysis import kernel_check as KC
from repro_torch.analysis.ast_lint import Linter, lint_tree
from repro_torch.analysis.cli import main as cli_main
from repro_torch.kernels.compat_join import kernel as cj_k
from repro_torch.kernels.embedding_bag import kernel as eb_k
from repro_torch.kernels.segment_reduce import kernel as sr_k

ROOT = Path(__file__).resolve().parents[1]
SRC_PORT = ROOT / "src" / "repro_torch"
KERNELS = SRC_PORT / "kernels"
REF_FIXTURES = ROOT / "tests" / "analysis_fixtures"
REF_BASELINE = ROOT / "analysis_baseline.json"
PORT_BASELINE = ROOT / "analysis_baseline_torch.json"

# Rules of repro.analysis.ast_lint with no counterpart in the port: none
# (ast_lint's docstring maps TRC101-TRC107 one to one).
NO_COUNTERPART: set = set()

# tests/analysis_fixtures, translated: jax.jit -> torch.compile, jnp ->
# torch, a jit without donation -> a tick copying its whole state.
FIXTURES = {
    "bad_traced.py": '''
import numpy as np
import torch


@torch.compile
def bad_cast(x):
    return int(x) + 1                       # TRC101


@torch.compile
def bad_numpy(x):
    return np.sum(x)                        # TRC102


@torch.compile
def bad_sync(x):
    return x.tolist()                       # TRC103


@torch.compile
def bad_branch(x):
    if x > 0:                               # TRC104
        return x
    return -x


@torch.compile
def suppressed_cast(x):
    return int(x)  # analysis: ignore[TRC101]


@torch.compile
def ok_none_check(x, y=None):
    if y is None:                           # identity test: exempt
        return x
    return x + y


@torch.compile
def ok_shape_kills_taint(x):
    n = x.shape[0]
    if n > 4:                               # host metadata: no finding
        return torch.sum(x[:4])
    return torch.sum(x)


def host_helper(v):
    # host code: np/int/if are all fine here
    arr = np.asarray(v)
    if arr.size > 3:
        return int(arr.sum())
    return 0
''',
    "bad_builder.py": '''
import torch


def build_leaky_tick(plan, window):
    """Closes the dynamic ``window`` over the returned tick."""

    def tick(state, batch):
        return state + torch.minimum(batch, window)   # TRC105

    return tick


@torch.compile
def serve(state, batch):
    return torch.cat([state, batch])                  # TRC106: a copy


@torch.compile
def serve_donating(state, batch):
    state[:batch.shape[0]] = batch                    # ok: in place
    return state


def build_clean_tick(plan):
    """Only the structural ``plan`` is captured: no findings."""

    def tick(state, batch, window):
        return state + torch.minimum(batch, window)

    return tick
''',
    "bad_obs.py": '''
import torch

from repro_torch.obs import MetricsRegistry, Tracer

REG = MetricsRegistry()
TR = Tracer("/dev/null")


@torch.compile
def bad_obs_emit(state, x):
    REG.counter("tick.n_ticks").inc()       # TRC107
    return state + x


def ok_obs_host(reg: MetricsRegistry, lat_ms: float):
    reg.histogram("tick.latency_ms").observe(lat_ms)
    TR.record("tick.barrier", lat_ms)
''',
}


def _write(root: Path, files: dict) -> Path:
    for name, src in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src.lstrip("\n"))
    return root


def _golden(findings) -> set:
    return {(f.rule, f.symbol.rsplit(".", 1)[-1], f.severity)
            for f in findings}


# --------------------------------------------------------------------- #
# ast_lint: the golden sets
# --------------------------------------------------------------------- #
def test_lint_fixture_golden_set_equals_reference(tmp_path):
    findings, stats = lint_tree(str(_write(tmp_path, FIXTURES)))
    ref, _ = ref_lint_tree(str(REF_FIXTURES))
    want = {g for g in _golden(ref) if g[0] not in NO_COUNTERPART}
    assert _golden(findings) == want
    assert {g[0] for g in want} == {f"TRC10{i}" for i in range(1, 8)}
    # the inline-suppressed cast and every ok_* pattern stay silent
    assert not any("suppressed" in f.symbol or "ok_" in f.symbol
                   or "host_helper" in f.symbol or "clean" in f.symbol
                   or "donating" in f.symbol for f in findings)
    assert stats["n_traced_functions"] >= 6
    assert stats["n_obs_sites"] >= 3


TICK = '''
import numpy as np
import torch


def build_tick(plan, *, device=None):
    lab = torch.as_tensor(np.asarray(plan.labels), device=device)

    def tick(state, batch):
{body}
    return tick
'''

# (name, tick body, rule or None): the torch-only hazards in tick scope,
# and the device-side forms that must stay silent
TORCH_CASES = [
    ("host_tensor", "        return state + torch.tensor([1, 2])",
     "TRC102"),
    ("as_tensor_of_a_host_int",
     "        n = batch.shape[0]\n"
     "        return state + torch.as_tensor(n, device=state.device)",
     "TRC102"),
    ("from_numpy", "        return state + torch.from_numpy(np.ones(3))",
     "TRC102"),
    ("nonzero_method", "        return batch.nonzero()", "TRC103"),
    ("torch_nonzero", "        return torch.nonzero(batch)", "TRC103"),
    ("cpu", "        return batch.cpu()", "TRC103"),
    ("item", "        return state + batch.sum().item()", "TRC103"),
    ("to_cpu", "        return batch.to('cpu')", "TRC103"),
    ("numpy", "        return batch.numpy()", "TRC103"),
    ("synchronize", "        torch.cuda.synchronize()\n        return state",
     "TRC103"),
    ("where_one_arg", "        return torch.where(batch > 0)", "TRC103"),
    ("object_collective",
     "        out = [None, None]\n"
     "        torch.distributed.all_gather_object(out, batch)\n"
     "        return state", "TRC103"),
    ("barrier", "        torch.distributed.barrier()\n        return state",
     "TRC103"),
    ("float_of_tensor", "        return state + float(batch.sum())",
     "TRC101"),
    ("assert_on_tensor", "        assert (batch >= 0).all()\n"
     "        return state", "TRC104"),
    ("clone_of_state", "        return state.clone() + batch", "TRC106"),
    ("full_on_device",
     "        return state + torch.full((3,), 1, device=state.device)", None),
    ("as_tensor_of_a_tick_value",
     "        return torch.as_tensor(batch, dtype=torch.int32)", None),
    ("labels_built_at_build_time", "        return state + lab", None),
    ("metadata", "        if batch.dim() == 2 and batch.numel() > 0:\n"
     "            return state[: batch.size(0)]\n        return state", None),
    ("host_loop_bound", "        for i in range(batch.shape[0]):\n"
     "            state = state + i\n        return state", None),
    ("tensor_collectives",
     "        out = batch.new_empty((2 * batch.shape[0],))\n"
     "        torch.distributed.all_gather_into_tensor(out, batch)\n"
     "        torch.distributed.all_reduce(out)\n"
     "        return state + out.sum()", None),
]


@pytest.mark.parametrize("name,body,rule", TORCH_CASES,
                         ids=[c[0] for c in TORCH_CASES])
def test_lint_torch_only_patterns(tmp_path, name, body, rule):
    _write(tmp_path, {"m.py": TICK.format(body=body)})
    findings, _ = lint_tree(str(tmp_path))
    got = {(f.rule, f.symbol.split(".", 1)[1]) for f in findings}
    assert got == ({(rule, "m.build_tick.tick")} if rule else set())


# The seed's engine._scatter_rows, before the host-copy fault was fixed:
# a Python constant (``True`` for the valid and fresh columns) went
# through torch.as_tensor on every append.
HOST_COPY_APPEND = {"core/engine.py": '''
import torch


def _scatter_rows(dst, slots, ok, vals):
    s, c = dst.shape[:2]
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    idx = torch.where(ok, slots, torch.full_like(slots, c))
    ar = torch.arange(s, device=dst.device)[:, None]
    vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device)
    ext[ar, idx] = vals.expand(idx.shape + dst.shape[2:])
    return ext[:, :c]


def _append(table, slots, ok, src):
    def put(t, v):
        return _scatter_rows(t, slots, ok, v)

    return put(table.src, src), put(table.valid, True)


def build_tick_body(plan):
    def body(state, batch):
        return _append(state, batch.slots, batch.ok, batch.src)

    return body
'''}


def test_lint_finds_the_host_copy_in_every_append(tmp_path):
    """The fault found in the seed's append (ROADMAP Queue C, closed):
    the union of the call sites makes ``vals`` a tick value, but one call
    site hands it a constant, so the tensor it builds is host data."""
    findings, _ = lint_tree(str(_write(tmp_path / "repro_torch",
                                       HOST_COPY_APPEND)))
    got = {(f.rule, f.severity, f.symbol) for f in findings}
    assert ("TRC102", ERROR, "repro_torch.core.engine._scatter_rows") in got
    assert ("TRC106", WARNING, "repro_torch.core.engine._scatter_rows") \
        in got


ROOTS = {
    "graphs.py": '''
import torch


def step(x):
    return x.item()                                   # TRC103


def capture(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step(x)
    return g


def fwd(x):
    return int(x)                                     # TRC101


graphed = torch.cuda.make_graphed_callables(fwd, (None,))


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.cpu()                                # TRC103

    @staticmethod
    def backward(ctx, g):
        return g
''',
    "kernels/k/ops.py": '''
def public_op(x):
    if x.sum() > 0:                                   # TRC104
        return x
    return -x


def _private(x):
    return x.tolist()                                 # not a root
''',
    "kernels/k/kernel.py": '''
def k_cuda(x):
    if x.is_cuda and x.dim() == 1:                    # metadata: ok
        return x.cpu()                                # TRC103
    return x


def plan(n):
    return int(n)                                     # host plan: ok
''',
}


def test_lint_roots_graphs_autograd_and_kernel_wrappers(tmp_path):
    findings, stats = lint_tree(str(_write(tmp_path / "pkg", ROOTS)))
    got = {(f.rule, f.symbol.split(".", 1)[1]) for f in findings}
    assert got == {("TRC103", "graphs.step"), ("TRC101", "graphs.fwd"),
                   ("TRC103", "graphs.Scale.forward"),
                   ("TRC104", "kernels.k.ops.public_op"),
                   ("TRC103", "kernels.k.kernel.k_cuda")}
    assert stats["n_kernel_roots"] == 2 and stats["n_graph_roots"] == 3


def test_lint_resolves_imports_through_port_aliases(tmp_path):
    """A helper reached through ``from repro_torch.x import f``, ``import
    repro_torch.x as y`` and a relative import is in tick scope."""
    files = {
        "core/helpers.py": "def a(x):\n    return x.item()\n\n\n"
                           "def b(x):\n    return x.cpu()\n\n\n"
                           "def c(x):\n    return x.tolist()\n",
        "core/tick.py": (
            "import repro_torch.core.helpers as H\n"
            "from repro_torch.core.helpers import a\n"
            "from .helpers import c\n\n\n"
            "def build_tick(plan):\n"
            "    def tick(state):\n"
            "        return a(state) + H.b(state) + c(state)\n"
            "    return tick\n"),
    }
    findings, _ = lint_tree(str(_write(tmp_path / "repro_torch", files)))
    assert {f.symbol for f in findings if f.rule == "TRC103"} == {
        f"repro_torch.core.helpers.{n}" for n in "abc"}


# --------------------------------------------------------------------- #
# The real tree
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_lint():
    linter = Linter(str(SRC_PORT))
    return linter.run(), linter


def test_real_tree_has_no_errors_and_baselined_warnings(port_lint):
    findings, linter = port_lint
    assert [f.format() for f in findings if f.severity == ERROR] == []
    baseline = load_baseline(str(PORT_BASELINE))
    assert [f.format() for f in findings if f.severity == WARNING
            and not baseline.suppresses(f)] == []
    # the expected one: the whole-table copy of every append
    assert ("TRC106", "repro_torch.core.engine._scatter_rows") in {
        (f.rule, f.symbol) for f in findings}
    assert linter.stats["n_obs_sites"] >= 10
    assert not [f for f in findings if f.rule == "TRC107"]


def test_real_tree_every_tick_builder_is_a_root(port_lint):
    _, linter = port_lint
    roots = {f"{mi.module}.{fi.qualname.split('@')[0]}"
             for mi in linter.modules.values()
             for fi in mi.functions.values() if fi.root_kind == "tick"}
    for want in ("core.engine.build_tick_body.body",
                 "core.engine.build_tick.tick",
                 "core.multi.build_multi_tick.tick",
                 "core.multi.build_slot_tick.tick",
                 "core.share.build_node_tick.tick",
                 "runtime.mesh.build_mesh_slot_tick.tick"):
        assert f"repro_torch.{want}" in roots, want
    traced = {f"{mi.module}.{fi.qualname}"
              for mi in linter.modules.values()
              for fi in mi.functions.values() if fi.traced}
    # build_sharded_tick returns build_tick's tick; the helpers the ticks
    # call and the kernels' wrappers are all in tick scope
    for want in ("core.join.join_pairs", "core.join.first_true",
                 "core.engine._scatter_rows", "core.engine._compact",
                 "kernels.compat_join.kernel.compat_join_pairs_cuda",
                 "kernels.compat_join.ops.compat_join_pairs",
                 "kernels.segment_reduce.ops.segment_sum",
                 "kernels.embedding_bag.ops.embedding_bag"):
        assert f"repro_torch.{want}" in traced, want
    # build-time code is not: the builders' label uploads
    assert "repro_torch.core.state.make_batch.a" not in traced


def test_port_baseline_loads_without_error_entries():
    baseline = load_baseline(str(PORT_BASELINE))
    assert baseline.entries
    doc = json.loads(PORT_BASELINE.read_text())
    assert doc["schema"] == "repro_analysis_baseline/v1"
    assert all(e.get("severity") != ERROR for e in doc["suppressions"])
    # each entry either names the roadmap item that removes it, or mirrors
    # the reference's own baseline entry for the same symbol and rule
    ref = {(e["rule"], e["symbol"]) for e in json.loads(
        (ROOT / "analysis_baseline.json").read_text())["suppressions"]}
    for e in doc["suppressions"]:
        mirrored = (e["rule"], e["symbol"].replace("repro_torch.", "repro.", 1))
        assert ("Queue B item 1" in e["justification"]
                or mirrored in ref), e["symbol"]


# --------------------------------------------------------------------- #
# Baselines and reports against the reference
# --------------------------------------------------------------------- #
def test_baseline_reads_the_reference_file_alike():
    port = load_baseline(str(REF_BASELINE))
    ref = ref_findings.load_baseline(str(REF_BASELINE))
    assert port.entries == ref.entries and port.entries


BAD_BASELINES = [
    ({"pass": "lint", "rule": "TRC105", "path": "x.py", "symbol": "f",
      "justification": "   "}, "justification"),
    ({"pass": "lint", "rule": "TRC101", "path": "x.py", "symbol": "f",
      "severity": "error", "justification": "because"},
     "errors must be fixed"),
]


@pytest.mark.parametrize("entry,match", BAD_BASELINES,
                         ids=["no_justification", "error_entry"])
def test_baseline_refuses_what_the_reference_refuses(tmp_path, entry, match):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"suppressions": [entry]}))
    for load in (load_baseline, ref_findings.load_baseline):
        with pytest.raises(ValueError, match=match):
            load(str(p))


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(str(tmp_path / "nope.json")).entries == {}
    assert ref_findings.load_baseline(
        str(tmp_path / "nope.json")).entries == {}


def test_report_json_equals_the_reference_report():
    ref, _ = ref_lint_tree(str(REF_FIXTURES))
    fields = [dataclasses.astuple(f) for f in ref]
    baseline_entry = {fields[0][:1] + fields[0][1:2] + fields[0][3:4]
                      + fields[0][5:6]: "why"}
    want = ref_findings.Report(findings=list(ref), stats={"n": 1}) \
        .split_by_baseline(ref_findings.Baseline(entries=baseline_entry))
    got = Report(findings=[Finding(*t) for t in fields], stats={"n": 1}) \
        .split_by_baseline(ref_findings.Baseline(entries=baseline_entry))
    assert got.to_json() == want.to_json()
    assert got.to_json()["schema"] == "repro_analysis/v1"
    assert got.by_severity() == want.by_severity()
    assert [f.to_json() for f in got.suppressed] \
        == [f.to_json() for f in want.suppressed]


# --------------------------------------------------------------------- #
# kernel_check
# --------------------------------------------------------------------- #
def test_kernel_contracts_prove_clean():
    findings, stats = KC.check_kernels(fast=True)
    assert [f.format() for f in findings] == []
    assert stats["n_launch_sites"] == 4
    assert stats["n_global_kernels"] == 12
    assert set(KC.MODELED_LAUNCHES) == {
        n for _p, n, _l in KC.discover_launch_sites(str(KERNELS))}


def test_lattice_is_the_reference_lattice():
    for name in ("CAPS_FULL", "CAPS_FAST", "SLOTS", "MAX_NEW", "WIDTHS",
                 "FLAG_SETS"):
        assert getattr(KC, name) == getattr(ref_kc, name), name
    assert KC.NON_POW2 == (100, 37)


def test_path_shapes_are_in_the_lattice():
    """The joins the capacity phase runs are 2^31 pairs a slot, at the
    plan's bound; the lattice proves them."""
    joins = {(w, s, ca, cb) for w, s, ca, cb, _f in KC._path_joins()}
    assert ("capacity_l0_j1", 4, 32_768, 65_536) in joins
    assert ("l0_j1", 8, 8192, 65_536) in joins
    assert {s for _w, s, _a, _b in joins} == {1, 2, 4, 8}


def _bump(field, delta):
    real = KC._plan_fn(cj_k)

    def plan(*a):
        p = real(*a)
        return dataclasses.replace(p, **{field: getattr(p, field) + delta})
    return plan


def test_kc101_grid_and_cover(monkeypatch):
    monkeypatch.setattr(cj_k, "plan", _bump("nt", 70_000))
    got = KC.check_tiles_and_bounds(fast=True)
    assert any(f.rule == "KC101" and "grid.y" in f.message for f in got)
    monkeypatch.setattr(cj_k, "plan", _bump("nrt", -1))
    got = KC.check_tiles_and_bounds(fast=True)
    assert any(f.rule == "KC101" and "cover" in f.message for f in got)


def test_kc101_a_refused_path_shape_or_a_failed_plan(monkeypatch):
    monkeypatch.setattr(KC, "GIN_E", -1)                # plan refuses E < 0
    got = KC.check_tiles_and_bounds(fast=True)
    assert any(f.rule == "KC101" and "refuses" in f.message
               and f.symbol.startswith("segment_sum") for f in got)
    monkeypatch.setattr(eb_k, "WAVE_BLOCKS", 0)         # plan divides by it
    got = KC.check_tiles_and_bounds(fast=True)
    assert any(f.rule == "KC101" and "ZeroDivisionError" in f.message
               and f.symbol.startswith("embedding_bag") for f in got)


def test_kc102_tile_not_a_multiple_of_the_window(monkeypatch):
    monkeypatch.setattr(cj_k, "TILE_COLS", (1000, 500))
    got = KC.check_tiles_and_bounds(fast=True)
    assert any(f.rule == "KC102" and "WIN" in f.message for f in got)


def test_kc102_segment_granules(monkeypatch):
    monkeypatch.setattr(sr_k, "RUN", 1000)               # not the SR_RUN
    got = KC.check_tiles_and_bounds(fast=True)
    assert any(f.rule == "KC102" and f.symbol.startswith("segment_sum")
               for f in got)


def _copy_kernels(tmp_path) -> Path:
    dst = tmp_path / "src" / "repro_torch" / "kernels"
    shutil.copytree(KERNELS, dst, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    return dst


def _edit(path: Path, old: str, new: str) -> None:
    src = path.read_text()
    assert old in src
    path.write_text(src.replace(old, new, 1))


@pytest.mark.parametrize("how", ["smem_limit", "plan_fields", "define"])
def test_kc103_on_chip_bounds_and_abi(monkeypatch, tmp_path, how):
    root = None
    if how == "smem_limit":
        monkeypatch.setattr(cj_k, "SMEM_LIMIT", 40_000)
        got = KC.check_tiles_and_bounds(fast=True)
        assert any(f.rule == "KC103" and "assert" in f.message for f in got)
        return
    if how == "plan_fields":
        fields = list(sr_k.PLAN_FIELDS)
        fields[3], fields[4] = fields[4], fields[3]
        monkeypatch.setattr(sr_k, "PLAN_FIELDS", tuple(fields))
    else:
        root = _copy_kernels(tmp_path)
        _edit(root / "compat_join" / "csrc" / "compat_join.cu",
              "#define CJ_WIN 512", "#define CJ_WIN 256")
    got = KC.check_source_contracts(kernels_root=None if root is None
                                    else str(root))
    want = "segment_reduce.PLAN_FIELDS" if how == "plan_fields" \
        else "compat_join.WIN"
    assert [(f.rule, f.symbol) for f in got] == [("KC103", want)]


@pytest.mark.parametrize("what", ["clamp", "n_dropped", "bound"])
def test_kc104_the_proof_needs_the_source_clamps(tmp_path, what):
    root = _copy_kernels(tmp_path)
    cu = root / "compat_join" / "csrc" / "compat_join.cu"
    old, new = {
        "clamp": ("min(run[r] + counts[i], max_new)", "run[r] + counts[i]"),
        "n_dropped": ("n_dropped[s] = utot > (uint32_t)max_new",
                      "n_dropped[s] = tot > max_new"),
        "bound": ("ca * cb - P[P_MAX_NEW] >= (1LL << 31)",
                  "ca * cb >= (1LL << 32)"),
    }[what]
    _edit(cu, old, new)
    got = KC.check_smem_cursor(fast=True, kernels_root=str(root))
    assert got and all(f.rule == "KC104" and f.severity == ERROR
                       for f in got)
    assert KC.check_smem_cursor(fast=True) == []


def test_kc104_the_cursor_stays_an_int(monkeypatch):
    """Before the plan bounded ``max_new`` by 2^31 - 1024, a join of
    65,536 x 49,152 rows at max_new 2^31 - 1 planned, and the emit's
    cursor plus a cell's matches passed an int."""
    monkeypatch.setattr(cj_k, "MAX_NEW_LIMIT", 2**31 - 1)
    got = KC.check_smem_cursor(fast=True)
    assert any(f.rule == "KC104" and "overflows int" in f.message
               for f in got)
    with pytest.raises(ValueError, match="max_new"):
        monkeypatch.undo()
        cj_k.plan(cj_k.PAIRS, 1, 65_536, 49_152, 2, 2, 1, 1, (True,) * 6,
                  False, 2**31 - 1)


@pytest.mark.parametrize("which", ["mask", "pairs", "segment", "bag"])
def test_kc105_a_wrong_output_allocation(monkeypatch, which):
    import torch
    if which == "mask":
        monkeypatch.setattr(cj_k, "mask_output", lambda s, a, b, dev:
                            torch.empty((s, a, b), dtype=torch.int8,
                                        device=dev))
    elif which == "pairs":
        real = cj_k.pairs_outputs
        monkeypatch.setattr(cj_k, "pairs_outputs", lambda s, m, dev: (
            *real(s, m, dev)[:2], real(s, m, dev)[2][:3]))
    elif which == "segment":
        monkeypatch.setattr(sr_k, "sum_output", lambda msg, n:
                            msg.new_empty((n, msg.shape[1]),
                                          dtype=torch.float32))
    else:
        monkeypatch.setattr(eb_k, "bag_output", lambda table, n:
                            table.new_empty(n + 1, table.shape[1]))
    got = KC.check_kernel_ref_agreement(fast=True)
    assert got and all(f.rule == "KC105" for f in got)


def test_kc100_unregistered_launch(tmp_path):
    k = tmp_path / "kernels" / "newk"
    (k / "csrc").mkdir(parents=True)
    (k / "csrc" / "newk.cu").write_text(
        'extern "C" int mystery_launch(const void* x, void* stream) {\n'
        '  return 0;\n}\n__global__ void mystery() {}\n')
    findings, stats = KC.check_kernels(kernels_root=str(tmp_path / "kernels"),
                                       fast=True)
    assert stats == {"n_launch_sites": 1, "n_global_kernels": 1}
    assert [(f.rule, f.severity, f.symbol) for f in findings] == [
        ("KC100", WARNING, "mystery_launch")]


def test_device_limit_check():
    h100 = {"name": "NVIDIA H100 80GB HBM3",
            "smem_per_block_optin": 232_448, "sm_count": 132}
    assert KC.check_device_limits(h100) == []
    other = dict(h100, smem_per_block_optin=101_376, sm_count=108)
    got = {(f.rule, f.symbol) for f in KC.check_device_limits(other)}
    assert got == {("KC103", "compat_join.SMEM_LIMIT"),
                   ("KC101", "segment_reduce.SORT_WAVE"),
                   ("KC101", "segment_reduce.GRID_EDGES"),
                   ("KC101", "embedding_bag.WAVE_BLOCKS")}


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #
def test_cli_green_on_tree_and_writes_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = cli_main(["--fast", "--json", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "repro_analysis/v1"
    assert doc["findings_by_severity"]["error"] == 0
    assert doc["findings_by_severity"]["warning"] == 0
    assert doc["stats"]["n_launch_sites"] == 4
    assert doc["stats"]["n_plans_verified"] >= 10
    assert len(doc["suppressed"]) >= 1
    assert "repro_torch.analysis:" in capsys.readouterr().out


def test_cli_fails_on_error_findings(tmp_path, capsys):
    root = _write(tmp_path, FIXTURES)
    rc = cli_main(["--root", str(root), "--pass", "lint"])
    assert rc == 1
    assert "TRC101" in capsys.readouterr().out


def test_cli_error_on_findings_promotes_warnings(tmp_path, capsys):
    # with an empty baseline the tree's warning becomes a failure under
    # --error-on-findings, but not without it
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"suppressions": []}))
    argv = ["--pass", "lint", "--baseline", str(empty)]
    assert cli_main(argv) == 0
    assert cli_main(argv + ["--error-on-findings"]) == 1
    assert cli_main(argv[:2] + ["--error-on-findings"]) == 0
    capsys.readouterr()
