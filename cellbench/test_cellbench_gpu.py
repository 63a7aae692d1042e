"""Each cell once on the card, end to end through the command line: the
result line's keys, ``correct``, and the checks printed last."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from cellbench.trace import PROFILED_S

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    # a traced window needs ticks after its profiled part for the tail
    # and the span readers
    seconds = PROFILED_S + 6 if trace else 3
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    for m in BENCH[kind]:
        if cell in m.get("workloads", [cell]):
            assert m["name"] in res["metrics"], m["name"]
    last = out.stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[0] for line in last] == list(res["checks"])
