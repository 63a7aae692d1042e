"""The check's readings on the card: sound runs and the control.

    python3 cellbench/control.py --workload caida_c2.wide_b16k \
        --seconds 8 --control-max-new 4096 --seeds 11 12 13

For every seed, in one process: a run of the program as configured (the
lower reading: every number compared, which sound runs must hold at 0),
and a run of the control, the program with its pair budget
(``max_new``) cut to ``--control-max-new``, so that a join drops pairs
and the answer is no longer exact (the upper reading).  Prints one JSON
line a run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-max-new", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from cellbench import harness
    from cellbench.run import _cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic = _cell(bench, args.workload)
    for seed in args.seeds:
        for max_new in (None, args.control_max_new):
            t0 = time.perf_counter()
            run, check = harness.run_cell(cfg, traffic, seed, args.seconds,
                                          False, device="cuda",
                                          max_new=max_new)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "side": "sound" if max_new is None else "control",
                "max_new": max_new or cfg["service"]["max_new"],
                "checks": {k: v["value"] for k, v in check.items()},
                "matches": run.n_matches,
                "fewest_by_a_tenant": min(run.tenant_matches.values()),
                "ticks": len(run.overflow), "run_s": time.perf_counter() - t0,
                "edges_per_s": run.window_edges / run.window_s}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
