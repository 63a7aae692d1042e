"""Run one cell of the benchmark once, on the card, and print its result.

    python3 cellbench/run.py --workload caida_c2.wide_b16k --seed 7 \
        --seconds 20 --trace 0

The cell, its configuration and traffic and its metrics are found by
name from ``BENCHMARK.json`` at the root of the checkout: the
configuration file it names, ``cellbench/traffic/<traffic>.json``, and a
reader a metric under ``cellbench/metrics/``.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
traced run.  The last line of standard output is one JSON object:
``correct``, ``attempted`` (edges offered in the window), ``failed``
(edges of window ticks that dropped an append), ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, ``tenant_matches`` (the matches each
tenant received, every one of them compared), and last ``checks``: each
number compared with its limit, also the last lines of standard error.

Exits 2 without a result when there is no CUDA device or too few, 3 when
the program cannot be imported, 4 when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "cellbench_out"


def _cell(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (ROOT / "cellbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return cell, cfg, traffic


def _metrics(bench: dict, name: str, trace: bool) -> list:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if name in m.get("workloads", [name])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    trace = bool(args.trace)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic = _cell(bench, args.workload)
    wanted = _metrics(bench, args.workload, trace)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # the port builds its kernels into src/repro_torch/kernels/build/, a
    # fixed path inside the checkout: only a checkout's first run builds

    import torch

    # one host thread: the tick's host work is Python and small copies
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import repro_torch.api  # noqa: F401
    except ImportError as e:
        print(f"cannot import the program: {e}", file=sys.stderr)
        return 3
    from cellbench import harness

    run, check = harness.run_cell(cfg, traffic, args.seed, args.seconds,
                                  trace, device="cuda", t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 4
    if trace and run.trace.join_calls != run.trace.join_launches:
        print(f"{run.trace.join_calls} wrapped join calls, "
              f"{run.trace.join_launches} compat_join_pairs launches",
              file=sys.stderr)
        return 5

    metrics = {}
    for m in wanted:
        value = harness.load_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    warm = run.warm_ticks
    window_over = run.overflow[warm:]
    window_chunks = run.chunks[warm:]
    failed = sum(c for c, o in zip(window_chunks, window_over) if o > 0)
    correct = all(c["value"] <= c["limit"] for c in check.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct, "attempted": run.window_edges,
           "failed": failed, "metrics": metrics, "device": device}
    OUT.mkdir(exist_ok=True)
    stem = f"{args.workload}.{args.seed}.t{args.trace}"
    (OUT / f"{stem}.ticks.json").write_text(json.dumps(run.tick_s))
    if trace:
        t = run.trace
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
        (OUT / f"{stem}.trace.json").write_text(
            json.dumps(vars(t), indent=1))
    out["tenant_matches"] = run.tenant_matches
    print(f"host: set-up {run.setup_s:.3f} s, window ticks "
          f"{len(run.tick_s)}, tick median "
          f"{1e3 * float(np.median(run.tick_s)):.3f} ms, max RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024} MiB",
          file=sys.stderr)
    out["checks"] = check
    print("matches by tenant: " + ", ".join(
        f"{k} {v}" for k, v in run.tenant_matches.items()), file=sys.stderr)
    for name, c in check.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
