"""The program tracer's cost when on, on the card: one session of a cell
serves its window in blocks of ticks, with the tracer on in every other
block and no profiler.

    python3 cellbench/tracer_cost.py --workload caida_c2.wide_b16k \
        --seed 7 --seconds 20 --block 10

Prints one JSON line: the median tick with the tracer off and on (host
clock, each tick from the end of the one before it), the records a tick,
and the microseconds a tick spent inside the tracer's record writes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--block", type=int, default=10)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from cellbench import gen, harness, tenants
    from cellbench.run import _cell
    from repro_torch.obs.trace import memory_tracer

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic = _cell(bench, args.workload)
    n_edges, warm = harness.stream_length(cfg, traffic, args.seconds)
    st = dict(cfg["stream"])
    social = st.pop("generator") == "social"
    cols = gen.stream_columns(n_edges, args.seed, social=social, **st)
    b = traffic["batch"]
    chunks = [gen.edges(cols, i, i + b) for i in range(0, n_edges, b)]
    sess = harness.make_session(cfg, "cuda")
    for spec in cfg["tenants"]:
        sess.register(tenants.pattern(spec)).on_match = lambda m: None
    tracer, buf = memory_tracer()
    spent = [0.0]
    emit = tracer._emit

    def timed_emit(*a, **k):
        t = time.perf_counter()
        emit(*a, **k)
        spent[0] += time.perf_counter() - t
    tracer._emit = timed_emit

    def serve(chunk):
        sess.serve(chunk, batch_size=b, min_batch=b, max_batch=b,
                   final_checkpoint=False)

    for chunk in chunks[:warm]:
        serve(chunk)
    torch.cuda.synchronize()
    ticks = {False: [], True: []}
    records = spent_s = 0
    t_start = last = time.perf_counter()
    for k, chunk in enumerate(chunks[warm:]):
        if last - t_start >= args.seconds:
            break
        on = (k // args.block) % 2 == 1
        sess.service.tracer = tracer if on else None
        n0, s0 = tracer.n_spans, spent[0]
        serve(chunk)
        now = time.perf_counter()
        ticks[on].append(now - last)
        last = now
        if on:
            records += tracer.n_spans - n0
            spent_s += spent[0] - s0
        buf.seek(0)
        buf.truncate()
    n_on = len(ticks[True])
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "ticks_off": len(ticks[False]), "ticks_on": n_on,
        "tick_ms_median_off": 1e3 * float(np.median(ticks[False])),
        "tick_ms_median_on": 1e3 * float(np.median(ticks[True])),
        "records_per_tick": records / n_on if n_on else None,
        "tracer_us_per_tick": 1e6 * spent_s / n_on if n_on else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
