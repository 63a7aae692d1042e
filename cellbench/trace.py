"""The traced run: the join's range and work, and the reduction of the
profile to per-layer numbers.

``Profile`` wraps, for the traced run only,
``repro_torch.core.join.join_pairs`` (which the engine and the prefix
forest call as ``J.join_pairs``) in a ``join`` range; after each join it
counts on the device, in a ``cellbench.work`` range, the live rows of
both operands and the pairs emitted.  Kernels launched from that range
are the benchmark's own: they are left out of the launches, the busy
time and the breakdown.  The device's idle gaps are named by the
program's own tracer span open on the host at the time.

A device event shares its id with the runtime call (``cudaLaunchKernel``
and the like) that launched it; the range open on the host at that call
is the range the event belongs to.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np

from cellbench import work as W

WINDOW = "cellbench.window"
# the profiled part of the traced window, from its start: the profiler
# records every operation, and reading back a whole window's events
# takes minutes
PROFILED_S = 2.0
WORK = "cellbench.work"
JOIN = "join"
# an idle gap during which no tracer span was open: the batch build
# (``to_batches``), the api's event conversion, the harness
NO_SPAN = "outside spans"


def kernel_name(key: str) -> str:
    """A kernel's name without return type, template arguments and
    parameters: ``void cj_count<Dims<2, 2>, 4>(CJArgs, int*)`` ->
    ``cj_count``."""
    head = key.split("(")[0].split("<")[0].split()
    return head[-1] if head else key


def read_spans(buf) -> list:
    """The tracer's JSON lines as dicts."""
    return [json.loads(line) for line in buf.getvalue().splitlines() if line]


def _union(intervals):
    """Merged ``[start, end]`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profile:
    """``t0 = p.start()``, serve, ``p.stop(n_ticks)``, then
    ``p.summary()``."""

    def __init__(self, torch, cuda: bool):
        self.torch = torch
        self.cuda = cuda
        self.calls = []             # per join: static sizes, count tensor
        self._undo = []
        self._window = None
        self.prof = None
        self.n_ticks = None         # ticks in the profiled window

    # -- wrappers ------------------------------------------------------ #
    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def _join(self, orig):
        torch, rf, calls = self.torch, self.torch.profiler.record_function, \
            self.calls

        def join_pairs(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b, rel,
                       trel, max_new, window=None, *rest, **kw):
            with rf(JOIN):
                out = orig(bind_a, ets_a, valid_a, bind_b, ets_b, valid_b,
                           rel, trel, max_new, window, *rest, **kw)
            with rf(WORK):
                pv = out[2]
                s = pv.shape[0]
                va = valid_a.reshape(s, -1).sum(1) if valid_a.dim() == 2 \
                    else valid_a.sum().expand(s)
                vb = valid_b.reshape(s, -1).sum(1) if valid_b.dim() == 2 \
                    else valid_b.sum().expand(s)
                counts = torch.stack([valid_a.sum(), valid_b.sum(), pv.sum(),
                                      (va * vb).sum()])
            calls.append((dict(
                rows_a=valid_a.numel(), rows_b=valid_b.numel(),
                nva=bind_a.shape[-1], nea=ets_a.shape[-1],
                nvb=bind_b.shape[-1], neb=ets_b.shape[-1], n_slots=s,
                trel_nonzero=int(np.count_nonzero(np.asarray(trel))),
                windowed=window is not None, max_new=int(max_new)), counts))
            return out
        return join_pairs

    def start(self) -> float:
        """Wrap the join, start the profiler and the window range;
        returns the window's start on the host clock."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.core import join as J
        from repro_torch.kernels.compat_join import ops

        self._wrap(J, "join_pairs", self._join)
        self._ops = ops
        self._launches0 = ops.compat_join_pairs.launches
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._window = self.torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self._wall0 = time.time()     # the tracer's clock at the range's start
        return time.perf_counter()

    def stop(self, n_ticks: int) -> None:
        """End the window range after ``n_ticks`` ticks, stop the
        profiler, unwrap the join.  Idempotent."""
        if self.prof is None or self.n_ticks is not None:
            return
        self.n_ticks = n_ticks
        try:
            if self.cuda:
                self.torch.cuda.synchronize()
            self._window.__exit__(None, None, None)
            self.launches = self._ops.compat_join_pairs.launches \
                - self._launches0
            self.prof.__exit__(None, None, None)
        finally:
            for owner, name, orig in reversed(self._undo):
                setattr(owner, name, orig)
            self._undo.clear()

    # -- reduction ----------------------------------------------------- #
    def summary(self, spans=()) -> SimpleNamespace:
        """The profiled window reduced to seconds and counts; ``spans``,
        the program's tracer records, name the idle gaps."""
        from torch.autograd import DeviceType

        evs = list(self.prof.events())
        cpu = [e for e in evs if e.device_type == DeviceType.CPU]
        dev = [e for e in evs if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)]
        win = [e for e in cpu if e.name == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"{len(win)} window ranges in the profile")
        w0, w1 = win[0].time_range.start, win[0].time_range.end

        # a device event and the runtime call that launched it share an
        # id; the call's host time says which range launched it
        dev_ids = {e.id for e in dev}
        launched = {}
        for e in cpu:
            if e.id in dev_ids and e.name.startswith(("cuda", "cu")):
                launched[e.id] = e.time_range.start
        unlinked = sum(e.id not in launched for e in dev)

        def ranges(name):
            rs = sorted((e.time_range.start, e.time_range.end)
                        for e in cpu if e.name == name)
            return np.array([r[0] for r in rs]), np.array([r[1] for r in rs])

        def which(starts, ends, t):
            """Index of the range holding host time t, or -1."""
            k = int(np.searchsorted(starts, t, side="right")) - 1
            return k if k >= 0 and t <= ends[k] else -1

        ws, we = ranges(WORK)
        mine = [e for e in dev
                if e.id not in launched or which(ws, we, launched[e.id]) < 0]
        inside = [e for e in mine if e.time_range.end > w0
                  and e.time_range.start < w1]
        busy = _union([(max(e.time_range.start, w0),
                        min(e.time_range.end, w1)) for e in inside])
        busy_us = sum(e - s for s, e in busy)
        kernels = [e for e in inside
                   if not e.name.startswith(("Memcpy", "Memset"))]
        by_op = {}
        for e in inside:
            k = kernel_name(e.name)
            by_op[k] = by_op.get(k, 0.0) + (e.time_range.end
                                            - e.time_range.start)
        # idle gaps, each named by the tracer span open at its middle on
        # the host; a span ends at its record's wall time ``t0`` (ms)
        edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
        open_spans = [(r["t0"] - r["ms"] / 1e3, r["t0"], r["span"])
                      for r in spans if r["ms"] > 0]

        def host_at(t):
            wall = self._wall0 + (t - w0) / 1e6
            inside = [(s, name) for s, e, name in open_spans
                      if s <= wall <= e]
            return max(inside)[1] if inside else NO_SPAN

        # the joins: each one's device time, from the kernels it launched
        js, je = ranges(JOIN)
        join_dev_us = [0.0] * len(js)
        for e in mine:
            if e.id in launched:
                k = which(js, je, launched[e.id])
                if k >= 0:
                    join_dev_us[k] += e.time_range.end - e.time_range.start
        counts = (self.torch.stack([c for _, c in self.calls]).cpu().numpy()
                  if self.calls else np.zeros((0, 4)))
        least_s = nested_s = 0.0
        n_timed = 0
        for (info, _), cnt, dus in zip(self.calls, counts, join_dev_us):
            if dus <= 0:
                continue            # the profiler caught none of its kernels
            n_timed += 1
            nb, ops = W.join_work(int(cnt[0]), int(cnt[1]), info["rows_a"],
                                  info["rows_b"], info["nva"], info["nea"],
                                  info["nvb"], info["neb"], int(cnt[2]),
                                  info["n_slots"], info["trel_nonzero"],
                                  info["windowed"])
            least_s += W.least_seconds(nb, ops)
            nb2, ops2 = W.nested_loop_work(
                info["rows_a"], info["rows_b"], info["nva"], info["nea"],
                info["nvb"], info["neb"], float(cnt[3]), info["n_slots"],
                info["trel_nonzero"], info["windowed"], info["max_new"])
            nested_s += W.least_seconds(nb2, ops2)
        return SimpleNamespace(
            n_ticks=self.n_ticks, window_s=(w1 - w0) / 1e6,
            busy_s=busy_us / 1e6,
            launches=len(kernels), join_calls=len(self.calls),
            join_ranges=len(js), join_launches=self.launches,
            device_events=len(dev), device_events_unlinked=unlinked,
            join_timed=n_timed,
            join_device_s=sum(d for d in join_dev_us if d > 0) / 1e6,
            join_least_s=least_s, join_nested_loop_least_s=nested_s,
            emitted_pairs=int(counts[:, 2].sum()) if len(counts) else 0,
            device_ops=sorted(([k, v / 1e6] for k, v in by_op.items()),
                              key=lambda kv: -kv[1])[:10],
            idle_gaps=[[host_at(s + g / 2), g / 1e6] for g, s in gaps])
