#!/usr/bin/env python3
"""A cell's window with the program's own spans and counters open, on the
profiler's clock.

    python3 bench/program_trace.py --workload <name> --seed <n> \
        --seconds <s> [--profile 0|1]

The cell runs as `run.py` runs it (set-up, a window of `--seconds`, the
program's state freed, the check), one run a process, with the program's
sinks open around the window only: `repro_torch.tools.opcount.spans` (its
layers' spans), `.counters` (the MoE's dropped and routed entries) and
`repro_torch.kernels.kernel_calls`. With `--profile 1` the window is traced
as `run.py --trace 1` traces it, and the line holds the cell's per-layer
metrics, the readings of `READERS` (per-layer metrics of the program's
spans and counters), the device time launched inside each program span and
the idle time under each, the clock check and the kernel calls beside the
trace's counts. With `--profile 0` the window is not traced and the line
holds the end-to-end metrics: set against `run.py --trace 0` on the same
seed, what the open sinks cost. The result is one JSON line on standard
output. `bench/run.py --trace 1` traces a cell's window the same way when
one of the cell's per-layer metrics reads the program's spans or counters.

Launch times. The trace holds the runtime call that launched each device
event (`cudaLaunchKernel`, `cudaGraphLaunch`, `cudaMemcpyAsync`, ...; the
kernels of a replayed graph share its call) under the event's correlation
id, on the trace's host-side clock. The marker's call, made right after
`TracedWindow` read `time.perf_counter()`, ties that clock to the host
clock, as the marker kernel ties the device events' clock to it. Where the
marker's call went untraced (a second profiler session in one process has
shown none; a first one, once in three runs), the device events' tie
serves the calls too.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import torch  # noqa: E402

from bench import common, profiling  # noqa: E402

OUTSIDE = "outside spans"


class _Sinks:
    """The program's sinks, open from `open()` to `close()`."""

    def open(self):
        from repro_torch.kernels import kernel_calls
        from repro_torch.tools.opcount import counters, spans

        self._stack = contextlib.ExitStack()
        self.spans = self._stack.enter_context(spans.recording())
        self.counts = self._stack.enter_context(counters.recording())
        self.kernel_calls = self._stack.enter_context(kernel_calls.recording())

    def close(self):
        self._stack.close()


class ProgramWindow(profiling.Window):
    """The untraced window, the program's sinks open around it."""

    def __init__(self, device):
        super().__init__(device)
        self.sinks = _Sinks()

    def __enter__(self):
        self.sinks.open()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.sinks.close()
        return False


class ProgramTracedWindow(profiling.TracedWindow):
    """The traced window, the program's sinks open around it. Once closed:
    the program's spans are among `rec.spans` (so idle gaps are named by
    them), `launched` holds (name, start, end, launch) of every device
    event of the window on the host clock (launch None where no runtime
    call of its correlation id was traced) and `marker_latency_us` the
    marker's device start less its launch on the trace's clocks."""

    def __init__(self, device, rec):
        super().__init__(device, rec)
        self.sinks = _Sinks()
        self.launched: list = []
        self.marker_latency_us = None

    def __enter__(self):
        self.sinks.open()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.sinks.close()
        self.rec.spans.extend(self.sinks.spans)
        self._launches()
        return False

    def _launches(self):
        cuda = torch.autograd.DeviceType.CUDA
        calls: dict = {}  # correlation id -> start (us) of the runtime call that launched it
        device = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                device.append((e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
                               e.correlation_id()))
            elif e.name().startswith("cu") and e.correlation_id():
                t = e.start_ns() / 1e3
                calls[e.correlation_id()] = min(t, calls.get(e.correlation_id(), t))
        markers = sorted((d for d in device if profiling.MARKER in d[0]), key=lambda d: d[1])
        dev_off = host_off = self.offset_us
        if markers and markers[-1][3] in calls:
            marker = markers[-1]
            host_off = calls[marker[3]] - self._h_marker * 1e6
            self.marker_latency_us = marker[1] - calls[marker[3]]
        # else the marker's runtime call went untraced (seen once in three
        # runs): the calls are on the device events' clock (the trace's
        # one clock), tied to the host clock at the marker's device start,
        # so each launch reads early by the marker's launch latency (us)
        for name, s, d, cid in device:
            if profiling.MARKER in name:
                continue
            start, end = (s - dev_off) / 1e6, (s + d - dev_off) / 1e6
            if end > self.t0 and start < self.t1:
                launch = calls.get(cid)
                self.launched.append((name, start, end,
                                      None if launch is None else (launch - host_off) / 1e6))


# --- reading the program's spans against the trace ------------------------------------


def program_spans(trace) -> list:
    """The program's spans of the window (dotted names: `service.chunk`, ...)."""
    mid = [s for s in trace.rec.spans if "thread" in s[3] and "." in s[0]]
    return [s for s in mid if trace.t0 <= 0.5 * (s[1] + s[2]) <= trace.t1]


def innermost(spans) -> list:
    """[(start, end, name)]: the innermost of `spans` (one thread's, nested)
    open over each stretch of time between the first start and the last
    end; name None where none is open."""
    segs, stack, cur = [], [], None

    def advance(to):
        nonlocal cur
        if cur is not None and to > cur:
            segs.append((cur, to, stack[-1][0] if stack else None))
        cur = to if cur is None else max(cur, to)

    for sp in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= sp[1]:
            advance(stack[-1][2])
            stack.pop()
        advance(sp[1])
        stack.append(sp)
    while stack:
        advance(stack[-1][2])
        stack.pop()
    return segs


def _named_at(segs, starts, t):
    """The name of the segment of `segs` (starts `starts`) holding `t`, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i][2]
    return None


def launch_thread(spans, launched):
    """The thread whose spans hold the most device launches."""
    best, most = None, -1
    for thread in {s[3]["thread"] for s in spans}:
        segs = [g for g in innermost([s for s in spans if s[3]["thread"] == thread])
                if g[2] is not None]
        starts = [g[0] for g in segs]
        n = sum(_named_at(segs, starts, e[3]) is not None for e in launched
                if e[3] is not None)
        if n > most:
            best, most = thread, n
    return best


def _thread_segments(trace):
    spans = program_spans(trace)
    thread = launch_thread(spans, trace.launched)
    segs = innermost([s for s in spans if s[3]["thread"] == thread])
    return [g for g in segs if g[2] is not None]


def idle_by_span(trace) -> dict:
    """Idle seconds of the window by the innermost program span open on the
    launching thread (`OUTSIDE`: none open); they add up to the idle time."""
    segs = _thread_segments(trace)
    edges = [trace.t0] + [x for iv in trace.intervals for x in iv] + [trace.t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out: dict = {}
    i = 0
    for a, b, name in segs:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            over = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if over > 0:
                out[name] = out.get(name, 0.0) + over
            j += 1
    idle = sum(b - a for a, b in gaps)
    out[OUTSIDE] = idle - sum(out.values())
    return out


def _device_parts(trace) -> list:
    """[(span, event name, seconds)]: each device event's share of the busy
    time (where events overlap, the earlier-starting one holds the time) and
    the innermost program span open on the launching thread at its launch
    (`OUTSIDE`: none, or no launch traced)."""
    segs = _thread_segments(trace)
    starts = [g[0] for g in segs]
    parts = []
    covered = trace.t0
    for name, s, e, launch in sorted(trace.launched, key=lambda x: x[1]):
        part = min(e, trace.t1) - max(s, covered)
        covered = max(covered, min(e, trace.t1))
        if part > 0:
            span = _named_at(segs, starts, launch) if launch is not None else None
            parts.append((span or OUTSIDE, name, part))
    return parts


def device_by_span(trace) -> dict:
    """Device busy seconds of the window by the innermost program span open
    on the launching thread at each event's launch; they add up to the busy
    time."""
    out: dict = {}
    for span, _, part in _device_parts(trace):
        out[span] = out.get(span, 0.0) + part
    return out


def top_ops_by_span(trace, top: int = 4) -> dict:
    """Each span's `top` device operations by busy seconds (names cut to 80)."""
    by: dict = {}
    for span, name, part in _device_parts(trace):
        ops = by.setdefault(span, {})
        ops[name[:80]] = ops.get(name[:80], 0.0) + part
    return {span: sorted(ops.items(), key=lambda kv: -kv[1])[:top] for span, ops in by.items()}


def clock_check(trace) -> dict:
    """Device events that start before their launch, on the host clock: in
    all, beyond the marker's own launch latency (the device clock is tied
    to the host clock at the marker's start, so an event that starts sooner
    after its launch than the marker did reads early by the difference),
    and in each tenth of the window (a jump of the trace's clocks shows as
    a tenth whose earliest event is far earlier than the rest)."""
    rows = [(s, s - launch) for _, s, _, launch in trace.launched if launch is not None]
    if not rows:
        return {"events": len(trace.launched), "with_launch": 0}
    lat = 1e-6 * (trace.marker_latency_us or 0.0)
    early = [-lag for _, lag in rows if lag < 0]
    tenths = []
    for i in range(10):
        lo = trace.t0 + 0.1 * i * trace.window_s
        lags = [lag for s, lag in rows if lo <= s < lo + 0.1 * trace.window_s]
        tenths.append([sum(lag < 0 for lag in lags) / len(lags), 1e6 * min(lags)]
                      if lags else None)
    return {"events": len(trace.launched), "with_launch": len(rows),
            "at_or_after_launch_share": 1.0 - len(early) / len(rows),
            "within_marker_latency_share": sum(lag >= -lat for _, lag in rows) / len(rows),
            "worst_before_launch_us": 1e6 * max(early) if early else 0.0,
            "marker_latency_us": trace.marker_latency_us,
            "by_tenth": tenths}


def _count(trace, name) -> int:
    return sum(1 for s in program_spans(trace) if s[0] == name)


# Readers a per-layer metric of the program's spans or counters is made of
# (`bench/metrics/<name>.py`: `read = program_trace.device_ms_per(...)`).


def _launches_traced(trace) -> bool:
    return any(e[3] is not None for e in trace.launched)


def idle_pct_in(prefix):
    """A reader: % of the traced window the card is idle under a program span
    whose name starts with `prefix`, innermost on the launching thread."""
    def read(run):
        t = run.trace
        if not _launches_traced(t):
            return None
        idle = idle_by_span(t)
        return 100.0 * sum(v for k, v in idle.items() if k.startswith(prefix)) / t.window_s
    return read


def device_ms_per(span, per):
    """A reader: device ms launched inside the program span `span` over the
    count of the program spans `per`."""
    def read(run):
        t = run.trace
        n = _count(t, per)
        if not n or not _launches_traced(t):
            return None
        return 1e3 * device_by_span(t).get(span, 0.0) / n
    return read


def counter_pct(part, whole):
    """A reader: the program's counter `part` as a % of its counter `whole`."""
    def read(run):
        counts = run.trace.sinks.counts
        total = counts.get(whole, 0)
        return 100.0 * counts.get(part, 0) / total if total else None
    return read


KMEANS, PREFILL = "kmeans-d64-k256.large_jobs", "granite-moe-3b-a800m.secure_prefill"
# Per-layer metrics of the program's spans and counters: name -> (the cell
# they are read in, reader). The prefill's are BENCHMARK.json's metrics
# (`bench/metrics/<name>.py` wraps each); the k-means cell's are not, since
# its traced window keeps the program's sinks closed (PERF.md).
READERS = {
    "idle_in_service_pct.kmeans": (KMEANS, idle_pct_in("service.")),
    "idle_in_driver_pct.kmeans": (KMEANS, idle_pct_in("driver.")),
    "statics_load_ms_per_round.kmeans": (KMEANS, device_ms_per("driver.load", "driver.replay")),
    "attention_ms_per_prefill": (PREFILL, device_ms_per("engine.attention", "engine.prefill")),
    "moe_route_ms_per_prefill": (PREFILL, device_ms_per("moe.route", "engine.prefill")),
    "exchange_ms_per_prefill": (PREFILL, device_ms_per("shuffle.exchange", "engine.prefill")),
    "experts_ms_per_prefill": (PREFILL, device_ms_per("moe.experts", "engine.prefill")),
    "moe_dropped_pct.prefill": (PREFILL, counter_pct("moe.dropped_entries",
                                                     "moe.routed_entries")),
}


# A prefill as a synthetic trace shows it, for the CPU tests of the metrics
# that read it: the program's spans of one thread (name, start, end), device
# events (name, start, end, launch) launched inside them, and the counters.
PREFILL_SAMPLE = {
    "spans": [("engine.prefill", 0.62, 0.98), ("engine.attention", 0.63, 0.70),
              ("moe.route", 0.70, 0.75), ("shuffle.exchange", 0.75, 0.80),
              ("moe.experts", 0.80, 0.86), ("shuffle.exchange", 0.86, 0.90)],
    "events": [("attention_prefill_kernel", 0.64, 0.68, 0.635), ("sort", 0.71, 0.73, 0.705),
               ("chacha20_xor_packed", 0.76, 0.78, 0.755), ("gemm", 0.81, 0.84, 0.805),
               ("chacha20_xor_packed", 0.87, 0.89, 0.865), ("copy", 0.92, 0.95, 0.915)],
    "counts": {"moe.dropped_entries": 3, "moe.routed_entries": 40},
}


def summary(trace) -> dict:
    """The traced window's breakdown by program span, the clock check and the
    kernel calls beside the trace's counts."""
    rounds, prefills = _count(trace, "driver.replay"), _count(trace, "engine.prefill")
    return {"busy_s": trace.busy_s, "window_s": trace.window_s,
            "launch_thread": launch_thread(program_spans(trace), trace.launched),
            "rounds": rounds, "prefills": prefills,
            "device_s_by_span": device_by_span(trace), "idle_s_by_span": idle_by_span(trace),
            "top_ops_by_span": top_ops_by_span(trace),
            "clock": clock_check(trace), "counts": dict(trace.sinks.counts),
            "kernel_calls": dict(trace.sinks.kernel_calls),
            "trace_counts": {k: trace.count(common.kernel_names(k))
                             for k in ("chacha20", "kmeans_assign", "attention_prefill")}}


def run(workload: str, seed: int, seconds: float, profile: bool, *, device: str = "cuda",
        adjust=None, spec=None) -> dict:
    """One run of one cell with the program's sinks open around its window."""
    from bench.run import _gc_spans

    cs = common.cell_spec(workload, spec)
    if adjust is not None:
        adjust(cs)
    rec = common.Recorder()
    cell = common.driver(cs["traffic"]["kind"]).Cell(cs, seed=seed, device=device, rec=rec)
    cell.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    scope = ProgramTracedWindow(device, rec) if profile else ProgramWindow(device)
    gc_spans = _gc_spans(rec)
    gc.callbacks.append(gc_spans)
    try:
        cell.window(seconds, scope)
    finally:
        gc.callbacks.remove(gc_spans)
    line = {"workload": workload, "seed": seed, "profile": int(profile),
            "program_spans": len(scope.sinks.spans)}
    if profile:
        view = cell.readings(scope)
        line["per_layer"] = {m["name"]: common.metric_reader(m["name"])(view)
                             for m in cs["per_layer"]}
        line["program"] = {name: read(view) for name, (cell, read) in READERS.items()
                           if cell == workload}
        line["trace"] = summary(scope)
        line["breakdown"] = scope.breakdown()
    else:
        line["end_to_end"] = cell.end_to_end()
    failed = cell.failed
    cell.release()
    correct, checks = common.judge(cell.check(), cs["limits"])
    line["correct"] = bool(correct and failed == 0)
    line["checks"] = checks
    if hasattr(cell, "dropped_share"):
        line["reference_dropped_pct"] = 100.0 * cell.dropped_share
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for var in [v for v in os.environ if v.startswith("REPRO_")]:
        del os.environ[var]  # the port's knobs at their defaults
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card; no result", file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds, bool(args.profile))
    line["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
