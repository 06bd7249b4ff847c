#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernel builds, data or weights drawn on the card from the
seed, every shape of the cell warmed) is timed as `setup_s`; then the
traffic runs for `--seconds`. `--trace 0` reports the cell's end-to-end
metrics; `--trace 1` wraps the window in torch.profiler and reports its
per-layer metrics, with the device's busy seconds and the traced window.
A cell one of whose per-layer metrics reads the port's own spans or
counters (`PROGRAM` in its `metrics/<name>.py`) has the port's sinks open
around its traced window (`program_trace.ProgramTracedWindow`); every
other cell's traced window, and every untraced one, leaves them closed.
Once the window has closed and the program's state is freed, the plain
reference judges what the timed path produced: each number compared is
printed beside its limit, last on standard error and last in the result
line (`checks`). Every `REPRO_*` variable is removed from the environment
first, so the port runs with its defaults. Without a CUDA card the run
fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "bench":
    sys.path.pop(0)  # run as a script: keep bench/'s files from shadowing top-level modules
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]


def _gc_spans(rec):
    """A gc callback that records each full (generation 2) collection as a
    span `gc2`, so that an idle gap it causes is named by it."""
    started = []

    def callback(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                started.append(time.perf_counter())
            elif started:
                rec.add_span("gc2", started.pop(), time.perf_counter())

    return callback


def window_scope(cs: dict, device: str, rec, trace: bool):
    """The cell's window: untraced, traced, or traced with the port's sinks
    open where one of the cell's per-layer metrics reads them."""
    from bench import common, profiling

    if not trace:
        return profiling.Window(device)
    if any(getattr(common.metric_module(m["name"]), "PROGRAM", False) for m in cs["per_layer"]):
        from bench import program_trace

        return program_trace.ProgramTracedWindow(device, rec)
    return profiling.TracedWindow(device, rec)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             chips: int = 1, adjust=None, t_start: float | None = None, spec=None):
    """One run of one cell: (result dict, checks). `adjust(cell_spec)` may
    change the cell's files as loaded (tests shrink them for the CPU);
    `spec` stands in for BENCHMARK.json."""
    import torch

    from bench import common

    t_start = time.perf_counter() if t_start is None else t_start
    cs = common.cell_spec(workload, spec)
    if adjust is not None:
        adjust(cs)
    rec = common.Recorder()
    cell = common.driver(cs["traffic"]["kind"]).Cell(cs, seed=seed, device=device, rec=rec)
    cell.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    scope = window_scope(cs, device, rec, trace)
    gc_spans = _gc_spans(rec)
    gc.callbacks.append(gc_spans)
    try:
        cell.window(seconds, scope)
    finally:
        gc.callbacks.remove(gc_spans)
    setup_s = scope.t0 - t_start
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    metrics = {}
    if trace:
        view = cell.readings(scope)
        for m in cs["per_layer"]:
            value = common.metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(cell.end_to_end(), setup_s=setup_s)
        for m in cs["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    attempted, failed = cell.attempted, cell.failed
    cell.release()
    correct, checks = common.judge(cell.check(), cs["limits"])
    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=scope.busy_s, window_s=scope.window_s)
        result["breakdown"] = scope.breakdown()
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var in [v for v in os.environ if v.startswith("REPRO_")]:
        del os.environ[var]  # the port's knobs at their defaults

    import torch

    from bench import common

    chips = common.cell_spec(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} CUDA card(s), this machine has {have}; "
              "no result", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              chips=chips, t_start=T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"bench: the process loaded {found} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
