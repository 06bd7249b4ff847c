"""What every cell's run shares: the spec files found by name, seeds,
spans, and the judge that decides `correct`.

Layout under `bench/` (a later cell, configuration or metric adds files):
  configs/<config>.json    a configuration as it is run (the file
                           BENCHMARK.json names): source, deployment or model
                           sizes, `reduced`, `assumed`; a language model's
                           also `reference_module`, its module under
                           `reference/` (`granite_moe` where absent: see
                           `drivers/lm.py`), and `tiny`, model sizes the CPU
                           tests set after `tiny.TINY_MODEL`
  reference/<module>.py    a plain reference: plain PyTorch, nothing of the
                           port; a language model's gives its weights, its
                           forward pass and its counts (`drivers/lm.py`)
  traffic/<workload>.json  a cell's traffic: `kind` picks `drivers/<kind>.py`,
                           the rest are its parameters
  limits/<workload>.json   each number the check compares, with its limit
  metrics/<metric>.py      one per-layer metric: `read(run)` -> number or
                           None, and optionally
                             KERNEL   the name of its `metrics/kernels/
                                      <KERNEL>.txt`: a kernel's metric, which
                                      reads None where the trace lacks it
                             PROGRAM  True where it reads the port's spans or
                                      counters: a cell that reports it has
                                      its `--trace 1` window traced with the
                                      port's sinks open
                                      (`program_trace.ProgramTracedWindow`)
                             SAMPLE   its own synthetic input for the CPU
                                      tests, merged into their default one:
                                      trace "events" (name, start, end[,
                                      launch]), the port's "spans" (name,
                                      start, end), its "counts", "facts"
  metrics/kernels/<name>.txt  a kernel's names in the trace, one a line
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_spec(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def cell_spec(workload: str, spec: dict | None = None) -> dict:
    """Everything one cell needs, looked up by the names in BENCHMARK.json
    (or in `spec`, a benchmark of the same shape)."""
    spec = spec or load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    files = {c["name"]: c["file"] for c in spec["configs"]}
    config = json.loads((ROOT / files[cell["config"]]).read_text())
    traffic = read_json("traffic", workload)

    def reported(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    end_to_end = [m for m in spec["end_to_end"] if reported(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"] if reported(m) and m["moves"] in names]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": read_json("limits", workload), "end_to_end": end_to_end,
            "per_layer": per_layer}


def metric_module(name: str):
    """`metrics/<name>.py` (names may hold dots, so load by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    return metric_module(name).read


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, data, prompts, ...) of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def kernel_names(name: str) -> tuple[str, ...]:
    """`metrics/kernels/<name>.txt`: one kernel name (or a part of one) a line."""
    lines = (BENCH / "metrics" / "kernels" / f"{name}.txt").read_text().splitlines()
    return tuple(ln.strip() for ln in lines if ln.strip() and not ln.startswith("#"))


def forbidden_loaded(modules=None) -> list[str]:
    """Modules of JAX or of the JAX package among `modules` (default: those
    loaded in this process), compared by their whole top-level name."""
    tops = {m.split(".")[0] for m in (list(sys.modules) if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class Recorder:
    """Spans (name, start, end, attrs) on the host clock."""

    def __init__(self):
        self.spans: list[tuple] = []

    @contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            self.spans.append((name, t0, time.perf_counter(), attrs))

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        self.spans.append((name, t0, t1, attrs))

    def of(self, name: str) -> list[tuple]:
        return [s for s in self.spans if s[0] == name]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit, and none is missing."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name)
        limit = spec["limit"]
        good = value is not None and value == value and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def quantile(values, q: float) -> float:
    """The q-th quantile by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Readings:
    """What a per-layer metric reads: the traced window (`trace`), the
    spans (`rec`), the cell's files (`cs`) and the window loop's
    facts about the window's work (`facts`)."""

    def __init__(self, trace, rec, cs, facts):
        self.trace, self.rec, self.cs, self.facts = trace, rec, cs, facts
