"""The program's spans and counters read against a trace (`program_trace.py`):
the two helpers on a synthetic trace (idle time and device time by the
innermost program span, which add up to the idle and the busy time), every
reader of `READERS` on it, the cell's existing readers unchanged with the
program's spans merged in, the port's dropped-entry counter against the
reference's count, a cell run with `--trace 0` opening no sink of the
program's, and a window with the sinks open on the CPU."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from bench import common, profiling, program_trace, tiny
from bench.drivers import lm
from bench.run import run_cell, window_scope
from bench.test_bench_guards import _facts
from bench.test_bench_reference import _granite_model

SEED = 2**31 + 77
PREFILL = program_trace.PREFILL

# one thread's program spans (name, start, end): a prefill's regions, then a
# pass of the service with a chunk of two rounds and a job's finish
_SPANS = [("engine.prefill", 0.00, 0.40), ("engine.attention", 0.02, 0.08),
          ("moe.route", 0.08, 0.12), ("shuffle.exchange", 0.12, 0.16),
          ("moe.experts", 0.16, 0.22), ("shuffle.exchange", 0.22, 0.26),
          ("service.pass", 0.50, 0.95), ("service.chunk", 0.50, 0.80),
          ("driver.load", 0.51, 0.55), ("driver.replay", 0.55, 0.56),
          ("driver.halt_read", 0.56, 0.65), ("driver.replay", 0.65, 0.66),
          ("driver.halt_read", 0.66, 0.70), ("driver.gather", 0.70, 0.72),
          ("service.finish", 0.82, 0.90)]
# device events (name, start, end, launch): each launched inside a span
# above, and one whose launch the trace lacks
_LAUNCHED = [("elementwise", 0.03, 0.05, 0.025), ("softmax", 0.05, 0.09, 0.03),
             ("sort", 0.10, 0.11, 0.09), ("chacha20_xor_packed", 0.13, 0.15, 0.125),
             ("gemm", 0.17, 0.21, 0.165), ("chacha20_xor_packed", 0.23, 0.25, 0.225),
             ("copy", 0.30, 0.35, 0.30), ("Memcpy DtoD", 0.52, 0.54, 0.515),
             ("kmeans_assign_kernel", 0.555, 0.60, 0.551),
             ("kmeans_assign_kernel", 0.655, 0.69, 0.651), ("Memcpy DtoH", 0.71, 0.715, 0.705),
             ("copy", 0.84, 0.85, 0.83), ("fill", 0.97, 0.98, None)]


def _trace(program=True):
    t = program_trace.ProgramTracedWindow.__new__(program_trace.ProgramTracedWindow)
    t.rec = common.Recorder()
    t.rec.add_span("prefill", 0.0, 0.4)
    t.rec.add_span("job", 0.5, 0.9, n=1000)
    if program:
        for name, a, b in _SPANS:
            t.rec.add_span(name, a, b, job=None, parent=None, thread="worker")
    t.t0, t.t1 = 0.0, 1.0
    t.launched = list(_LAUNCHED)
    t.events = [e[:3] for e in _LAUNCHED]
    t.busy_s, t.intervals = profiling._union(t.events, t.t0, t.t1)
    t.marker_latency_us = 5.0
    t.sinks = SimpleNamespace(spans=[], kernel_calls={"chacha20_xor_packed": 2},
                              counts={"moe.dropped_entries": 3, "moe.routed_entries": 40})
    return t


def test_bench_idle_by_span_adds_up_to_the_idle_time():
    t = _trace()
    idle = program_trace.idle_by_span(t)
    assert math.isclose(sum(idle.values()), t.window_s - t.busy_s, abs_tol=1e-12)
    assert all(v >= -1e-12 for v in idle.values())
    assert math.isclose(idle["driver.halt_read"], (0.65 - 0.60) + (0.70 - 0.69))
    assert math.isclose(idle["service.finish"], 0.08 - 0.01)
    assert math.isclose(idle[program_trace.OUTSIDE], 0.10 + 0.02 + 0.02)


def test_bench_device_by_span_adds_up_to_the_busy_time():
    t = _trace()
    dev = program_trace.device_by_span(t)
    assert math.isclose(sum(dev.values()), t.busy_s, abs_tol=1e-12)
    assert math.isclose(dev["engine.attention"], 0.06)  # overlapping events count once
    assert math.isclose(dev["shuffle.exchange"], 0.04)
    assert math.isclose(dev["driver.load"], 0.02)
    assert math.isclose(dev["engine.prefill"], 0.05)  # the region's remainder
    assert math.isclose(dev[program_trace.OUTSIDE], 0.01)  # no launch traced


def test_bench_clock_check_counts_events_before_their_launch():
    t = _trace()
    t.launched.append(("late", 0.40, 0.41, 0.40 + 20e-6))
    got = program_trace.clock_check(t)
    assert got["with_launch"] == len(_LAUNCHED)
    assert math.isclose(got["worst_before_launch_us"], 20.0)
    assert math.isclose(got["at_or_after_launch_share"], 1 - 1 / len(_LAUNCHED))
    assert math.isclose(got["within_marker_latency_share"], 1 - 1 / len(_LAUNCHED))
    t.marker_latency_us = 25.0  # the late one starts sooner after its launch than the marker
    assert program_trace.clock_check(t)["within_marker_latency_share"] == 1.0
    tenths = got["by_tenth"]
    assert len(tenths) == 10 and math.isclose(tenths[4][1], -20.0)
    assert sum(share > 0 for share, _ in filter(None, tenths)) == 1
    assert tenths[9] is None  # no launch traced there


@pytest.mark.parametrize("name", sorted(program_trace.READERS))
def test_bench_program_reader_reads_synthetic_input(name):
    run = common.Readings(trace=_trace(), rec=None, cs=None, facts=_facts())
    read = program_trace.READERS[name][1]
    value = read(run)
    assert value is not None and math.isfinite(value) and value >= 0, name
    t = _trace()
    t.launched = []  # no launches traced: the span readers find nothing
    empty = common.Readings(trace=t, rec=None, cs=None, facts=_facts())
    if name != "moe_dropped_pct.prefill":
        assert read(empty) is None


def test_bench_program_readings_on_synthetic_input():
    run = common.Readings(trace=_trace(), rec=None, cs=None, facts=_facts())
    got = {name: read(run) for name, (_, read) in program_trace.READERS.items()}
    assert math.isclose(got["statics_load_ms_per_round.kmeans"], 1e3 * 0.02 / 2)
    assert math.isclose(got["exchange_ms_per_prefill"], 40.0)
    assert math.isclose(got["moe_dropped_pct.prefill"], 7.5)
    assert math.isclose(got["idle_in_driver_pct.kmeans"],
                        100 * (0.02 + 0.005 + 0.06 + 0.005 + 0.015))
    summary = program_trace.summary(run.trace)
    assert summary["rounds"] == 2 and summary["prefills"] == 1
    assert summary["launch_thread"] == "worker"
    assert summary["trace_counts"] == {"chacha20": 2, "kmeans_assign": 2,
                                       "attention_prefill": 0}
    top = summary["top_ops_by_span"]
    assert [name for name, _ in top["engine.attention"]] == ["softmax", "elementwise"]
    assert math.isclose(dict(top["driver.replay"])["kmeans_assign_kernel"], 0.045 + 0.035)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  tiny.with_unlisted(common.load_spec())["per_layer"]
                                  if not getattr(common.metric_module(m["name"]), "PROGRAM",
                                                 False)])
def test_bench_existing_reader_reads_the_same_with_program_spans(name):
    """A metric that reads no program span or counter reads the same with
    the program's spans merged into the window's."""
    read = common.metric_reader(name)
    plain = read(common.Readings(trace=_trace(False), rec=None, cs=None, facts=_facts()))
    merged = read(common.Readings(trace=_trace(True), rec=None, cs=None, facts=_facts()))
    assert plain == merged


def test_bench_port_dropped_entries_equal_the_reference():
    """The port's `moe.dropped_entries` over a tiny float32 granite prefill
    equals the reference's count of entries past capacity, exactly."""
    from repro_torch.mesh import VirtualMesh
    from repro_torch.serve.engine import init_cache, prefill
    from repro_torch.tools.opcount import counters

    cs = {"config": {"model": dict(_granite_model()),
                     "deployment": {"shards": 4, "secure_moe": True}},
          "traffic": {"kind": "prefill", "batch": 2, "prompt_tokens": 32}}
    cell = lm.LMBase(cs, seed=12, device="cpu", rec=None)
    cell.build(VirtualMesh(4, "cpu"))
    toks = lm.prompts(cell.m, 12, "t", 2, 32, "cpu")
    with counters.recording() as counts:
        prefill(cell.cfg, cell.model, toks, init_cache(cell.cfg, 2, 32, "cpu"), mesh=cell.mesh,
                secure_moe=cell.secure)
    stats: dict = {}
    cell.reference(toks, [31], stats=stats)
    assert stats["dropped"] > 0
    assert counts["moe.dropped_entries"] == stats["dropped"]
    assert counts["moe.routed_entries"] == stats["routed"]


def test_bench_untraced_run_opens_no_sink_of_the_program(monkeypatch):
    from repro_torch.tools import opcount

    def refused(self):
        raise AssertionError("a sink of the program was opened")

    monkeypatch.setattr(opcount.SpanRecorder, "recording", refused)
    monkeypatch.setattr(opcount.CallCounter, "recording", refused)
    result, _ = run_cell(PREFILL, SEED, 1.0, False, device="cpu", adjust=tiny.shrink,
                         spec=tiny.with_unlisted(common.load_spec()))
    assert result["correct"], result["checks"]


def test_bench_window_with_the_program_sinks_open_on_cpu():
    from repro_torch.tools import opcount

    line = program_trace.run(PREFILL, SEED, 1.0, False, device="cpu", adjust=tiny.shrink)
    assert line["correct"] and line["program_spans"] > 0
    assert line["end_to_end"]["prefill_tokens_per_s"] > 0
    assert 0 <= line["reference_dropped_pct"] < 100
    assert not opcount.spans._sinks and not opcount.counters._sinks


def test_bench_window_scope_opens_the_sinks_exactly_for_program_metrics():
    spec = tiny.with_unlisted(common.load_spec())
    kinds = {}
    for w in spec["workloads"]:
        cs = common.cell_spec(w["name"], spec)
        program = any(getattr(common.metric_module(m["name"]), "PROGRAM", False)
                      for m in cs["per_layer"])
        rec = common.Recorder()
        traced = window_scope(cs, "cpu", rec, True)
        assert type(traced) is (program_trace.ProgramTracedWindow if program
                                else profiling.TracedWindow), w["name"]
        assert type(window_scope(cs, "cpu", rec, False)) is profiling.Window
        kinds[w["name"]] = program
    assert kinds[PREFILL] and not kinds[program_trace.KMEANS] and not kinds[tiny.DECODE]


def _cpu_traced(base):
    """A traced window for the CPU: `base`'s window (the sinks open or not)
    with an empty trace."""
    class Traced(base):
        made: list = []

        def __init__(self, device, rec):
            super().__init__(device)
            self.rec, self.events, self.launched = rec, [], []
            self.busy_s, self.intervals = 0.0, []
            Traced.made.append(self)

        window_s = property(lambda self: self.t1 - self.t0)
        kernel_s = profiling.TracedWindow.kernel_s
        count = profiling.TracedWindow.count
        breakdown = profiling.TracedWindow.breakdown
        idle_gaps = profiling.TracedWindow.idle_gaps

    return Traced


def test_bench_traced_run_opens_the_sinks_only_for_a_program_metric(monkeypatch):
    """`run_cell(..., trace=True)` on the CPU, the profiler left out: the
    prefill cell's window has the port's sinks open, and its dropped share
    comes from the port's counters; the k-means cell's has them closed."""
    from repro_torch.tools import opcount

    program = _cpu_traced(program_trace.ProgramWindow)
    plain = _cpu_traced(profiling.Window)
    monkeypatch.setattr(program_trace, "ProgramTracedWindow", program)
    monkeypatch.setattr(profiling, "TracedWindow", plain)
    spec = tiny.with_unlisted(common.load_spec())
    result, _ = run_cell(PREFILL, SEED, 1.0, True, device="cpu", adjust=tiny.shrink, spec=spec)
    assert result["correct"], result["checks"]
    assert len(program.made) == 1 and not plain.made
    assert program.made[0].sinks.counts["moe.routed_entries"] > 0
    assert 0 <= result["metrics"]["moe_dropped_pct.prefill"]["value"] < 100
    assert not opcount.spans._sinks and not opcount.counters._sinks

    def refused(self):
        raise AssertionError("a sink of the program was opened")

    monkeypatch.setattr(opcount.SpanRecorder, "recording", refused)
    monkeypatch.setattr(opcount.CallCounter, "recording", refused)
    result, _ = run_cell(program_trace.KMEANS, SEED, 1.0, True, device="cpu",
                         adjust=tiny.shrink, spec=spec)
    assert result["correct"], result["checks"]
    assert len(plain.made) == 1 and len(program.made) == 1


class _Event:
    """A kineto event as `ProgramTracedWindow` reads it (times in us)."""

    def __init__(self, name, start_us, dur_us, cid, on_device):
        self._name, self._start, self._dur, self._cid = name, start_us, dur_us, cid
        self._type = torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start * 1e3

    def duration_ns(self):
        return self._dur * 1e3

    def correlation_id(self):
        return self._cid


@pytest.mark.parametrize("marker_call_traced", [True, False])
def test_bench_launch_times_with_and_without_the_markers_call(marker_call_traced):
    """Launch times on the host clock: tied by the marker's runtime call
    where the trace has it, else by the marker kernel's device start."""
    h = 100.0  # host clock (s) at the marker's launch
    base = 5e6  # the trace's clock (us) at that moment
    evs = [_Event(profiling.MARKER, base + 10.0, 1000.0, 1, True),  # 10 us after its call
           _Event("gemm", base + 2e5, 50.0, 2, True),
           _Event("cudaLaunchKernel", base + 1e5, 5.0, 2, False)]
    if marker_call_traced:
        evs.append(_Event("cudaLaunchKernel", base, 5.0, 1, False))
    w = program_trace.ProgramTracedWindow.__new__(program_trace.ProgramTracedWindow)
    w._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    w._h_marker, w.t0, w.t1 = h, h + 0.01, h + 1.0
    w.launched, w.marker_latency_us = [], None
    w.rec = common.Recorder()
    w._collect()
    w._launches()
    (name, start, end, launch), = w.launched
    assert name == "gemm" and math.isclose(start, h - 10e-6 + 0.2)
    lag = 10e-6 if marker_call_traced else 0.0  # the marker's launch latency
    assert math.isclose(launch, h + 0.1 - 10e-6 + lag)
    assert w.marker_latency_us == (10.0 if marker_call_traced else None)
