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

from bench import common, profiling, program_trace, tiny
from bench.drivers import lm
from bench.run import run_cell
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
    assert summary["trace_counts"] == {"chacha20": 2, "kmeans_assign": 2}
    top = summary["top_ops_by_span"]
    assert [name for name, _ in top["engine.attention"]] == ["softmax", "elementwise"]
    assert math.isclose(dict(top["driver.replay"])["kmeans_assign_kernel"], 0.045 + 0.035)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  tiny.with_unlisted(common.load_spec())["per_layer"]])
def test_bench_existing_reader_reads_the_same_with_program_spans(name):
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
