"""The port's own instruments (repro_torch.tools.opcount): the span recorder
and the counters' sinks, closed and open, and the spans and counts that the
service, the driver and the engine record on the CPU.

A closed recorder returns one shared no-op context and touches nothing;
sinks nest and leave in any order; a span's `parent`, `thread` and `job`
come from its thread's open spans; a counter adds host numbers and tensors,
the tensors read once when the sink closes; an isolated sink takes its
thread's counts alone. No JAX here.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch import VirtualMesh
from repro_torch.tools import opcount


def test_closed_recorder_is_one_shared_no_op():
    rec = opcount.SpanRecorder()
    probe = torch.ones(3)

    def body():
        for _ in range(3):
            with rec.span("a", job=probe) as got:
                assert got is None
            with rec.tagged(layer=probe):
                pass

    assert rec.span("a") is rec.span("b", job=1) is rec.tagged(layer=0)
    assert opcount.count_ops(body) == {}  # no tensor touched, none allocated
    assert not hasattr(rec._sinks._local, "stack")  # no attributes built, nothing on a stack


def test_span_sinks_nest_and_exit_in_any_order():
    rec = opcount.SpanRecorder()
    with rec.span("x.before"):
        pass  # nothing open: recorded nowhere
    outer_cm, inner_cm = rec.recording(), rec.recording()
    outer = outer_cm.__enter__()
    with rec.span("x.one"):
        pass
    inner = inner_cm.__enter__()
    with rec.span("x.two"):
        pass
    outer_cm.__exit__(None, None, None)  # out of stack order
    with rec.span("x.three"):
        pass
    inner_cm.__exit__(None, None, None)
    with rec.span("x.after"):
        pass
    assert [s[0] for s in outer] == ["x.one", "x.two"]
    assert [s[0] for s in inner] == ["x.two", "x.three"]
    assert all(s[1] <= s[2] for s in outer + inner)


def test_span_attrs_parent_thread_job_and_tags():
    rec = opcount.SpanRecorder()

    def work():
        with rec.span("svc.pass"):
            with rec.span("svc.chunk", job=7):
                with rec.tagged(layer=2):
                    with rec.span("drv.load", extra="x"):
                        pass
                with rec.span("drv.gather"):
                    pass

    with rec.recording() as got:
        t = threading.Thread(target=work, name="worker")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with rec.span("main.alone"):
            pass
    by = {s[0]: s for s in got}
    assert by["svc.pass"][3] == {"job": None, "parent": None, "thread": "worker"}
    assert by["svc.chunk"][3] == {"job": 7, "parent": "svc.pass", "thread": "worker"}
    assert by["drv.load"][3] == {"job": 7, "layer": 2, "extra": "x", "parent": "svc.chunk",
                                 "thread": "worker"}
    assert by["drv.gather"][3] == {"job": 7, "parent": "svc.chunk", "thread": "worker"}
    assert by["main.alone"][3]["thread"] == threading.current_thread().name
    assert by["main.alone"][3]["parent"] is None
    outer, inner = by["svc.pass"], by["drv.load"]
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]


@pytest.mark.parametrize("value,want", [(3, 6), (torch.tensor(3), 6),
                                        (torch.tensor(1.5, dtype=torch.float64), 3.0)],
                         ids=["host", "tensor-int", "tensor-float"])
def test_call_counter_add_sums_and_reads_once(value, want):
    counter = opcount.CallCounter()
    counter.add("n", value)  # nothing open: counted nowhere
    with counter.recording() as sink:
        counter.add("n", value)
        counter.add("n", value)
        counter.note("calls")
    assert sink == {"n": want, "calls": 1}
    assert not isinstance(sink["n"], torch.Tensor)


def test_call_counter_isolated_takes_its_threads_counts_only():
    counter = opcount.CallCounter()
    ready, done = threading.Event(), threading.Event()

    def other():
        ready.wait(timeout=30)
        counter.note("other")
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with counter.recording() as open_sink:
        with counter.isolated() as mine:
            counter.note("mine")
            ready.set()
            assert done.wait(timeout=30)
            counter.add("mine", 2)
        counter.note("after")
    t.join(timeout=30)
    assert not t.is_alive()
    assert mine == {"mine": 3}
    assert open_sink == {"other": 1, "after": 1}


def test_served_jobs_spans_carry_job_thread_and_parent():
    """Spans of a service's scheduler thread: a pass holds each job's
    prepare and chunks, `driver.collect` sits in the job's last
    `service.chunk`, and every span of a job carries its `job_id`."""
    from repro_torch.serve import SecureJobService

    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(-2, 0.2, (40, 2)),
                          rng.normal(2, 0.2, (40, 2))]).astype(np.float32)
    with opcount.spans.recording() as got:
        with SecureJobService(VirtualMesh(2, "cpu")) as svc:
            hs = [svc.submit_kmeans(pts, 2, max_rounds=6) for _ in range(2)]
            for h in hs:
                h.result(timeout=120)
    svc_spans = [s for s in got if s[3]["thread"] == "secure-job-service"]
    assert {s[0] for s in svc_spans} >= {"service.pass", "service.prepare", "service.chunk",
                                         "service.finish", "driver.collect",
                                         "shuffle.exchange"}
    for h in hs:
        mine = [s for s in svc_spans if s[3]["job"] == h.job_id]
        names = [s[0] for s in mine]
        assert names.count("service.prepare") == 1 and names.count("service.finish") == 1
        # a chunk span for each chunk, and one for the resumption that
        # returns the job's result (`driver.collect`)
        assert names.count("service.chunk") == h.chunks + 1
        assert names.count("driver.collect") == 1
        parents = {s[0]: s[3]["parent"] for s in mine}
        assert parents["service.prepare"] == parents["service.chunk"] == "service.pass"
        assert parents["driver.collect"] == "service.chunk"
    passes = [s for s in svc_spans if s[0] == "service.pass"]
    assert all(s[3]["job"] is None and s[3]["parent"] is None for s in passes)


def _tiny_moe(seed=3):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.lm import LM

    cfg = ArchConfig(name="tiny-moe", family="moe", n_layers=2, d_model=32, n_heads=4,
                     n_kv_heads=2, d_ff=16, moe_d_ff=16, vocab_size=64, n_experts=8,
                     n_experts_per_tok=2, dtype="float32", moe_dispatch="shuffle")
    torch.manual_seed(seed)
    return cfg, LM(cfg, n_model=4, device="cpu")


def test_prefill_spans_by_layer_and_moe_counts():
    """A MoE prefill on the mesh: one `engine.prefill`, and in each layer an
    `engine.attention`, a `moe.route`, two `shuffle.exchange` legs and a
    `moe.experts`, tagged with the layer; the counters take every layer's
    routed entries (B·T·k) and dropped ones; with the sinks closed the
    prefill dispatches one device operation a layer fewer (the drop
    counter's addition)."""
    from repro_torch.serve.engine import init_cache, prefill

    cfg, model = _tiny_moe()
    mesh = VirtualMesh(4, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))

    def run():
        return prefill(cfg, model, toks, init_cache(cfg, 2, 16, "cpu"), mesh=mesh)

    closed = opcount.total_ops(opcount.count_ops(run))
    with opcount.spans.recording() as got, opcount.counters.recording() as counts:
        opened = opcount.total_ops(opcount.count_ops(run))
    assert opened - closed == cfg.n_layers
    names = [s[0] for s in got]
    assert names.count("engine.prefill") == 1
    for name, per_layer in (("engine.attention", 1), ("moe.route", 1), ("moe.experts", 1),
                            ("shuffle.exchange", 2)):
        layers = [s[3]["layer"] for s in got if s[0] == name]
        assert sorted(layers) == sorted(list(range(cfg.n_layers)) * per_layer), name
        assert all(s[3]["parent"] == "engine.prefill" for s in got if s[0] == name)
    assert counts["moe.routed_entries"] == cfg.n_layers * 2 * 16 * cfg.n_experts_per_tok
    assert 0 <= counts["moe.dropped_entries"] < counts["moe.routed_entries"]
