"""Guards of the benchmark's shape: what it imports, what it reads, that
every name in BENCHMARK.json resolves to its files, that each traffic
generator and metric reads synthetic input on the CPU, and that the
measured path refuses to run without a card."""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from bench import common, profiling, tiny
from bench.drivers import jobs, lm
from bench.reference import granite_moe

SOURCES = sorted(p for p in common.BENCH.rglob("*.py") if not p.name.startswith("test_"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(common.BENCH)))
def test_bench_imports_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(common.FORBIDDEN_MODULES), (path, tops)
    if path.parent.name == "reference":
        assert tops <= {"__future__", "math", "torch"}, (path, tops)


def test_bench_reads_nothing_of_the_jax_benchmarks():
    for path in SOURCES:
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path


def test_bench_forbidden_loaded_compares_whole_top_level_names():
    assert common.forbidden_loaded(["repro_torch.serve", "repro_torchlike", "jaxtyping"]) == []
    assert common.forbidden_loaded(["repro.core", "jax.numpy", "flax"]) == ["flax", "jax",
                                                                           "repro"]


def test_bench_every_entry_resolves_by_name():
    spec = common.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    configs = {c["name"] for c in spec["configs"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = [w["name"] for w in spec["workloads"]]
    for c in spec["configs"]:
        assert (common.ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert 0 < next(m for m in spec["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
        cs = common.cell_spec(w["name"], spec)
        assert (common.BENCH / "drivers" / f"{cs['traffic']['kind']}.py").is_file()
        assert {"setup_s"} < {m["name"] for m in cs["end_to_end"]}
        assert cs["per_layer"], w["name"]
        assert set(cs["limits"]["numbers"])
    full = tiny.with_unlisted(spec)  # the unlisted cells' files resolve as well
    for w in tiny.UNLISTED["workloads"]:
        assert w["name"] not in cells and w["config"] in configs
        common.cell_spec(w["name"], full)
    e2e = {m["name"]: m for m in full["end_to_end"]}
    cells = [w["name"] for w in full["workloads"]]
    for m in full["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and ("workloads" not in e2e[m["moves"]]
                                   or w in e2e[m["moves"]]["workloads"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in spec["configs"] + spec["workloads"]:
        assert NAME.match(entry["name"]) and 1 <= len(entry["why"]) <= 200
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = (common.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


@pytest.mark.parametrize("workload", ["kmeans-d64-k256.large_jobs",
                                      "kmeans-d64-k256.small_jobs"])
def test_bench_dataset_sizes_pad_into_their_buckets(workload):
    """The job sizes are the source's, none a power of two: padding into
    the service's buckets does real work."""
    sizes = common.read_json("traffic", workload)["sizes"]
    assert all(n & (n - 1) for n in sizes)
    assert all(n < jobs.bucket(n, 8) < 2 * n for n in sizes)


def test_bench_overlapping_round_ranges_are_counted():
    class H:
        def __init__(self, base, rounds):
            self.round_base, self.max_rounds = base, rounds

    assert jobs.overlapping_ranges([H(0, 15), H(15, 64), H(79, 64)]) == 0
    assert jobs.overlapping_ranges([H(0, 64), H(15, 64), H(79, 64)]) == 1
    assert jobs.overlapping_ranges([H(0, 64), H(0, 64), H(0, 64)]) == 2


def test_bench_prompts_and_weights_follow_the_seed():
    m = json.loads((common.BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())["model"]
    m = dict(m, n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, moe_d_ff=8, vocab_size=300,
             n_experts=4, dtype="float32")
    a = lm.make_weights(granite_moe, m, 5, "cpu", 2)
    b = lm.make_weights(granite_moe, m, 5, "cpu", 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    p = lm.prompts(m, 2**33 + 1, "x", 3, 7, "cpu")
    assert p.shape == (3, 7) and int(p.max()) < 300 and torch.equal(
        p, lm.prompts(m, 2**33 + 1, "x", 3, 7, "cpu"))


class _Trace:
    """A traced window of synthetic events (name, start, end[, launch]),
    with the port's spans (name, start, end) of one thread and its counters
    as `program_trace.ProgramTracedWindow` holds them."""

    def __init__(self, events, t0=0.0, t1=1.0, spans=(), counts=None):
        self.rec = common.Recorder()
        self.rec.add_span("prefill", 0.0, 1.0)
        for name, a, b in spans:
            self.rec.add_span(name, a, b, job=None, parent=None, thread="main")
        self.t0, self.t1 = t0, t1
        self.launched = [(e[0], e[1], e[2], e[3] if len(e) > 3 else e[1]) for e in events]
        self.events = [e[:3] for e in self.launched]
        self.busy_s, self.intervals = profiling._union(self.events, t0, t1)
        self.sinks = SimpleNamespace(spans=[], counts=dict(counts or {}), kernel_calls={})

    window_s = property(lambda self: self.t1 - self.t0)
    kernel_s = profiling.TracedWindow.kernel_s
    count = profiling.TracedWindow.count
    idle_gaps = profiling.TracedWindow.idle_gaps
    breakdown = profiling.TracedWindow.breakdown


def _facts():
    m = json.loads((common.BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())["model"]
    contexts = [4097 + i for i in range(10)]
    return {"k": 256, "d": 64, "shards": 8, "queue_s": [0.001, 0.002, 0.004],
            "rounds": [(2_000_000, 5), (3_000_000, 6)], "runner_misses": 0,
            "prefills": 3, "batch": 8, "tokens": 4096, "model": m, "wire_bytes": [64.68e9],
            "span_s": 8.0, "prefill_flops": granite_moe.prefill_flops(m, 8, 4096),
            "attention_flops": granite_moe.prefill_attention_flops(m, 8, 4096),
            "legs": granite_moe.exchange_legs(m),
            "leg_bytes": granite_moe.leg_wire_bytes(m, 8, 4096, 8),
            "steps": 10, "contexts": contexts, "window_s": 1.0,
            "decode_flops": sum(granite_moe.decode_step_flops(m, 8, c) for c in contexts)}


DEFAULT_EVENTS = [("kmeans_assign_kernel", 0.1, 0.2), ("chacha20_xor_packed_lanes1", 0.25, 0.3),
                  ("elementwise", 0.5, 0.6)]
METRICS = sorted(p.stem for p in (common.BENCH / "metrics").glob("*.py"))


def _input(sample=None, events=DEFAULT_EVENTS):
    """The default synthetic input, with a metric's own `SAMPLE` merged in."""
    sample = sample or {}
    trace = _Trace(list(events) + list(sample.get("events", [])),
                   spans=sample.get("spans", ()), counts=sample.get("counts"))
    return common.Readings(trace=trace, rec=None, cs=None,
                           facts={**_facts(), **sample.get("facts", {})})


def test_bench_every_metric_reads_synthetic_input():
    for m in tiny.with_unlisted(common.load_spec())["per_layer"]:
        mod = common.metric_module(m["name"])
        value = mod.read(_input(getattr(mod, "SAMPLE", None)))
        assert value is not None and math.isfinite(value) and value >= 0, m["name"]
    trace = _input().trace
    assert abs(trace.busy_s - 0.25) < 1e-12 and trace.count() == 3
    gaps = trace.idle_gaps()
    assert gaps[0][0] == "host in prefill" and abs(gaps[0][1] - 0.4) < 1e-12


@pytest.mark.parametrize("name", [n for n in METRICS
                                  if hasattr(common.metric_module(n), "SAMPLE")])
def test_bench_metric_reads_its_own_sample(name):
    """A metric with a `SAMPLE` of its own finds nothing to read in the
    default input, and a finite value of at least 0 once its sample is in."""
    mod = common.metric_module(name)
    assert mod.read(_input()) is None
    value = mod.read(_input(mod.SAMPLE))
    assert value is not None and math.isfinite(value) and value >= 0


def test_bench_metric_without_its_kernel_reads_nothing():
    kernel_metrics = [n for n in METRICS if hasattr(common.metric_module(n), "KERNEL")]
    assert {"kmeans_assign_roofline_pct", "chacha_roofline_pct.kmeans",
            "chacha_roofline_pct.prefill", "attention_roofline_pct.prefill"} <= set(kernel_metrics)
    for name in kernel_metrics:
        mod = common.metric_module(name)
        names = common.kernel_names(mod.KERNEL)
        sample = dict(getattr(mod, "SAMPLE", {}))
        sample["events"] = [e for e in sample.get("events", [])
                            if not any(k in e[0] for k in names)]
        assert mod.read(_input(sample, events=[("elementwise", 0.5, 0.6)])) is None, name


def test_bench_yardstick_counts():
    from bench import yardstick

    m = json.loads((common.BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())["model"]
    assert granite_moe.leg_wire_bytes(m, 8, 4096, 8) == 1_010_565_120
    assert yardstick.kmeans_wire_words(256, 64, 8) == 2112
    assert 2.1e9 < granite_moe.prefill_flops(m, 8, 4096) / (8 * 4096) < 2.25e9  # ~2.16 a token


def test_bench_attention_roofline_counts_from_shapes():
    """4 B H Dh T (T + 1) / 2 causal operations a layer at granite's prefill
    (8 x 4,096, 24 heads of 64): 4.12e11; the metric holds every layer of
    every prefill to it at the bf16 peak, and reads None without the kernel."""
    from bench import yardstick

    m = json.loads((common.BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())["model"]
    per_layer = granite_moe.prefill_attention_flops(m, 8, 4096) / m["n_layers"]
    assert per_layer == 4 * 8 * 24 * 64 * 4096 * 4097 / 2
    assert 4.12e11 < per_layer < 4.13e11
    mod = common.metric_module("attention_roofline_pct.prefill")
    run = _input({"events": [("attention_prefill_kernel", 0.62, 0.68)]})
    want = 100.0 * 3 * m["n_layers"] * per_layer / (yardstick.PEAK_BF16 * 0.06)
    assert math.isclose(mod.read(run), want, rel_tol=1e-9)
    assert mod.read(_input()) is None


def test_bench_measured_path_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload",
                           "kmeans-d64-k256.large_jobs", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, env=env,
                          cwd=common.ROOT, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "CUDA card" in proc.stderr
