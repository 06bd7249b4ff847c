"""The port's calibrated cost model (repro_torch.perf) against the reference's
(repro.perf), and the `auto` knobs it answers.

The counterparts of `tests/test_costmodel.py`: the no-calibration contract
(every `auto` resolver bit for bit on its historical default), a synthetic
calibration driving the resolvers, the capacity factor only from `extra`,
per-vector timing models, persistence and `$REPRO_CALIBRATION` activation
with its mtime cache, a round's own wire in `trace_workload`, and the
port's kernel padding model (`effective_blocks`). Then parity with the JAX
package: one calibration dict gives both packages' `CostModel`s equal
predictions (exactly: the same float arithmetic on the same numbers) and
equal shared recommendations; a file holding a JAX entry and a port entry
gives each package its own; and the order explicit argument > environment
variable > model > default, with errors naming the variable, for each knob.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.perf import calibrate as jcal
from repro.perf import model as jmodel
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import driver as tdrv
from repro_torch.core import shuffle as tsh
from repro_torch.crypto import chacha
from repro_torch.perf import calibrate as tcal
from repro_torch.perf.calibrate import CALIBRATION_ENV, Calibration, effective_blocks
from repro_torch.perf.model import (
    CostModel,
    RoundTrace,
    active_model,
    clear_active_model,
    recommendation,
    set_active_model,
    trace_workload,
)
from repro_torch.serve import service as tsvc

KNOB_ENVS = (tsh.COALESCE_ENV, tdrv.CHUNK_GROWTH_ENV, tdrv.STATE_SPECS_ENV,
             tsvc.BUCKET_GROWTH_ENV, tsvc.MAX_RUNNERS_ENV)


@pytest.fixture
def no_cal(monkeypatch):
    """No calibration and no knob variable: the port's model is cleared and
    $REPRO_CALIBRATION unset for the test, and cleared again after it."""
    monkeypatch.delenv(CALIBRATION_ENV, raising=False)
    for var in KNOB_ENVS:
        monkeypatch.delenv(var, raising=False)
    clear_active_model()
    yield
    clear_active_model()


def _entry(blk, resolved, launch_us=5.0):
    return {"us_per_block": blk, "launch_us": launch_us, "compile_s": 8.0,
            "compile_eqns": 400, "resolved": resolved}


def _cal_dict(*, backend="torch-cpu", chacha=None, extra=None) -> dict:
    """A hand-built calibration with known constants (no probing)."""
    return {"backend": backend, "n_devices": 1,
            "chacha": chacha or {"auto": _entry(0.002, ["torch", False])},
            "all_to_all": {"us_per_byte": 0.001, "base_us": 50.0},
            "dispatch": {"base_us": 100.0},
            "round": {"us_per_item": 0.01, "base_us": 200.0, "compile_s": 2.0,
                      "compile_eqns": 150},
            "compile": {"s_per_eqn": 0.004, "base_s": 0.05},
            "schema": 1, "extra": extra or {}}


def _cal(**kw) -> Calibration:
    return Calibration.from_dict(_cal_dict(**kw))


def _sort_capacity_of(mesh, n: int) -> int:
    """The capacity a CPU service picks for a sort job of n values."""
    cache = tsvc.RunnerCache()
    with tsvc.SecureJobService(mesh, cache=cache, min_chunk=1, max_chunk=1) as svc:
        svc.submit_sort(np.random.default_rng(0).random(n, dtype=np.float32),
                        max_rounds=1).result(timeout=120)
    (key,) = {k[0] for k in cache.keys()}
    return key[2]


# --- the no-calibration contract ---------------------------------------------


def test_resolvers_keep_historical_defaults_without_calibration(no_cal):
    assert active_model() is None
    assert recommendation("chacha_impl") is None
    assert tsh.resolve_coalesce("auto") is True and tsh.resolve_coalesce(None) is True
    assert tdrv.resolve_chunk_growth("auto") == 2
    assert tdrv.resolve_chunk_growth(None, min_chunk=1, max_rounds=200, max_chunk=8) == 2
    assert tdrv.resolve_capacity_factor() == 2.0
    assert tdrv.resolve_state_mode("auto") == "sharded"
    assert tsvc.resolve_bucket_growth() == 2.0
    assert tsvc.resolve_max_resident("auto") is None
    mesh = VirtualMesh(2, "cpu")
    assert _sort_capacity_of(mesh, 40) == tsvc.bucket_for(40, multiple=2) // 2


# --- synthetic model drives the resolvers ------------------------------------


def test_model_recommendations_drive_auto_resolvers(no_cal, monkeypatch):
    model = CostModel(_cal())
    set_active_model(model)
    try:
        # non-negative probed costs: the coalesced wire always wins
        assert model.recommend("coalesce") is True and tsh.resolve_coalesce("auto") is True
        growth = model.recommend("chunk_growth", min_chunk=1, max_rounds=64, max_chunk=None)
        assert growth in (2, 3, 4) and tdrv.resolve_chunk_growth("auto") == growth
        assert tsvc.resolve_bucket_growth() == model.recommend("bucket_growth") in (1.5, 2.0, 4.0)
        assert model.recommend("max_resident") == "unbounded"
        assert tsvc.resolve_max_resident("auto") is None
        assert model.recommend("chacha_impl") == "auto"
        # the environment and an explicit value both outrank the model
        monkeypatch.setenv(tdrv.CHUNK_GROWTH_ENV, "7")
        assert tdrv.resolve_chunk_growth("auto") == 7
        assert tdrv.resolve_chunk_growth(5) == 5
    finally:
        clear_active_model()


def test_capacity_factor_only_from_measured_extra(no_cal):
    """No probe may shrink the overflow headroom: a non-default capacity
    factor only from a deployment-measured entry of the calibration."""
    set_active_model(CostModel(_cal()))
    assert tdrv.resolve_capacity_factor() == 2.0
    set_active_model(CostModel(_cal(extra={"capacity_factor": 3.5})))
    assert tdrv.resolve_capacity_factor() == 3.5
    # a runner takes the factor when it is built: ceil(n / R) * 3.5 per destination
    mesh = VirtualMesh(2, "cpu")
    spec = tdrv.IterativeSpec(
        map_fn=lambda st, inp, r: (inp["k"], {"v": inp["k"].float()}),
        reduce_fn=lambda st, k, v, valid, r: (st, {"n": mesh.psum(valid.sum(1).float())}))
    runner = tdrv.make_iterative_runner(spec, mesh)
    runner({"k": torch.arange(8, dtype=torch.int32)}, {}, 0)
    assert runner.trace_info == {"capacity": 7, "capacity_auto": True}


def test_timing_model_prices_knob_vectors():
    """The per-vector TimingModel hooks hillclimb cell K relies on."""
    model = CostModel(_cal(chacha={"auto": _entry(0.001, ["torch", False]),
                                   "torch": _entry(0.002, ["torch", False])}))
    base = model.timing_model()
    assert base.xla_compile_s == pytest.approx(8.0 + 2.0)
    assert model.timing_model(coalesce=False).net_latency_s == \
        pytest.approx(2 * base.net_latency_s)
    assert model.timing_model(impl="auto").crypto_bw_bytes_s > \
        model.timing_model(impl="torch").crypto_bw_bytes_s
    assert model.recommend_chacha_impl() == "auto"
    # on the card only 'auto' is a selector: a probed 'torch' entry is never the answer
    card = CostModel(_cal(backend="torch-cuda",
                          chacha={"torch": _entry(0.0001, ["torch", False]),
                                  "auto": _entry(0.5, ["cuda", False])}))
    assert card.recommend_chacha_impl() == "auto"


# --- persistence + activation ------------------------------------------------


def test_save_load_roundtrip_keyed_by_backend(tmp_path):
    path = str(tmp_path / "calib.json")
    cal = _cal()
    tcal.save_calibration(cal, path)
    assert tcal.load_calibration(path, backend="torch-cpu", n_devices=1) == cal
    assert tcal.load_calibration(path) == cal  # this process's key, no card here
    # a calibration probed on another key never applies
    assert tcal.load_calibration(path, backend="torch-cuda", n_devices=1) is None
    assert tcal.load_calibration(path, backend="torch-cpu", n_devices=8) is None
    # a second entry merges instead of clobbering
    other = dataclasses.replace(cal, backend="torch-cuda", n_shards=8)
    tcal.save_calibration(other, path)
    assert tcal.load_calibration(path, backend="torch-cpu", n_devices=1) == cal
    assert tcal.load_calibration(path, backend="torch-cuda", n_devices=1) == other


def test_active_model_from_env_and_mtime_cache(no_cal, tmp_path, monkeypatch):
    path = tmp_path / "calib.json"
    tcal.save_calibration(_cal(), str(path))
    monkeypatch.setenv(CALIBRATION_ENV, str(path))
    model = active_model()
    assert isinstance(model, CostModel) and model.cal == _cal()
    assert active_model() is model  # cached while the file's mtime holds
    assert recommendation("max_resident") == "unbounded"
    # a rewritten file (a new mtime) is read again
    tcal.save_calibration(_cal(extra={"capacity_factor": 3.0}), str(path))
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert active_model() is not model and tdrv.resolve_capacity_factor() == 3.0
    # explicit None forces the model off even with the variable set
    set_active_model(None)
    assert active_model() is None
    clear_active_model()
    # unreadable or corrupt files give no model, never an error
    monkeypatch.setenv(CALIBRATION_ENV, str(tmp_path / "missing.json"))
    assert active_model() is None
    bad = tmp_path / "bad.json"
    bad.write_text("not json")
    monkeypatch.setenv(CALIBRATION_ENV, str(bad))
    assert active_model() is None and tdrv.resolve_chunk_growth("auto") == 2


# --- trace-driven predictions ------------------------------------------------


def _runner(secure):
    mesh = VirtualMesh(1, "cpu")

    def map_fn(state, inputs, r):
        x = inputs["x"]
        keys = (torch.arange(x.shape[1], dtype=torch.int32) % 4).expand(x.shape[0], -1)
        return keys, {"x": x}

    def reduce_fn(state, keys, values, valid, r):
        s = mesh.psum(torch.where(valid, values["x"], 0.0).sum(dim=1))
        return {"s": state["s"] + s}, {"s": s}

    spec = tdrv.IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, n_rounds=2)
    return tdrv.make_iterative_runner(spec, mesh, secure)


def test_trace_workload_reads_the_rounds_own_wire(no_cal):
    sec = secure_config(chacha.key_to_words(bytes(range(32))),
                        chacha.nonce_to_words(b"\x05" * 12))
    inputs = {"x": torch.ones(16)}
    state = {"s": torch.zeros(())}
    runner = _runner(sec)
    trace = trace_workload(runner, inputs, state, n_shards=1, n_local_items=16)
    assert trace.secure and trace.coalesced
    assert trace.wire_bytes > 0 and trace.collectives == 1
    # coalesced single wire: one encrypt + one decrypt launch per round
    assert trace.keystream_launches == 2
    assert trace.keystream_blocks > 0 and trace.blocks_per_launch_row >= 1
    assert trace.n_eqns > 0
    # the caller's state is untouched, and so is the runner
    assert float(state["s"]) == 0.0 and runner.trace_info == {}
    # the round's wire is the one a run of the job records
    with tsh.record_wire_bytes() as recs:
        runner(inputs, state, 0)
    assert [r["wire_bytes"] for r in recs] == [trace.wire_bytes] * 2

    model = CostModel(_cal())
    assert model.predict_wire_bytes(trace) == trace.wire_bytes
    pred = model.predict_round_us(trace)
    assert pred > 0
    # a costlier cipher probe must predict a costlier secure round
    assert CostModel(_cal(chacha={"auto": _entry(10.0, ["torch", False])})) \
        .predict_round_us(trace) > pred
    floor = model.cal.compile["base_s"] + trace.n_eqns * model.cal.compile["s_per_eqn"]
    assert model.predict_compile_s(trace) >= floor

    plain = trace_workload(_runner(None), inputs, state, n_shards=1, n_local_items=16)
    assert not plain.secure and plain.keystream_launches == 0
    assert model.predict_round_us(plain) < pred
    assert plain.n_eqns < trace.n_eqns


# --- kernel padding model ----------------------------------------------------


def test_effective_blocks_no_padding():
    """The port's kernel runs one item per (row, block) of its table on both
    cores: a launch pays rows x blocks_per_row, whatever the selector."""
    assert effective_blocks(4, 3) == 12
    assert effective_blocks(1, 1) == 1
    assert effective_blocks(8, 130, "auto", False) == 8 * 130
    assert effective_blocks(64, 132, "torch", True) == 64 * 132
    assert effective_blocks(0, 4) == 0 and effective_blocks(4, 0) == 0


def test_cpu_calibration_runs_and_captures_nothing(no_cal):
    """`run_calibration` on a CPU mesh (passed explicitly): finite constants
    >= 0, the capture figures 0 (the eager runner captures nothing), the
    round's device operations counted, the shard count recorded."""
    cal = tcal.run_calibration(VirtualMesh(2, "cpu"), quick=True)
    assert cal.key == "torch-cpu/1" and cal.n_shards == 2
    (entry,) = cal.chacha.values()
    for v in (entry["us_per_block"], entry["launch_us"], cal.all_to_all["us_per_byte"],
              cal.all_to_all["base_us"], cal.dispatch["base_us"], cal.round["us_per_item"],
              cal.round["base_us"]):
        assert np.isfinite(v) and v >= 0
    assert entry["compile_s"] == cal.round["compile_s"] == 0.0
    assert cal.compile == {"s_per_eqn": 0.0, "base_s": 0.0}
    assert entry["compile_eqns"] > cal.round["compile_eqns"] > 0
    assert Calibration.from_dict(json.loads(json.dumps(cal.to_dict()))) == cal
    if not torch.cuda.is_available():  # the default mesh is the card's
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcal.run_calibration(quick=True)


# --- parity with the JAX package ---------------------------------------------


def _shared_dict() -> dict:
    """The reference's 'jnp' entry beside the same numbers under the port's
    selector: each model picks its own and prices the same line."""
    e = _entry(0.0015, ["jnp", True], launch_us=3.0)
    d = _cal_dict(backend="cpu", chacha={"jnp": e, "auto": dict(e, resolved=["torch", False])},
                  extra={"capacity_factor": 2.5})
    return d


TRACES = [
    RoundTrace(n_eqns=300, wire_bytes=1 << 16, collectives=1, keystream_launches=2,
               keystream_blocks=2 * 8 * 132, n_shards=8, n_local_items=524288, secure=True,
               coalesced=True),
    RoundTrace(n_eqns=900, wire_bytes=3 << 20, collectives=3, keystream_launches=6,
               keystream_blocks=6 * 8 * 1000 + 5, n_shards=8, n_local_items=4096,
               secure=True, coalesced=False),
    RoundTrace(n_eqns=120, wire_bytes=4096, collectives=1, keystream_launches=0,
               keystream_blocks=0, n_shards=1, n_local_items=16, secure=False, coalesced=True),
    RoundTrace(n_eqns=50, wire_bytes=0, collectives=2, keystream_launches=2,
               keystream_blocks=1, n_shards=4, n_local_items=0, secure=True, coalesced=True),
]


@pytest.mark.parametrize("trace", TRACES, ids=["kmeans-wire", "per-leaf", "plain", "tiny"])
def test_cost_model_matches_reference(trace):
    d = _shared_dict()
    ref = jmodel.CostModel(jcal.Calibration.from_dict(d))
    port = CostModel(Calibration.from_dict(d))
    jtrace = jmodel.RoundTrace(**dataclasses.asdict(trace))
    assert port.predict_round_us(trace) == ref.predict_round_us(jtrace)
    assert port.predict_compile_s(trace) == ref.predict_compile_s(jtrace)
    assert port.predict_wire_bytes(trace) == ref.predict_wire_bytes(jtrace)
    for coalesce in (True, False):
        assert dataclasses.asdict(port.timing_model(coalesce=coalesce)) == dataclasses.asdict(
            ref.timing_model(loop_impl="while", coalesce=coalesce))
    assert dataclasses.asdict(port.timing_model(impl="auto")) == dataclasses.asdict(
        ref.timing_model(impl="jnp"))
    for knob, ctx in [("coalesce", {}), ("bucket_growth", {}), ("max_resident", {}),
                      ("capacity_factor", {}), ("chunk_growth", {}),
                      ("chunk_growth", {"min_chunk": 2, "max_rounds": 200, "max_chunk": 8}),
                      ("sort_capacity", {"bucket": 4096, "n_shards": 8})]:
        assert port.recommend(knob, **ctx) == ref.recommend(knob, **ctx), knob


def test_each_package_loads_only_its_own_entry(tmp_path, monkeypatch, no_cal):
    """One file with a JAX "cpu/1" entry and a port "torch-cpu/1" entry: each
    package's loader and active model take its own, never the other's."""
    path = str(tmp_path / "both.json")
    jentry = jcal.Calibration.from_dict(_shared_dict())
    pentry = _cal(extra={"capacity_factor": 4.0})
    jcal.save_calibration(jentry, path)
    tcal.save_calibration(pentry, path)
    assert set(json.load(open(path))["calibrations"]) == {"cpu/1", "torch-cpu/1"}
    assert jcal.load_calibration(path) == jentry
    assert tcal.load_calibration(path) == pentry
    monkeypatch.setenv(CALIBRATION_ENV, path)
    jmodel.clear_active_model()
    try:
        assert jmodel.active_model().cal.backend == "cpu"
        assert active_model().cal.backend == "torch-cpu"
        assert tdrv.resolve_capacity_factor() == 4.0
        # each package alone in a file: the other finds no model
        only_j, only_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
        jcal.save_calibration(jentry, only_j)
        tcal.save_calibration(pentry, only_t)
        monkeypatch.setenv(CALIBRATION_ENV, only_j)
        assert active_model() is None and tdrv.resolve_capacity_factor() == 2.0
        monkeypatch.setenv(CALIBRATION_ENV, only_t)
        assert jmodel.active_model() is None
    finally:
        jmodel.clear_active_model()


class _Stub:
    """A model stub answering fixed recommendations."""

    def __init__(self, answers):
        self.answers = answers

    def recommend(self, knob, **ctx):
        return self.answers.get(knob)


# (variable, resolve(value), explicit value and its answer, environment value
# and its answer, the model's answer as a resolver gives it (None: the knob
# reads no model), default, an invalid environment value)
KNOBS = [
    (tsh.COALESCE_ENV, tsh.resolve_coalesce, (True, True), ("1", True),
     ("coalesce", False, False), True, "maybe"),
    (tdrv.CHUNK_GROWTH_ENV, tdrv.resolve_chunk_growth, (3, 3), ("4", 4),
     ("chunk_growth", 3, 3), 2, "0"),
    (tdrv.STATE_SPECS_ENV, tdrv.resolve_state_mode, ("sharded", "sharded"),
     ("replicated", "replicated"), None, "sharded", "sideways"),
    (tsvc.BUCKET_GROWTH_ENV, tsvc.resolve_bucket_growth, (1.5, 1.5), ("4", 4.0),
     ("bucket_growth", 1.5, 1.5), 2.0, "1.0"),
    (tsvc.MAX_RUNNERS_ENV, tsvc.resolve_max_resident, (3, 3), ("5", 5),
     ("max_resident", 8, 8), None, "-2"),
]


@pytest.mark.parametrize("var,resolve,explicit,env,model,default,invalid", KNOBS,
                         ids=[k[0] for k in KNOBS])
def test_knob_order_explicit_env_model_default(no_cal, monkeypatch, var, resolve, explicit,
                                               env, model, default, invalid):
    """explicit > $VAR > model > default, as the reference resolves; an
    invalid environment value raises an error that names the variable."""
    assert resolve("auto") == default
    if model is not None:
        knob, answer, resolved = model
        set_active_model(_Stub({knob: answer}))
        assert resolve("auto") == resolved != default
    monkeypatch.setenv(var, env[0])
    assert resolve("auto") == env[1]
    assert resolve(explicit[0]) == explicit[1]
    monkeypatch.setenv(var, invalid)
    with pytest.raises(ValueError, match=r"\$" + var):
        resolve("auto")
    assert resolve(explicit[0]) == explicit[1]  # an explicit value never reads it


def test_capacity_and_sort_capacity_follow_the_model(no_cal):
    """The two knobs with no variable: the model beats the default, and an
    explicit sort capacity beats the model."""
    mesh = VirtualMesh(2, "cpu")
    set_active_model(_Stub({"capacity_factor": 3.0, "sort_capacity": 5}))
    assert tdrv.resolve_capacity_factor() == 3.0
    assert _sort_capacity_of(mesh, 40) == 5
    cache = tsvc.RunnerCache()
    with tsvc.SecureJobService(mesh, cache=cache) as svc:
        svc.submit_sort(np.arange(40, dtype=np.float32), capacity=9,
                        max_rounds=1).result(timeout=120)
    assert {k[0][2] for k in cache.keys()} == {9}


def test_knobs_resolve_once_per_runner_never_per_round(no_cal, monkeypatch):
    """A built runner, and a job's later chunks, resolve no knob: with every
    variable invalid and a model that raises, they still run."""
    class Raising:
        def recommend(self, knob, **ctx):
            raise AssertionError(f"knob {knob!r} resolved during a round")

    sec = secure_config(chacha.key_to_words(bytes(range(32))),
                        chacha.nonce_to_words(b"\x05" * 12))
    inputs, state = {"x": torch.ones(16)}, {"s": torch.zeros(())}
    runners = [_runner(sec), _runner(None)]
    gen = tdrv.run_until_chunks(_runner(sec).spec, inputs, state, VirtualMesh(1, "cpu"),
                                secure=sec, max_rounds=4)
    next(gen)  # the job's knobs are resolved as it starts
    set_active_model(Raising())
    for var in KNOB_ENVS:
        monkeypatch.setenv(var, "sideways")
    for runner in runners:
        runner(inputs, state, 0)
    with pytest.raises(StopIteration) as stop:
        while True:
            next(gen)
    assert stop.value.value.rounds_executed == 4


# --- the per-workload item term ----------------------------------------------


def _sized_runner(n_local: int):
    """The file's plaintext probe workload, built for `n_local` items a shard."""
    return _runner(None)


def _sized_inputs(n_local: int):
    return {"x": torch.ones(n_local)}, {"s": torch.zeros(())}


def test_probe_workload_items_refuses_sizes_past_an_eighth():
    """Every probed size must be at most 1/8 of the size it predicts (so a
    prediction extrapolates), and a line needs two distinct sizes."""
    with pytest.raises(ValueError, match="1/8"):
        tcal.probe_workload_items(_sized_runner, _sized_inputs, [16, 129], target_items=1024)
    with pytest.raises(ValueError, match="1/8"):
        tcal.probe_workload_items(_sized_runner, _sized_inputs, [0, 16], target_items=1024)
    with pytest.raises(ValueError, match="two or more"):
        tcal.probe_workload_items(_sized_runner, _sized_inputs, [16, 16], target_items=1024)
    # exactly 1/8 is allowed
    got = tcal.probe_workload_items(_sized_runner, _sized_inputs, [16, 128],
                                    target_items=1024, reps=2)
    assert got["sizes"] == [16, 128] and got["target_items"] == 1024


def test_probe_workload_items_fits_the_workloads_own_round(no_cal):
    """A CPU probe of a plaintext workload: one round per size, each call's
    executed rounds counted (2 per call of the file's 2-round runner), a
    finite line >= 0, and the probe's own seconds."""
    got = tcal.probe_workload_items(_sized_runner, _sized_inputs, [8, 32, 64],
                                    target_items=512, reps=3)
    assert got["rounds_per_call"] == [2, 2, 2]
    assert len(got["round_us"]) == 3 and all(us > 0 for us in got["round_us"])
    for k in ("us_per_item", "base_us", "probe_s"):
        assert np.isfinite(got[k]) and got[k] >= 0
    assert got["probe_s"] > 0


@pytest.mark.parametrize("trace", TRACES, ids=["kmeans-wire", "per-leaf", "plain", "tiny"])
def test_trace_with_item_us_is_priced_by_it(trace):
    """Without an item term the port's prediction is the reference's bit for
    bit; with one, only the item term moves, by n_local x (item_us - the
    generic slope), and the reference's fields are untouched."""
    d = _shared_dict()
    port = CostModel(Calibration.from_dict(d))
    ref = jmodel.CostModel(jcal.Calibration.from_dict(d))
    assert trace.item_us is None
    assert port.predict_round_us(trace.with_item_us(None)) == ref.predict_round_us(
        jmodel.RoundTrace(**dataclasses.asdict(trace)))
    priced = trace.with_item_us(0.25)
    assert priced.item_us == 0.25 and trace.item_us is None
    assert dataclasses.asdict(priced) == dataclasses.asdict(trace)
    want = port.predict_round_us(trace) + trace.n_local_items * (0.25 - d["round"]["us_per_item"])
    assert port.predict_round_us(priced) == pytest.approx(want, rel=1e-12, abs=1e-9)
    # everything else the model answers ignores the term
    assert port.predict_compile_s(priced) == port.predict_compile_s(trace)
    assert port.predict_wire_bytes(priced) == port.predict_wire_bytes(trace)


def test_trace_workload_takes_its_term_from_a_probe_result(no_cal):
    """trace_workload fills item_us only when given a probe result."""
    sec = secure_config(chacha.key_to_words(bytes(range(32))),
                        chacha.nonce_to_words(b"\x05" * 12))
    inputs, state = {"x": torch.ones(16)}, {"s": torch.zeros(())}
    plain = trace_workload(_runner(sec), inputs, state, n_shards=1, n_local_items=16)
    probed = trace_workload(_runner(sec), inputs, state, n_shards=1, n_local_items=16,
                            items={"us_per_item": 3.0, "base_us": 1.0})
    assert plain.item_us is None and probed.item_us == 3.0
    model = CostModel(_cal())
    assert model.predict_round_us(probed) - model.predict_round_us(plain) == pytest.approx(
        16 * (3.0 - 0.01))


@pytest.mark.parametrize("items", [{}, {"kmeans": {"us_per_item": 0.004, "base_us": 120.0,
                                                  "sizes": [16384, 65536],
                                                  "round_us": [185.5, 382.0]}}],
                         ids=["without", "with"])
def test_calibration_json_roundtrips_with_and_without_the_term(tmp_path, items):
    """A calibration with and without per-workload item terms survives the
    JSON file; an entry written before the terms existed loads with none."""
    cal = dataclasses.replace(_cal(), items=items)
    path = str(tmp_path / "calib.json")
    tcal.save_calibration(cal, path)
    back = tcal.load_calibration(path)
    assert back == cal and back.items == items
    old = {k: v for k, v in cal.to_dict().items() if k != "items"}
    assert Calibration.from_dict(old).items == {}
