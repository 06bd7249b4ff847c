"""The port's driver: sharded carried state and `run_mapreduce_until`.

Held against the JAX package (`repro.core.driver`, `repro.core.engine`) on
the same inputs, at R=1 in process and R=8 in a subprocess with 8 forced
host devices: sharded and replicated layouts of a resident per-reducer leaf
(int32, float32, bfloat16; halting early and running the full budget) give
identical bits, rounds and halt flags in both packages; the lifted
single-round job gives the reference's rounds exactly and its state within
rtol 1e-5 (float sums are taken in another order).

The halt guard is held to its documented contract (`src/repro/core/driver.py`:
any use of a sharded leaf in `halt_fn` raises a ValueError naming it), not
to the reference's own test of it, which fails on this tree.
"""

import dataclasses
import gc
import sys
import time
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from conftest import run_in_subprocess
from repro.compat import make_mesh
from repro.core import driver as jdrv
from repro.core.engine import identity_hash as jidentity
from repro.crypto import chacha as jch
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config, to_numpy, to_tensor
from repro_torch.core import driver as tdrv
from repro_torch.core import sort as ts
from repro_torch.core.engine import MapReduceSpec, identity_hash, run_mapreduce_until
from repro_torch.tools.opcount import RoundReport, wire_accounting

P = tdrv.P
KEY = bytes(range(32))
NONCE = b"\x0e" * 12
COUNTER0 = 4
C = 8  # columns of the resident leaf
N_KEYS = 16  # keys per shard of the lifted job

_REF = """
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh
from repro.core.driver import IterativeSpec, run_until
from repro.core.engine import MapReduceSpec, identity_hash, run_mapreduce_until
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha
R, C, N = {r}, {c}, {n}
mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
cfg = SecureShuffleConfig(key_words=chacha.key_to_words({key!r}),
                          nonce_words=chacha.nonce_to_words({nonce!r}), counter0={c0})
out = {{}}

def make_spec(dtype, sharded, halt_at):
    def map_fn(state, inputs, r):
        # every shard sends one unit item to every reducer
        return jnp.arange(R, dtype=jnp.int32), {{"v": jnp.ones((R,), jnp.float32)}}

    def reduce_fn(state, rk, rv, valid, r):
        got = jnp.sum(jnp.where(valid, rv["v"], 0.0))
        tot = state["tot"] + lax.psum(got, "data")
        inc = (got * (1 + lax.axis_index("data"))).astype(dtype)
        if sharded:
            big = state["big"] + inc
        else:
            row = state["big"][lax.axis_index("data")] + inc
            big = lax.all_gather(row, "data")
        return {{"big": big, "tot": tot}}, {{"tot": tot}}

    halt_fn = None if halt_at is None else (lambda state, aux, r: aux["tot"] >= halt_at)
    return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, hash_fn=identity_hash,
                         capacity=R, n_rounds=1, halt_fn=halt_fn,
                         state_specs={{"big": P("data") if sharded else P(), "tot": P()}})

for dname, dtype in (("int32", jnp.int32), ("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
    for hname, halt_at in (("halt", 3.0 * R * R), ("full", None)):
        for sharded in (False, True):
            big0 = np.load({init_path!r})[dname]  # bfloat16 travels as its uint16 bits
            big0 = big0.view(jnp.bfloat16) if dname == "bfloat16" else big0
            init = {{"big": jnp.asarray(big0), "tot": jnp.float32(0.0)}}
            res = run_until(make_spec(dtype, sharded, halt_at), {{"x": jnp.zeros((R,))}}, init,
                            mesh, max_rounds=5, min_chunk=2)
            key = f"sweep_{{dname}}_{{hname}}_{{int(sharded)}}"
            big = np.asarray(res.state["big"])
            out[key + "_big"] = big.view(np.uint16) if dname == "bfloat16" else big
            out[key + "_tot"] = np.asarray(res.state["tot"])
            out[key + "_rounds"] = np.array([res.rounds_executed, res.rounds_dispatched,
                                             int(res.halted)])

vals = np.load({init_path!r})["vals"]
spec = MapReduceSpec(map_fn=lambda k, v: (k % 4, v),
                     reduce_fn=lambda rk, rv, valid: lax.psum(
                         jnp.sum(jnp.where(valid, rv, 0.0)), "data"),
                     hash_fn=identity_hash, capacity=N)
keys = jnp.arange(N * R, dtype=jnp.int32)
for name, sec, fold, halt in (
        ("fold_secure", cfg, lambda s, o: s + o, lambda s, a, r: s >= 2.5 * N * R),
        ("fold_plain", None, lambda s, o: s + 0.5 * o, lambda s, a, r: r >= 3),
        ("replace_secure", cfg, None, lambda s, a, r: r >= 2)):
    res = run_mapreduce_until(spec, keys, jnp.asarray(vals), jnp.float32(0.0), mesh,
                              halt_fn=halt, fold_fn=fold, max_rounds=6, secure=sec)
    out[name + "_state"] = np.asarray(res.state)
    out[name + "_aux"] = np.asarray(res.aux)
    out[name + "_rounds"] = np.array([res.rounds_executed, res.rounds_dispatched,
                                      res.n_dispatches, int(res.halted)])
np.savez({path!r}, **out)
print("OK")
"""

_DTYPES = {"int32": (np.int32, torch.int32), "float32": (np.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(r: int) -> dict:
    rng = np.random.default_rng(r)
    out = {name: rng.integers(0, 50, (r, C)).astype(np.dtype(dt))
           for name, (dt, _) in _DTYPES.items()}
    out["vals"] = rng.normal(size=N_KEYS * r).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=[1, 8])
def ref(request, tmp_path_factory):
    r = request.param
    d = tmp_path_factory.mktemp(f"driver_state_ref{r}")
    np.savez(d / "in.npz", **{k: (v.view(np.uint16) if k == "bfloat16" else v)
                              for k, v in _inputs(r).items()})
    code = _REF.format(r=r, c=C, n=N_KEYS, key=KEY, nonce=NONCE, c0=COUNTER0,
                       init_path=str(d / "in.npz"), path=str(d / "ref.npz"))
    if r == 1:
        exec(code, {})
    else:
        run_in_subprocess(code, devices=r)
    return r, dict(np.load(d / "ref.npz"))


def _cfg():
    return secure_config(jch.key_to_words(KEY), jch.nonce_to_words(NONCE), COUNTER0)


def _resident_spec(mesh, dtype, sharded: bool, halt_at):
    """The reference sweep's job in the port: a resident (R, C) leaf, one row
    per reducer, and a replicated running total."""
    r = mesh.n_shards

    def map_fn(state, inputs, rnd):
        keys = torch.arange(r, dtype=torch.int32).expand(r, r)
        return keys, {"v": torch.ones((r, r))}

    def reduce_fn(state, rk, rv, valid, rnd):
        got = torch.where(valid, rv["v"], 0.0).sum(dim=1)  # (S,)
        tot = state["tot"] + mesh.psum(got)
        inc = (got * (1 + mesh.axis_index())).to(dtype)
        if sharded:
            big = state["big"] + inc[:, None, None]  # (S, 1, C): each shard's row
        else:
            big = mesh.all_gather(state["big"][mesh.axis_index()] + inc[:, None])
        return {"big": big, "tot": tot}, {"tot": tot}

    halt_fn = None if halt_at is None else (lambda state, aux, rnd: aux["tot"] >= halt_at)
    return tdrv.IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, hash_fn=identity_hash,
                              capacity=r, halt_fn=halt_fn,
                              state_specs={"big": P("data") if sharded else P(), "tot": P()})


@pytest.mark.parametrize("dname", list(_DTYPES))
def test_sharded_and_replicated_layouts_match_jax(ref, dname):
    r, want = ref
    mesh = VirtualMesh(r, "cpu")
    init_big = _inputs(r)[dname]
    for hname, halt_at in (("halt", 3.0 * r * r), ("full", None)):
        outs = []
        for sharded in (False, True):
            init = {"big": to_tensor(init_big, "cpu"), "tot": torch.tensor(0.0)}
            res = tdrv.run_until(_resident_spec(mesh, _DTYPES[dname][1], sharded, halt_at),
                                 {"x": np.zeros(r, np.float32)}, init, mesh, max_rounds=5,
                                 min_chunk=2)
            key = f"sweep_{dname}_{hname}_{int(sharded)}"
            big = to_numpy(res.state["big"])
            assert big.shape == (r, C)  # the global leaf, gathered once
            np.testing.assert_array_equal(big, want[key + "_big"])
            assert float(res.state["tot"]) == float(want[key + "_tot"])
            assert [res.rounds_executed, res.rounds_dispatched,
                    int(res.halted)] == list(want[key + "_rounds"])
            outs.append(big)
        np.testing.assert_array_equal(outs[0], outs[1])


def test_run_mapreduce_until_matches_jax(ref):
    r, want = ref
    mesh = VirtualMesh(r, "cpu")
    vals = _inputs(r)["vals"]
    spec = MapReduceSpec(map_fn=lambda k, v: (k % 4, v),
                         reduce_fn=lambda rk, rv, valid: mesh.psum(
                             torch.where(valid, rv, 0.0).sum(dim=1)),
                         hash_fn=identity_hash, capacity=N_KEYS)
    keys = np.arange(N_KEYS * r, dtype=np.int32)
    for name, sec, fold, halt in (
            ("fold_secure", _cfg(), lambda s, o: s + o, lambda s, a, rnd: s >= 2.5 * N_KEYS * r),
            ("fold_plain", None, lambda s, o: s + 0.5 * o, lambda s, a, rnd: rnd >= 3),
            ("replace_secure", _cfg(), None, lambda s, a, rnd: rnd >= 2)):
        res = run_mapreduce_until(spec, keys, vals, torch.tensor(0.0), mesh, halt_fn=halt,
                                  fold_fn=fold, max_rounds=6, secure=sec)
        assert [res.rounds_executed, res.rounds_dispatched, res.n_dispatches,
                int(res.halted)] == list(want[name + "_rounds"]), name
        np.testing.assert_allclose(float(res.state), float(want[name + "_state"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res.aux, want[name + "_aux"], rtol=1e-5, atol=1e-5)


def test_run_mapreduce_until_engine_entry():
    """The reference's own engine-entry case (tests/test_run_until.py)."""
    n = 16
    mesh = VirtualMesh(1, "cpu")
    spec = MapReduceSpec(map_fn=lambda k, v: (k % 4, torch.ones(k.shape)),
                         reduce_fn=lambda rk, rv, valid: mesh.psum(
                             torch.where(valid, rv, 0.0).sum(dim=1)),
                         hash_fn=identity_hash, capacity=n)
    res = run_mapreduce_until(spec, np.arange(n, dtype=np.int32), np.zeros(n, np.float32),
                              torch.tensor(0.0), mesh,
                              halt_fn=lambda state, aux, r: state >= 40.0,
                              fold_fn=lambda state, out: state + out, max_rounds=10)
    assert res.rounds_executed == 3 and res.halted and float(res.state) == 48.0
    np.testing.assert_array_equal(res.aux, np.full((3,), 16.0, np.float32))


# --- layout resolution ---------------------------------------------------------------------


def _dummy_spec(**kw):
    def never(*a):
        raise AssertionError("no round may run")

    return tdrv.IterativeSpec(map_fn=never, reduce_fn=never, **kw)


def test_resolve_state_mode_ignores_environment(monkeypatch):
    # an explicit mode ignores $REPRO_STATE_SPECS; 'auto' follows it, as the
    # reference's does, and is 'sharded' without it
    monkeypatch.setenv("REPRO_STATE_SPECS", "replicated")
    assert tdrv.resolve_state_mode("replicated") == "replicated"
    assert tdrv.resolve_state_mode("sharded") == "sharded"
    assert tdrv.resolve_state_mode("auto") == tdrv.resolve_state_mode(None) == "replicated"
    monkeypatch.delenv("REPRO_STATE_SPECS")
    assert tdrv.resolve_state_mode("auto") == "sharded"
    assert tdrv.resolve_state_mode(None) == "sharded"
    with pytest.raises(ValueError, match="carried-state mode"):
        tdrv.resolve_state_mode("sideways")


def test_state_specs_none_and_bare_spec_broadcast():
    state = {"a": torch.zeros(2), "b": {"c": torch.zeros(3)}}
    assert tdrv._resolve_state_specs(_dummy_spec(), state) == ([P(), P()], [False, False])
    assert tdrv._resolve_state_specs(_dummy_spec(state_specs=P("data")), state)[1] == [True, True]
    assert tdrv._resolve_state_specs(_dummy_spec(state_specs=P()), state)[1] == [False, False]
    mixed = _dummy_spec(state_specs={"a": P("data"), "b": {"c": None}})
    assert tdrv._resolve_state_specs(mixed, state) == ([P("data"), P()], [True, False])


@pytest.mark.parametrize("specs,match", [({"a": P()}, "state_specs"),
                                         ({"a": P(), "b": "data"}, r"P\(\.\.\.\)"),
                                         ([P(), P()], "state_specs")])
def test_state_specs_mismatch_raises_before_any_round(specs, match):
    state = {"a": torch.zeros(2), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match=match):
        tdrv.run_until(_dummy_spec(state_specs=specs), {"x": np.zeros(4, np.float32)}, state,
                       VirtualMesh(2, "cpu"))


def test_sharded_leaf_is_split_for_the_job_and_gathered_after():
    """map_fn/reduce_fn see each shard's part (S, n / S, ...); the result
    holds the global leaf; the caller's init_state is left as it was."""
    mesh = VirtualMesh(4, "cpu")
    seen = []

    def map_fn(state, inputs, r):
        seen.append(tuple(state["rows"].shape))
        return torch.zeros((4, 1), dtype=torch.int32), {"v": torch.ones((4, 1))}

    def reduce_fn(state, rk, rv, valid, r):
        rows = state["rows"] + mesh.axis_index()[:, None, None].to(torch.float32)
        return {"rows": rows}, {"n": mesh.psum(valid.sum(dim=1))}

    spec = tdrv.IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, capacity=1, n_rounds=2,
                              state_specs={"rows": P("data")})
    init = {"rows": torch.zeros((8, 3))}
    state, aux, dropped = tdrv.run_iterative_mapreduce(spec, {"x": np.zeros(4, np.float32)},
                                                       init, mesh)
    assert seen == [(4, 2, 3), (4, 2, 3)]
    expect = 2.0 * torch.arange(4, dtype=torch.float32).repeat_interleave(2)[:, None].expand(8, 3)
    assert torch.equal(state["rows"], expect)
    assert torch.equal(init["rows"], torch.zeros((8, 3)))
    assert aux["n"].tolist() == [4, 4]


# --- the halt guard ------------------------------------------------------------------------

_USES = {
    "torch_sum": lambda x: torch.sum(x),
    "torch_stack": lambda x: torch.stack([x, x]),
    "method": lambda x: x.sum(),
    "arith": lambda x: x + 1.0,
    "compare": lambda x: x > 0,
    "bool": lambda x: bool(x),
    "index": lambda x: x[0],
    "numpy": lambda x: np.asarray(x),
    "len": lambda x: len(x),
}


@pytest.mark.parametrize("use", list(_USES))
def test_halt_fn_touching_sharded_sort_table_raises(use):
    """Per the documented contract: the job stops at the first halt_fn call
    with a ValueError naming state['sorted'], and returns no result."""
    mesh = VirtualMesh(2, "cpu")
    base = ts.make_sample_sort_spec(mesh, 8, halt_total=16)
    spec = tdrv.IterativeSpec(map_fn=base.map_fn, reduce_fn=base.reduce_fn,
                              hash_fn=base.hash_fn, capacity=base.capacity,
                              halt_fn=lambda state, aux, r: _USES[use](state["sorted"]),
                              state_specs=base.state_specs)
    v = np.random.default_rng(0).random(16).astype(np.float32)
    init = {"edges": torch.from_numpy(ts.initial_edges(float(v.min()), float(v.max()), 2)),
            "sorted": torch.full((2, 16), torch.inf), "counts": torch.zeros(2)}
    with pytest.raises(ValueError, match=r"SHARDED carried-state leaf state\['sorted'\]"):
        tdrv.run_until(spec, {"v": v}, init, mesh, secure=_cfg(), max_rounds=3)


def test_halt_fn_on_replicated_leaves_still_works_alongside_sharded():
    """Replicated leaves, aux and the round index stay usable in halt_fn beside
    a sharded leaf, as in the reference (the same job in both packages)."""
    def jspec():
        def map_fn(state, inputs, r):
            return jnp.zeros((4,), jnp.int32), {"v": jnp.ones((4,), jnp.float32)}

        def reduce_fn(state, rk, rv, valid, r):
            got = lax.psum(jnp.sum(jnp.where(valid, rv["v"], 0.0)), "data")
            return {"big": state["big"] + got, "tot": state["tot"] + got}, {"t": got}

        return jdrv.IterativeSpec(
            map_fn=map_fn, reduce_fn=reduce_fn, hash_fn=jidentity, capacity=4,
            halt_fn=lambda state, aux, r: state["tot"] + aux["t"] * 0 >= 8.0,
            state_specs={"big": jdrv.P("data"), "tot": jdrv.P()})

    want = jdrv.run_until(jspec(), {"x": jnp.zeros((4,))},
                          {"big": jnp.zeros((1, 4)), "tot": jnp.float32(0.0)},
                          make_mesh((1,), ("data",)), max_rounds=6)
    mesh = VirtualMesh(1, "cpu")

    def reduce_fn(state, rk, rv, valid, r):
        got = mesh.psum(torch.where(valid, rv["v"], 0.0).sum(dim=1))
        return {"big": state["big"] + got[:, None, None], "tot": state["tot"] + got}, {"t": got}

    spec = tdrv.IterativeSpec(
        map_fn=lambda state, inputs, r: (torch.zeros((1, 4), dtype=torch.int32),
                                         {"v": torch.ones((1, 4))}),
        reduce_fn=reduce_fn, hash_fn=identity_hash, capacity=4,
        halt_fn=lambda state, aux, r: state["tot"] + aux["t"] * 0 >= 8.0,
        state_specs={"big": P("data"), "tot": P()})
    res = tdrv.run_until(spec, {"x": np.zeros(4, np.float32)},
                         {"big": torch.zeros((1, 4)), "tot": torch.tensor(0.0)}, mesh,
                         max_rounds=6)
    assert res.halted and res.rounds_executed == want.rounds_executed == 2
    np.testing.assert_array_equal(res.state["big"].numpy(), np.asarray(want.state["big"]))


# --- runners: the cache contract of run_until -----------------------------------------


def _runner_job(mesh):
    """A resident-leaf job that halts at its fourth round (f32, sharded)."""
    r = mesh.n_shards
    spec = _resident_spec(mesh, torch.float32, True, 4.0 * r * r)
    init = {"big": torch.zeros((r, C)), "tot": torch.zeros(())}
    return spec, {"x": np.zeros((r,), np.float32)}, init


def _assert_results_equal(a, b):
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k
    for k in a.aux:
        np.testing.assert_array_equal(a.aux[k], b.aux[k])
    np.testing.assert_array_equal(a.dropped, b.dropped)
    assert (a.rounds_executed, a.rounds_dispatched, a.n_dispatches, a.halted) == (
        b.rounds_executed, b.rounds_dispatched, b.n_dispatches, b.halted)


def test_runners_dict_is_filled_once_and_reused():
    """`runners=` a dict: one runner per chunk size, built on first use and
    reused by a later job; results equal the uncached run's."""
    mesh = VirtualMesh(4, "cpu")
    spec, inputs, init = _runner_job(mesh)
    plain = tdrv.run_until(spec, inputs, init, mesh, secure=_cfg(), max_rounds=8)
    runners = {}
    first = tdrv.run_until(spec, inputs, init, mesh, secure=_cfg(), max_rounds=8,
                           runners=runners)
    built = dict(runners)
    assert sorted(built) == [1, 2, 4]  # chunks of 1, 2, 4; the halt ends the third
    assert all(isinstance(x, tdrv._EagerRunner) and x.captures == 0 for x in built.values())
    second = tdrv.run_until(spec, inputs, init, mesh, secure=_cfg(), max_rounds=8,
                            runners=runners, round_offset=0)
    assert runners == built
    _assert_results_equal(first, plain)
    _assert_results_equal(second, plain)


def test_runners_get_or_build_and_job_tag():
    """Any object with get_or_build(n_rounds, build) serves as the cache;
    job_tag tags the job's wire records."""
    from repro_torch.core.shuffle import record_wire_bytes

    class Cache:
        def __init__(self):
            self.calls, self.held = [], {}

        def get_or_build(self, n, build):
            self.calls.append(n)
            if n not in self.held:
                self.held[n] = build()
            return self.held[n]

    mesh = VirtualMesh(2, "cpu")
    spec, inputs, init = _runner_job(mesh)
    cache = Cache()
    with record_wire_bytes() as recs:
        res = tdrv.run_until(spec, inputs, init, mesh, secure=_cfg(), max_rounds=8,
                             runners=cache, job_tag="job-7", round_offset=5)
    assert cache.calls == [1, 2, 4]
    assert len(recs) == res.rounds_executed == 4 and {r["job"] for r in recs} == {"job-7"}
    assert res.halted


def test_make_iterative_runner_on_the_cpu_is_the_eager_chunk():
    """The runner's contract: (state, aux, dropped, rounds_executed, halted),
    per-round rows zero past the executed ones, trace_info filled, and the
    results of run_iterative_mapreduce."""
    mesh = VirtualMesh(4, "cpu")
    spec, inputs, init = _runner_job(mesh)
    runner = tdrv.make_iterative_runner(spec, mesh, _cfg(), 6)
    assert isinstance(runner, tdrv._EagerRunner) and runner.n_rounds == 6
    state, aux, dropped, n_exec, halted = runner(inputs, init, 11)
    want = tdrv.run_iterative_mapreduce(dataclasses.replace(spec, n_rounds=6), inputs, init,
                                        mesh, secure=_cfg(), round_offset=11)
    assert (n_exec, halted) == (want[3], want[4]) == (4, True)
    for k in state:
        assert torch.equal(state[k], want[0][k])
    for k in aux:
        assert torch.equal(aux[k], want[1][k]) and aux[k].shape[0] == 6
        assert not aux[k][n_exec:].any()
    assert torch.equal(dropped, want[2])
    assert runner.trace_info == {"capacity": 4, "capacity_auto": False}  # spec.capacity = R
    with pytest.raises(ValueError, match="n_rounds"):
        tdrv.make_iterative_runner(spec, mesh, None, 0)


def test_halt_guard_raises_through_a_runner_cache():
    mesh = VirtualMesh(2, "cpu")
    base = ts.make_sample_sort_spec(mesh, 8, halt_total=16)
    spec = tdrv.IterativeSpec(map_fn=base.map_fn, reduce_fn=base.reduce_fn,
                              hash_fn=base.hash_fn, capacity=base.capacity,
                              halt_fn=lambda state, aux, r: state["sorted"].sum() > 0,
                              state_specs=base.state_specs)
    v = np.random.default_rng(0).random(16).astype(np.float32)
    init = {"edges": torch.from_numpy(ts.initial_edges(float(v.min()), float(v.max()), 2)),
            "sorted": torch.full((2, 16), torch.inf), "counts": torch.zeros(2)}
    runners = {}
    for _ in range(2):  # a runner whose first round raised raises again, as it did
        with pytest.raises(ValueError, match=r"SHARDED carried-state leaf state\['sorted'\]"):
            tdrv.run_until(spec, {"v": v}, init, mesh, secure=_cfg(), max_rounds=3,
                           runners=runners)


# --- graph runners on the CPU: the statics' lock and the shape budget -----------------
#
# A `_GraphRunner` needs a card to capture. Here its capture is replaced by a
# stand-in whose replay runs the captured round eagerly on the statics and
# writes what the graph writes (state, the aux and dropped rows, the halt
# flag), pausing between the round's reads and its writes so that another
# thread can interleave. Everything else of the runner -- statics, lock,
# load, the replay loop, the shape budget -- is the runner's own.


class _EagerGraph:
    def __init__(self, runner, st, aux_rows, drop_rows, pause):
        # weak, as a captured graph holds neither its runner nor its statics
        self.runner, self.st, self.pause = weakref.proxy(runner), weakref.proxy(st), pause
        self.aux_rows, self.drop_rows = aux_rows, drop_rows

    def replay(self):
        st = self.st
        with wire_accounting.isolated():
            state, aux, dropped, halt = self.runner._body(st)
        time.sleep(self.pause)
        row = (st.r - st.base).reshape(1)
        for dst, src in zip(tdrv.tree_flatten(st.state)[0], tdrv.tree_flatten(state)[0]):
            dst.copy_(src)
        for dst, src in zip(tdrv.tree_flatten(self.aux_rows)[0], tdrv.tree_flatten(aux)[0]):
            dst.index_copy_(0, row, src.unsqueeze(0))
        self.drop_rows.index_copy_(0, row, dropped.reshape(1))
        if halt is not None:
            st.halt.copy_(halt)


@pytest.fixture
def cpu_graph_runners(monkeypatch):
    """`make_iterative_runner` builds `_GraphRunner`s on a CPU mesh, whose
    captures replay eagerly (`_EagerGraph`, 2 ms between reads and writes)."""
    def capture(self, st):
        aux_rows = tdrv.tree_map(lambda a: a.new_zeros((self.n_rounds,) + tuple(a.shape)),
                                 st.aux)
        drop_rows = st.dropped.new_zeros((self.n_rounds,))
        return tdrv._Captured(_EagerGraph(self, st, aux_rows, drop_rows, 0.002), aux_rows,
                              drop_rows, RoundReport(), 0, dict(self.trace_info))

    def make(spec, mesh, secure=None, n_rounds=None, *, coalesce=None, share_with=None):
        secure = tdrv._with_knobs(secure, coalesce)
        n = spec.n_rounds if n_rounds is None else int(n_rounds)
        return tdrv._GraphRunner(spec, mesh, secure, n, coalesce, share_with)

    monkeypatch.setattr(tdrv._GraphRunner, "_capture", capture)
    monkeypatch.setattr(tdrv, "make_iterative_runner", make)
    return make


def _kmeans_case(mesh, n, seed, k=3, d=2):
    from repro_torch.core.kmeans import generate_points

    pts, _ = generate_points(n, k, d=d, seed=seed)
    p = torch.from_numpy(pts)
    return {"p": p, "w": torch.ones(n)}, p[:k].clone()


def test_graph_runner_serves_two_threads_one_at_a_time(cpu_graph_runners):
    """Two threads call one graph runner on inputs of one shape at once (two
    services on one RunnerCache): each call returns what it returns alone,
    bit for bit. The statics' lock holds a call's load, replays and clone
    together; without it one thread's load overwrote the other's inputs,
    state and round id between replays."""
    import threading

    from repro_torch.core.kmeans import make_kmeans_iterative_spec

    mesh = VirtualMesh(2, "cpu")
    spec = make_kmeans_iterative_spec(3, mesh)
    runner = cpu_graph_runners(spec, mesh, _cfg(), 4)
    calls = [(*_kmeans_case(mesh, 64, 1), 0), (*_kmeans_case(mesh, 64, 2), 100)]
    want = [runner(inp, st, off) for inp, st, off in calls]
    eager = [tdrv._EagerRunner(spec, mesh, _cfg(), 4)(inp, st, off) for inp, st, off in calls]
    for got, ref_ in zip(want, eager):
        assert torch.equal(got[0], ref_[0]) and got[3:] == ref_[3:]
    results, errors = {0: [], 1: []}, []

    def worker(i):
        try:
            for _ in range(6):
                results[i].append(runner(*calls[i]))
        except BaseException as exc:  # noqa: BLE001 -- surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for i in (0, 1):
        for got in results[i]:
            assert torch.equal(got[0], want[i][0])
            assert torch.equal(got[1]["centers"], want[i][1]["centers"])
            assert torch.equal(got[1]["shift"], want[i][1]["shift"]) and got[3:] == want[i][3:]
    assert len(runner._statics) == 1 and runner._statics.budget.limit is None


@pytest.mark.parametrize("cached", [True, False], ids=["runner_cache", "runner_dict"])
def test_fit_runner_keeps_at_most_its_cap_of_shapes(cpu_graph_runners, cached):
    """Fits at four sizes through a fit runner whose cache is capped (a
    shared RunnerCache(max_resident=2), or the fit's own RunnerCache: one
    runner per chunk size of its ladder, 1 and 2, and one more) hold the
    statics of the most recently used sizes, as many as the cap; every fit,
    an evicted size's again too, equals the eager fit bit for bit."""
    from repro_torch.core.kmeans import kmeans_fit, make_kmeans_runner
    from repro_torch.serve import RunnerCache

    mesh = VirtualMesh(2, "cpu")
    cache = RunnerCache(max_resident=2) if cached else None
    runner = make_kmeans_runner(mesh, 3, secure=_cfg(), threshold=1e-3, rounds_per_dispatch=2,
                                cache=cache)
    own = cache if cached else runner.runners
    assert isinstance(own, RunnerCache) and own.max_resident == (2 if cached else 3)
    budget, cap = own.shape_budget, own.max_resident
    lru, evictions = [], 0
    for i, (n, seed) in enumerate([(64, 1), (96, 2), (128, 3), (160, 4), (64, 1)]):
        inp, init = _kmeans_case(mesh, n, seed)
        got = kmeans_fit(inp["p"], 3, mesh, runner=runner, max_iter=12)
        want = kmeans_fit(inp["p"], 3, mesh, secure=_cfg(), threshold=1e-3, max_iter=12,
                          rounds_per_dispatch=2)
        assert torch.equal(got.centers, want.centers), n
        assert (got.n_iter, got.center_shift) == (want.n_iter, want.center_shift)
        runners = list(own._runners.values())
        assert all(r._statics is runners[0]._statics for r in runners)
        held = {key[0][0][1] for key in runners[0]._statics}  # points per shard
        lru = [m for m in lru if m != n // 2] + [n // 2]
        if len(lru) > cap:
            lru, evictions = lru[1:], evictions + 1
        assert held == set(lru) and len(budget) == len(held), (n, held, lru)
    assert budget.evictions == evictions > 0


def test_shape_budget_never_evicts_statics_in_use():
    """Over its limit the budget evicts the least recently used statics that
    no call holds; one in use stays until released. Statics whose warm-up
    failed (never `ready`) are dropped when their last user releases them."""
    budget = tdrv.ShapeBudget(1)
    a, b = tdrv._Store(budget), tdrv._Store(budget)  # two jobs' stores of statics

    def use(store, key, within=budget):
        st = within.use(store, key)
        st.ready = True  # as after the caller's warm-up
        return st

    held = use(a, "x")  # a call in progress
    budget.release(b, "y", use(b, "y"))
    assert set(a) == {"x"} and not b  # y was the one not in use
    held2 = use(b, "z")  # two calls in progress: over the limit, none evicted
    assert set(a) == {"x"} and set(b) == {"z"} and len(budget) == 2
    budget.release(a, "x", held)  # x is released and least recently used
    assert not a and set(b) == {"z"} and len(budget) == 1
    budget.release(b, "z", held2)
    assert set(b) == {"z"} and budget.evictions == 2
    budget.release(b, "w", budget.use(b, "w"))  # evicts z; w's warm-up raised: not kept
    assert not b and len(budget) == 0 and budget.evictions == 3
    unbounded = tdrv.ShapeBudget()
    c = tdrv._Store(unbounded)
    for key in range(5):
        unbounded.release(c, key, use(c, key, unbounded))
    assert len(unbounded) == 5 and unbounded.evictions == 0


def test_dropped_runners_free_their_statics_without_the_collector(cpu_graph_runners):
    """A runner, its budget and its statics form no reference cycle: once
    the runner (or the cache holding it) is dropped, its statics -- the
    input copies and captures on the card -- are freed at once, not at the
    next collection, and leave the budget's count."""
    from repro_torch.core.kmeans import make_kmeans_iterative_spec

    mesh = VirtualMesh(2, "cpu")
    runner = cpu_graph_runners(make_kmeans_iterative_spec(3, mesh), mesh, _cfg(), 2)
    budget = tdrv.ShapeBudget(4)
    runner.keep_shapes_within(budget)
    runner(*_kmeans_case(mesh, 64, 1), 0)
    st = weakref.ref(next(iter(runner._statics.values())))
    assert len(budget) == 1
    gc.collect()
    gc.disable()
    try:
        del runner
        assert st() is None and len(budget) == 0
    finally:
        gc.enable()


def test_runner_cache_eviction_and_clear_free_statics(cpu_graph_runners):
    """A RunnerCache frees what its graph runners hold as it lets them go:
    an evicted runner's captures at once, its job's statics once no resident
    runner shares them, and everything on clear(); captures() and the
    shape count follow. Nothing waits for the collector."""
    from repro_torch.core.kmeans import make_kmeans_iterative_spec
    from repro_torch.serve import RunnerCache

    mesh = VirtualMesh(2, "cpu")
    spec = make_kmeans_iterative_spec(3, mesh)
    cache = RunnerCache(max_resident=2)
    case = _kmeans_case(mesh, 64, 1)

    def get(job, n, share=None):
        return cache.get_or_build((job, n), lambda: cpu_graph_runners(
            spec, mesh, _cfg(), n, share_with=None if share is None else cache._runners[share]))

    gc.collect()
    gc.disable()
    try:
        get("a", 1)(*case, 0)
        get("a", 2, share=("a", 1))(*case, 0)  # job a's two chunk sizes share statics
        st = weakref.ref(next(iter(cache._runners[("a", 1)]._statics.values())))
        assert set(st().captured) == {1, 2} and cache.captures() == 2
        assert len(cache.shape_budget) == 1
        get("b", 1)(*_kmeans_case(mesh, 96, 2), 0)  # evicts ("a", 1): its capture goes
        assert set(st().captured) == {2} and cache.captures() == 2
        assert len(cache.shape_budget) == 2 and cache.evictions == 1
        get("c", 1)  # evicts ("a", 2): job a's statics go with its last runner
        assert st() is None and len(cache.shape_budget) == 1 and cache.captures() == 1
        cache.clear()
        assert len(cache.shape_budget) == 0 and cache.captures() == 0
    finally:
        gc.enable()


def test_pytree_walkers_keep_no_leaf_alive():
    """Flattening, unflattening, mapping and naming the paths of a tree leave
    no reference cycle behind: once the caller drops the tree, its leaves
    (device tensors on the card) are freed at once, not by the collector."""
    from repro_torch import tree as ttree

    t = {"a": torch.zeros(3), "b": [torch.ones(2), (torch.ones(1), torch.zeros(()))]}
    leaves, treedef = ttree.tree_flatten(t)
    refs = [weakref.ref(x) for x in leaves]
    gc.collect()
    gc.disable()
    try:
        assert ttree.tree_unflatten(treedef, leaves)["b"][1][0] is leaves[2]
        ttree.tree_map(lambda x: x + 1, t)
        assert ttree.tree_paths(t) == ["['a']", "['b'][0]", "['b'][1][0]", "['b'][1][1]"]
        del t, leaves, treedef
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
