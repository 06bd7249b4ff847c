"""Port job service (repro_torch.serve) against repro.serve.service.

The contract tests of `tests/test_service.py`, held on the port at R=1 on
the CPU mesh (where the driver's runner is the eager chunk): the bucket
ladder, the cache's counters and LRU eviction, view keys disjoint across
secure material, a warm resubmit with 0 runner misses, validation and a
closed service, priority admission, eviction under live jobs (made
deterministic: both jobs are admitted in one scheduler pass), interleaved ==
serial bit for bit for a secure k-means, sort and grep mix, and
`kmeans_fit(runner=make_kmeans_runner(...))`. The wire-accounting contract
(re-entrant sinks, out-of-order exits, job tags) is held to the port's
documented semantics -- one record per EXECUTED round -- not to the
reference's trace-time records (its re-entrancy test fails on the reference).

Parity: the JAX `SecureJobService` and the port's serve the same secure mix
in the same submit order; round bases, n_iter and rounds are equal exactly,
sort and grep outputs exactly, centres and shifts within 1e-5 (the port's
one-hot segment sums add in another order than `jax.ops.segment_sum`). R=1
runs in process, R=8 in a subprocess with 8 forced host devices.
"""

import time

import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro.compat import make_mesh
from repro.core import kmeans as jkm
from repro.core.shuffle import SecureShuffleConfig as JSecure
from repro.crypto import chacha as jch
from repro.serve import service as jsvc
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import kmeans as tkm
from repro_torch.serve import (
    RunnerCache,
    SecureJobService,
    bucket_for,
    resolve_bucket_growth,
    resolve_max_resident,
)

KEY = bytes(range(32))
NONCE = b"\x21" * 12
COUNTER0 = 3


def _cfg(key=KEY, counter0=COUNTER0):
    return secure_config(jch.key_to_words(key), jch.nonce_to_words(NONCE), counter0)


def _mesh(r: int = 1):
    return VirtualMesh(r, "cpu")


def _mix(r: int):
    """The secure mix both services serve: two blobs, normal values, tokens."""
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.normal(-2, 0.2, (5 * r, 2)),
                          rng.normal(2, 0.2, (5 * r, 2))]).astype(np.float32)
    vals = rng.normal(0, 1, (9 * r,)).astype(np.float32)
    toks = rng.integers(0, 5, (12 * r,)).astype(np.int32)
    return pts, vals, toks, np.array([1, 3], np.int32)


def _submit_three(svc, pts, vals, toks, pats):
    """The fixed submit order every run shares (hence the same round bases)."""
    hk = svc.submit_kmeans(pts, 2, max_rounds=6, min_chunk=2, max_chunk=2)
    hs = svc.submit_sort(vals, max_rounds=3, min_chunk=1, max_chunk=2)
    hg = svc.submit_grep(toks, pats, n_rounds=2)
    return hk, hs, hg


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


# --- geometric bucket ladder --------------------------------------------------------


def test_bucket_ladder_properties():
    for n, want in [(1, 4), (4, 4), (5, 8), (9, 16), (17, 32), (100, 128)]:
        assert bucket_for(n, multiple=4, growth=2.0) == want
        assert bucket_for(n, multiple=4, growth=2.0) == jsvc.bucket_for(n, multiple=4,
                                                                        growth=2.0)
    for growth in (1.5, 2.0, 4.0):
        for n in range(1, 200):
            b = bucket_for(n, multiple=8, growth=growth)
            assert b >= n and b % 8 == 0
            assert b == jsvc.bucket_for(n, multiple=8, growth=growth)
    assert bucket_for(9, multiple=8, growth=1.01) == 16
    assert bucket_for(110, growth=2.0) == bucket_for(100, growth=2.0) == 128
    with pytest.raises(ValueError, match="n >= 1"):
        bucket_for(0)
    with pytest.raises(ValueError, match="multiple >= 1"):
        bucket_for(4, multiple=0)


def test_resolvers_take_explicit_values_and_read_no_environment(monkeypatch):
    # explicit values read no environment; 'auto' follows it, as the
    # reference's does (tests/test_torch_costmodel.py holds the whole order)
    monkeypatch.setenv(jsvc.BUCKET_GROWTH_ENV, "1.25")
    monkeypatch.setenv(jsvc.MAX_RUNNERS_ENV, "2")
    assert resolve_bucket_growth(1.5) == 1.5
    assert resolve_max_resident(None) is None
    assert resolve_max_resident(3) == 3
    for unbounded in ("none", "0", 0, "unbounded"):
        assert resolve_max_resident(unbounded) is None
    assert resolve_bucket_growth() == resolve_bucket_growth("auto") == 1.25
    assert resolve_max_resident("auto") == 2
    monkeypatch.delenv(jsvc.BUCKET_GROWTH_ENV)
    monkeypatch.delenv(jsvc.MAX_RUNNERS_ENV)
    assert resolve_bucket_growth() == resolve_bucket_growth("auto") == 2.0
    assert resolve_max_resident("auto") is None
    for bad in (1.0, 0.5, "spam"):
        with pytest.raises(ValueError, match="bucket growth"):
            resolve_bucket_growth(bad)
    with pytest.raises(ValueError, match="max_resident"):
        resolve_max_resident(-1)


# --- runner cache ------------------------------------------------------------------


def test_runner_cache_counters_and_lru_eviction():
    cache = RunnerCache(max_resident=2)

    def dead():  # a hit must never call the build closure
        raise AssertionError("build called on a cache hit")

    class R:
        captures, pool_bytes = 1, 10

    a, b, c = R(), R(), R()
    assert cache.get_or_build(("a",), lambda: a) is a   # miss
    assert cache.get_or_build(("a",), dead) is a        # hit
    assert cache.get_or_build(("b",), lambda: b) is b   # miss
    assert cache.get_or_build(("a",), dead) is a        # hit: a now most recent
    assert cache.get_or_build(("c",), lambda: c) is c   # miss: evicts b
    assert cache.keys() == [("a",), ("c",)]
    s = cache.stats()
    assert (s["hits"], s["misses"], s["evictions"]) == (2, 3, 1)
    assert s["resident"] == 2 and s["max_resident"] == 2
    assert (s["captures"], s["pool_bytes"]) == (2, 20)
    assert cache.get_or_build(("b",), lambda: b) is b   # rebuilt: a fresh miss
    assert cache.stats()["misses"] == 4
    cache.clear()
    assert len(cache) == 0


def test_cache_view_keys_disjoint_across_secure_material():
    """Key, nonce and counter0 are baked into a runner's launches, so they key
    the cache: different material never aliases a runner."""
    cache = RunnerCache()
    mesh = _mesh()

    def view(secure):
        return cache.view(spec_id=("w", 1), mesh=mesh, secure=secure)

    cfg = _cfg()
    bases = [view(None).key_base, view(cfg).key_base,
             view(_cfg(key=b"\x07" * 32)).key_base,
             view(_cfg(counter0=COUNTER0 + 1)).key_base,
             view(cfg.with_coalesce(False)).key_base,
             cache.view(spec_id=("w", 1), mesh=_mesh(2), secure=cfg).key_base]
    assert len(set(bases)) == len(bases)
    assert view(_cfg()).key_base == bases[1]
    assert cache.view(spec_id=("w", 2), mesh=mesh).key_base != bases[0]


# --- service ------------------------------------------------------------------------


def test_service_warm_resubmit_zero_misses():
    """A same-bucket resubmit runs on cached runners only: 0 runner misses
    and no new capture, its keystream budget reserved right after the
    first's."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(-3, 0.1, (6, 2)),
                          rng.normal(3, 0.1, (6, 2))]).astype(np.float32)
    cache = RunnerCache()
    with SecureJobService(_mesh(), secure=_cfg(), cache=cache, max_concurrent=2) as svc:
        h1 = svc.submit_kmeans(pts, 2, max_rounds=4, min_chunk=4, max_chunk=4)
        r1 = h1.result(timeout=300)
        assert h1.runner_misses > 0 and not h1.warm
        assert r1["halted"] and r1["n_iter"] >= 1
        assert h1.latency_s is not None and h1.queue_s is not None
        captures = cache.captures()
        h2 = svc.submit_kmeans(torch.from_numpy(pts[:10]), 2, max_rounds=4,
                               min_chunk=4, max_chunk=4)
        r2 = h2.result(timeout=300)
        assert h2.runner_misses == 0 and h2.warm
        assert cache.captures() == captures == 0  # the CPU mesh captures no graph
        assert h2.bucket == h1.bucket  # n=10 and n=12 pad to one bucket
        assert (h1.round_base, h2.round_base) == (0, h1.max_rounds)
        assert r2["halted"]
    assert svc.stats()["jobs_completed"] == 2


def test_submit_validation_and_closed_service():
    svc = SecureJobService(_mesh())
    with pytest.raises(ValueError, match="k must be"):
        svc.submit_kmeans(np.zeros((4, 2), np.float32), 9)
    with pytest.raises(ValueError, match="points must be"):
        svc.submit_kmeans(torch.zeros((4,)), 1)
    with pytest.raises(ValueError, match="values must be"):
        svc.submit_sort(np.zeros((0,), np.float32))
    with pytest.raises(ValueError, match="n_rounds must be"):
        svc.submit_grep(np.zeros((4,), np.int32), [1], n_rounds=0)
    with pytest.raises(ValueError, match="priority"):
        svc.submit_grep(np.zeros((4,), np.int32), [1], priority=-1)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_grep(np.zeros((4,), np.int32), [1])


def test_priority_submit_admits_ahead_of_fifo():
    """With the one slot busy, a later priority submit is admitted before
    the earlier normal one; the active job is never preempted; round bases
    follow submit order."""
    toks = (np.arange(16) % 5).astype(np.int32)
    with SecureJobService(_mesh(), max_concurrent=1) as svc:
        ha = svc.submit_grep(toks, [1], n_rounds=2)
        deadline = time.perf_counter() + 120
        while ha.started_at is None:
            assert time.perf_counter() < deadline, "job A never started"
            time.sleep(0.001)
        hb = svc.submit_grep(toks, [2], n_rounds=2)
        hc = svc.submit_grep(toks, [3], n_rounds=2, priority=1)
        for h in (ha, hb, hc):
            h.result(timeout=600)
    assert (ha.priority, hb.priority, hc.priority) == (0, 0, 1)
    assert ha.started_at < hc.started_at < hb.started_at
    assert hc.finished_at < hb.started_at  # one slot: strictly serial
    assert hb.round_base == ha.round_base + ha.max_rounds
    assert hc.round_base == hb.round_base + hb.max_rounds


def test_lru_eviction_of_live_jobs_is_bitidentical_and_counted():
    """Residency cap 1 and two interleaved jobs admitted in one pass: every
    chunk evicts the other job's runner, which is rebuilt on its next chunk.
    Results equal an unbounded cache's bit for bit. Both jobs are submitted
    while the scheduler waits on the service's lock, so the counts are exact."""
    toks = np.random.default_rng(5).integers(0, 7, (24,)).astype(np.int32)

    def run(cache):
        with SecureJobService(_mesh(), secure=_cfg(), cache=cache, max_concurrent=2) as svc:
            with svc._cv:  # both jobs queued before the scheduler's next pass
                ha = svc.submit_grep(toks, [1, 2], n_rounds=2, min_chunk=1, max_chunk=1)
                hb = svc.submit_grep(toks, [3, 4, 5], n_rounds=2, min_chunk=1, max_chunk=1)
            return ha.result(timeout=600), hb.result(timeout=600), (ha, hb)

    capped = RunnerCache(max_resident=1)
    ra_c, rb_c, (ha, hb) = run(capped)
    s = capped.stats()
    assert (s["misses"], s["evictions"], s["resident"]) == (4, 3, 1)
    assert (ha.runner_misses, hb.runner_misses) == (2, 2)
    unbounded = RunnerCache()
    ra_u, rb_u, _ = run(unbounded)
    s = unbounded.stats()
    assert (s["misses"], s["hits"], s["evictions"]) == (2, 2, 0)
    _assert_same(ra_c, ra_u)
    _assert_same(rb_c, rb_u)


def test_interleaved_bitidentical_to_serial_secure():
    """Three concurrent secure jobs, chunks interleaved on one mesh, equal the
    same submissions run one at a time, bit for bit; the serial rerun, on a
    fresh service sharing the cache, is warm throughout."""
    pts, vals, toks, pats = _mix(1)
    cache = RunnerCache()

    def run(max_concurrent):
        with SecureJobService(_mesh(), secure=_cfg(), cache=cache,
                              max_concurrent=max_concurrent) as svc:
            handles = _submit_three(svc, pts, vals, toks, pats)
            return handles, [h.result(timeout=600) for h in handles]

    (hk, hs, hg), (rk, rs, rg) = run(3)
    assert hk.chunks > 1  # k-means spans several scheduler passes
    assert hg.round_base == hk.max_rounds + hs.max_rounds
    np.testing.assert_array_equal(rg["counts"], [(toks == p).sum() for p in pats])
    np.testing.assert_array_equal(rs["sorted"], np.sort(vals))
    handles, results = run(1)
    for a, b in zip((rk, rs, rg), results):
        _assert_same(a, b)
    assert all(h.warm for h in handles)


# --- wire accounting across interleaved generators ----------------------------------


def _tiny_spec(n=4):
    from repro_torch.core.driver import IterativeSpec
    from repro_torch.core.engine import identity_hash

    def map_fn(state, inputs, r):
        s = inputs["x"].shape[0]
        return torch.zeros((s, n), dtype=torch.int32), {"v": torch.ones((s, n))}

    def reduce_fn(state, rk, rv, valid, r):
        got = torch.where(valid, rv["v"], 0.0).sum(dim=1)
        got = got.sum().expand(rk.shape[0])  # psum over the mesh's shards
        return state + got, {"got": got}

    return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, hash_fn=identity_hash,
                         capacity=n)


def _drain(gen):
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def test_wire_accounting_reentrant_interleaved_generators():
    """Two interleaved `run_until_chunks` jobs, each holding its own
    `record_wire_bytes` open across suspensions, exiting out of stack order.
    The port's contract: every open sink gets one record per EXECUTED round,
    tagged with the job that ran it."""
    from repro_torch.core.driver import run_until_chunks
    from repro_torch.core.shuffle import record_wire_bytes, wire_accounting

    mesh = _mesh()
    inputs = {"x": torch.zeros((4,))}
    assert not wire_accounting.enabled
    ctx_a = record_wire_bytes()
    recs_a = ctx_a.__enter__()
    gen_a = run_until_chunks(_tiny_spec(), inputs, torch.tensor(0.0), mesh, secure=_cfg(),
                             max_rounds=2, job_tag="job-A", runners={})
    next(gen_a)  # A's round 0
    ctx_b = record_wire_bytes()
    recs_b = ctx_b.__enter__()
    gen_b = run_until_chunks(_tiny_spec(), inputs, torch.tensor(0.0), mesh, secure=_cfg(),
                             max_rounds=2, job_tag="job-B", runners={})
    next(gen_b)  # B's round 0, both sinks open
    ctx_a.__exit__(None, None, None)  # A leaves first while B stays open
    res_a = _drain(gen_a)  # A's round 1: only B's sink is open
    res_b = _drain(gen_b)
    ctx_b.__exit__(None, None, None)

    assert [r["job"] for r in recs_a] == ["job-A", "job-B"]
    assert [r["job"] for r in recs_b] == ["job-B", "job-A", "job-B"]
    assert len({r["bytes"] for r in recs_a + recs_b}) == 1
    assert all(r["bytes"] > 0 and r["keystream_launches"] == 2 for r in recs_a + recs_b)
    assert float(res_a.state) == float(res_b.state) == 2 * 4
    assert not wire_accounting.enabled


def test_wire_accounting_shared_sink_splits_by_job_tag():
    from repro_torch.core.driver import run_until_chunks
    from repro_torch.core.shuffle import record_wire_bytes

    mesh = _mesh()
    inputs = {"x": torch.zeros((4,))}
    with record_wire_bytes() as recs:
        gen_a = run_until_chunks(_tiny_spec(), inputs, torch.tensor(0.0), mesh,
                                 max_rounds=1, job_tag=11, runners={})
        gen_b = run_until_chunks(_tiny_spec(), inputs, torch.tensor(0.0), mesh,
                                 max_rounds=1, job_tag=22, runners={})
        next(gen_a, None)
        next(gen_b, None)
        _drain(gen_a)
        _drain(gen_b)
    assert [r["job"] for r in recs] == [11, 22]


# --- kmeans_fit through a prebuilt runner cache --------------------------------------


def test_kmeans_fit_runner_matches_reference():
    """`kmeans_fit(runner=make_kmeans_runner(...))` against the reference's:
    same n_iter and rounds, centres within 1e-5; the runner's baked
    threshold wins over the call's, a runner without one raises, and a
    second fit through a cache-backed runner is all hits."""
    pts, _ = tkm.generate_points(96, 3, d=2, seed=4)
    thr = 1e-3
    jmesh = make_mesh((1,), ("data",))
    jsec = JSecure(key_words=jch.key_to_words(KEY), nonce_words=jch.nonce_to_words(NONCE),
                   counter0=COUNTER0)
    jr = jkm.make_kmeans_runner(jmesh, 3, secure=jsec, impl="jnp", rounds_per_dispatch=4,
                                threshold=thr, min_chunk=4)
    want = jkm.kmeans_fit(pts, 3, jmesh, runner=jr, threshold=123.0, max_iter=12)

    cache = RunnerCache()
    tr = tkm.make_kmeans_runner(_mesh(), 3, secure=_cfg(), rounds_per_dispatch=4,
                                threshold=thr, min_chunk=4, cache=cache)
    got = tkm.kmeans_fit(pts, 3, _mesh(), runner=tr, threshold=123.0, max_iter=12)
    assert (got.n_iter, got.n_rounds_dispatched, got.n_dispatches) == (
        want.n_iter, want.n_rounds_dispatched, want.n_dispatches)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), atol=1e-5)
    np.testing.assert_allclose(got.center_shift, want.center_shift, atol=1e-5)
    misses = cache.misses
    again = tkm.kmeans_fit(pts, 3, _mesh(), runner=tr, max_iter=12)
    assert cache.misses == misses and cache.hits > 0
    assert torch.equal(again.centers, got.centers)
    with pytest.raises(ValueError, match="without a threshold"):
        tkm.kmeans_fit(pts, 3, _mesh(), runner=tkm.make_kmeans_runner(_mesh(), 3))


def test_kmeans_runner_serves_fits_of_two_sizes():
    """One `make_kmeans_runner(...)` serves fits of two sizes, each equal bit
    for bit to the uncached fit at its size (the runner keys its captures by
    the inputs' shapes)."""
    thr = 1e-3
    tr = tkm.make_kmeans_runner(_mesh(2), 3, secure=_cfg(), rounds_per_dispatch=4,
                                threshold=thr)
    for n, seed in ((96, 4), (160, 5)):
        pts, _ = tkm.generate_points(n, 3, d=2, seed=seed)
        got = tkm.kmeans_fit(pts, 3, _mesh(2), runner=tr, max_iter=12)
        want = tkm.kmeans_fit(pts, 3, _mesh(2), secure=_cfg(), threshold=thr, max_iter=12,
                              rounds_per_dispatch=4)
        assert torch.equal(got.centers, want.centers), n
        assert (got.n_iter, got.center_shift, got.n_rounds_dispatched) == (
            want.n_iter, want.center_shift, want.n_rounds_dispatched)


# --- parity with the JAX service -----------------------------------------------------

_REF = """
import numpy as np, jax
from repro.compat import make_mesh
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha
from repro.serve.service import SecureJobService
R = {r}
mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
cfg = SecureShuffleConfig(key_words=chacha.key_to_words({key!r}),
                          nonce_words=chacha.nonce_to_words({nonce!r}), counter0={c0})
d = np.load({inp!r})
out = {{}}
with SecureJobService(mesh, secure=cfg, max_concurrent=3) as svc:
    hk = svc.submit_kmeans(d["pts"], 2, max_rounds=6, min_chunk=2, max_chunk=2)
    hs = svc.submit_sort(d["vals"], max_rounds=3, min_chunk=1, max_chunk=2)
    hg = svc.submit_grep(d["toks"], d["pats"], n_rounds=2)
    for name, h in (("kmeans", hk), ("sort", hs), ("grep", hg)):
        for k, v in h.result(timeout=1200).items():
            out[name + "_" + k] = np.asarray(v)
        out[name + "_round_base"] = np.array(h.round_base)
        out[name + "_bucket"] = np.array(h.bucket)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module", params=[1, 8])
def served(request, tmp_path_factory):
    """(R, the port's results and handles, the JAX service's results) for the mix."""
    r = request.param
    d = tmp_path_factory.mktemp(f"service_ref{r}")
    pts, vals, toks, pats = _mix(r)
    np.savez(d / "in.npz", pts=pts, vals=vals, toks=toks, pats=pats)
    code = _REF.format(r=r, key=KEY, nonce=NONCE, c0=COUNTER0, inp=str(d / "in.npz"),
                       path=str(d / "ref.npz"))
    if r == 1:
        exec(code, {})
    else:
        run_in_subprocess(code, devices=r)
    with SecureJobService(_mesh(r), secure=_cfg(), max_concurrent=3) as svc:
        handles = _submit_three(svc, pts, vals, toks, pats)
        results = [h.result(timeout=600) for h in handles]
    return r, dict(zip(("kmeans", "sort", "grep"), zip(results, handles))), dict(
        np.load(d / "ref.npz"))


def test_service_matches_jax_service(served):
    r, port, want = served
    for name, (res, h) in port.items():
        assert h.round_base == int(want[f"{name}_round_base"])
        assert h.bucket == int(want[f"{name}_bucket"])
    (rk, _), (rs, _), (rg, _) = port["kmeans"], port["sort"], port["grep"]
    assert rk["n_iter"] == int(want["kmeans_n_iter"]) and rk["halted"] == bool(
        want["kmeans_halted"])
    assert rk["n_dispatches"] == int(want["kmeans_n_dispatches"])
    np.testing.assert_allclose(rk["centers"], want["kmeans_centers"], atol=1e-5)
    np.testing.assert_allclose(rk["shifts"], want["kmeans_shifts"], atol=1e-5)
    for key in ("sorted", "counts", "dropped"):
        np.testing.assert_array_equal(rs[key], want[f"sort_{key}"], err_msg=key)
    assert (rs["rounds"], rs["halted"]) == (int(want["sort_rounds"]),
                                            bool(want["sort_halted"]))
    for key in ("counts", "per_round"):
        np.testing.assert_array_equal(rg[key], want[f"grep_{key}"], err_msg=key)
    assert (rg["rounds"], rg["halted"]) == (int(want["grep_rounds"]),
                                            bool(want["grep_halted"]))


def test_service_close_stops_its_scheduler_thread():
    svc = SecureJobService(_mesh())
    h = svc.submit_grep(np.arange(8, dtype=np.int32), [1], n_rounds=1)
    svc.close()  # drains the queued job first
    assert h.done() and not svc._thread.is_alive()
    np.testing.assert_array_equal(h.result()["counts"], [1.0])


def test_runner_cache_cap_bounds_shapes_and_eager_runners_keep_none():
    """`max_resident` also bounds the shapes whose statics the cache's graph
    runners keep: the cache hands its `shape_budget` to every runner it
    builds, through its views and a served job's runners too (the graph
    side is held in tests/test_torch_driver_state.py). The CPU mesh's eager
    runners keep no statics: fits at three sizes through a cache capped at
    two leave the budget empty, and stats() reports it. A fit runner without
    a cache keeps its runners in a small RunnerCache of its own: one per
    chunk size of its ladder (1, 2, 4, 8) and one more."""
    from repro_torch.serve.service import JobHandle, _JobRunners

    cache = RunnerCache(max_resident=2)
    assert cache.shape_budget.limit == 2 and RunnerCache().shape_budget.limit is None

    class Graphish:
        captures = pool_bytes = 0

        def keep_shapes_within(self, budget):
            self.budget = budget

    handle = JobHandle(job_id=0, kind="kmeans", n=1, bucket=1, round_base=0, max_rounds=1)
    job_runners = _JobRunners(cache.view(spec_id=("x",), mesh=_mesh(2)), handle)
    assert job_runners.get_or_build(1, Graphish).budget is cache.shape_budget
    cache.clear()
    runner = tkm.make_kmeans_runner(_mesh(2), 3, secure=_cfg(), rounds_per_dispatch=2,
                                    threshold=1e-3, cache=cache)
    for n, seed in ((64, 1), (96, 2), (128, 3)):
        pts, _ = tkm.generate_points(n, 3, d=2, seed=seed)
        tkm.kmeans_fit(pts, 3, _mesh(2), runner=runner, max_iter=12)
    assert len(cache) == 2 and cache.captures() == 0
    s = cache.stats()
    assert (s["shapes"], s["shape_evictions"]) == (0, 0)
    plain = tkm.make_kmeans_runner(_mesh(2), 3, threshold=1e-3)
    assert isinstance(plain.runners, RunnerCache) and plain.runners.max_resident == 5
