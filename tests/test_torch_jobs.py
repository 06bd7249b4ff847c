"""The port's canonical cluster jobs and the admission testbed.

The reference's seven tests of `repro.runtime.jobs` (`tests/test_jobs.py`)
and its three `AdmissionSim` tests (`tests/test_service.py`) on
`repro_torch.runtime`; the four script sources equal the reference's
verbatim, and both packages' `AdmissionSim` replay the canonical traces to
the same results.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import replace as dc_replace

import numpy as np
import pytest

from repro.runtime import jobs as jjobs
from repro.runtime import sim as jsim
from repro_torch.runtime import jobs as tjobs
from repro_torch.runtime.jobs import make_cluster, run_kmeans, run_wordcount
from repro_torch.runtime.sim import (
    AdmissionSim,
    SimJob,
    TimingModel,
    burst_trace,
    straggler_trace,
)

LINES = [
    "the quick brown fox",
    "the lazy dog",
    "the quick dog jumps",
    "brown dog brown fox",
]


def _expected_counts(lines):
    return dict(Counter(w for line in lines for w in line.split()))


def test_make_cluster_wiring():
    cluster, client, workers = make_cluster(3)
    assert len(workers) == 3
    assert [w.name for w in workers] == ["w0", "w1", "w2"]
    for w in workers:
        assert cluster.entities[w.name] is w
    assert cluster.entities["client"] is client


def test_wordcount_correctness():
    cluster, client, _ = make_cluster(4)
    pairs, completed = run_wordcount(cluster, client, LINES, n_mappers=2, n_reducers=2)
    assert pairs == _expected_counts(LINES)
    assert completed["elapsed"] > 0.0


def test_wordcount_deterministic():
    outs = []
    for _ in range(2):
        cluster, client, _ = make_cluster(4)
        pairs, completed = run_wordcount(cluster, client, LINES, n_mappers=2, n_reducers=2)
        outs.append((pairs, completed["elapsed"], cluster.now, cluster.delivered_messages))
    assert outs[0] == outs[1]


def test_wordcount_mapper_split_invariant():
    base_cluster, base_client, _ = make_cluster(4)
    base, _ = run_wordcount(base_cluster, base_client, LINES, n_mappers=1, n_reducers=1)
    for n_mappers, n_reducers in [(2, 2), (4, 3)]:
        cluster, client, _ = make_cluster(n_mappers + n_reducers)
        pairs, _ = run_wordcount(cluster, client, LINES, n_mappers=n_mappers,
                                 n_reducers=n_reducers)
        assert pairs == base


def _points(n=60, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1, 0.9, size=(k, 2))
    pts = centers[rng.integers(0, k, size=n)] + rng.normal(scale=0.02, size=(n, 2))
    return pts.astype(np.float32)


def _kmeans_ref(points, k, max_iter, threshold):
    """Plain-host oracle for the jobs' script k-means math."""
    centers = np.asarray(points[:k], np.float64)
    for _ in range(max_iter):
        d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(axis=1)
        new = centers.copy()
        for i in range(k):
            mask = assign == i
            if mask.any():
                new[i] = points[mask].mean(axis=0)
        shift = float(np.mean(np.linalg.norm(new - centers, axis=1)))
        centers = new
        if shift < threshold:
            break
    return centers.astype(np.float32)


def test_kmeans_converges_to_reference():
    pts = _points()
    cluster, client, _ = make_cluster(4)
    centers, history = run_kmeans(cluster, client, pts, 3, n_mappers=2, n_reducers=2,
                                  max_iter=20)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    threshold = float(np.linalg.norm(hi - lo)) / 1000.0
    ref = _kmeans_ref(pts, 3, 20, threshold)
    assert history
    assert history[-1]["shift"] < threshold
    assert np.allclose(np.sort(centers, axis=0), np.sort(ref, axis=0), atol=1e-3)


def test_kmeans_deterministic():
    pts = _points(seed=3)
    runs = []
    for _ in range(2):
        cluster, client, _ = make_cluster(4)
        centers, history = run_kmeans(cluster, client, pts, 3, n_mappers=2, n_reducers=2,
                                      max_iter=15)
        runs.append((centers.tobytes(), [h["shift"] for h in history],
                     [h["elapsed"] for h in history]))
    assert runs[0] == runs[1]


def test_timing_model_scales_elapsed():
    slow = TimingModel(net_bw_bytes_s=1.0e6, net_latency_s=5e-3)
    fast = TimingModel()
    elapsed = {}
    for name, timing in [("slow", slow), ("fast", fast)]:
        cluster, client, _ = make_cluster(4, timing=timing)
        _, completed = run_wordcount(cluster, client, LINES, n_mappers=2, n_reducers=2)
        elapsed[name] = completed["elapsed"]
    assert elapsed["slow"] > elapsed["fast"]


def test_script_sources_are_the_reference_verbatim():
    for name in ("WORDCOUNT_MAP", "WORDCOUNT_REDUCE", "KMEANS_MAP", "KMEANS_REDUCE"):
        assert getattr(tjobs, name) == getattr(jjobs, name)


# --- the admission-policy testbed (tests/test_service.py) -----------------------------


def test_admission_sim_priority_mirrors_service():
    """A priority job among the arrived prefix admits first; one that has not
    arrived yet changes nothing; the makespan is unchanged either way."""
    sim = AdmissionSim(max_concurrent=1, min_chunk=8, max_chunk=8)
    jobs = [SimJob(0.0, 4096, 8), SimJob(0.0, 4096, 8), SimJob(0.0, 4096, 8, priority=1)]
    flat = [dc_replace(j, priority=0) for j in jobs]
    r, r_flat = sim.run(jobs, "bucketed"), sim.run(flat, "bucketed")
    lat, lat_flat = r["per_job_latency_s"], r_flat["per_job_latency_s"]
    assert lat[2] < lat[0] < lat[1]
    assert lat[2] < lat_flat[2]
    assert r["makespan_s"] == pytest.approx(r_flat["makespan_s"])
    late = [SimJob(0.0, 4096, 8), SimJob(0.0, 4096, 8), SimJob(1e6, 4096, 8, priority=1)]
    late_flat = [dc_replace(j, priority=0) for j in late]
    assert sim.run(late, "bucketed") == sim.run(late_flat, "bucketed")


def test_admission_sim_bucketed_beats_compile_per_job():
    sim = AdmissionSim()
    for trace in (burst_trace(), straggler_trace()):
        bucketed = sim.run(trace, "bucketed")
        per_job = sim.run(trace, "compile-per-job")
        assert bucketed["makespan_s"] < per_job["makespan_s"]
        assert bucketed["compiles"] < per_job["compiles"]
        assert bucketed["mean_latency_s"] < per_job["mean_latency_s"]


def test_admission_sim_residency_cap_evicts():
    capped = AdmissionSim(max_resident=2)
    r = capped.run(burst_trace(), "bucketed")
    assert r["evictions"] > 0
    assert r["resident"] <= 2
    unbounded = AdmissionSim().run(burst_trace(), "bucketed")
    assert r["compiles"] >= unbounded["compiles"]


@pytest.mark.parametrize("policy", ["bucketed", "compile-per-job"])
def test_admission_sim_replays_as_the_reference(policy):
    """Both packages' AdmissionSim give the same replay of the same traces,
    bucketing with their own `bucket_for` (the same ladder)."""
    for kw in ({}, {"max_resident": 2}, {"max_concurrent": 1, "min_chunk": 8, "max_chunk": 8}):
        for trace, jtrace in ((burst_trace(), jsim.burst_trace()),
                              (straggler_trace(), jsim.straggler_trace())):
            assert [vars(j) for j in trace] == [vars(j) for j in jtrace]
            assert AdmissionSim(**kw).run(trace, policy) == \
                jsim.AdmissionSim(**kw).run(jtrace, policy)
