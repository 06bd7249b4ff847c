"""The port's cluster runtime: the reference's eight tests
(`tests/test_runtime.py`) on `repro_torch.runtime`, and the same jobs
through both packages' simulated clusters giving the same results and the
same virtual times.

The cluster k-means is held to the port's device-level k-means step
(`repro_torch.core.kmeans.make_kmeans_step`) on the CPU, at the reference
test's rtol 1e-4 and atol 1e-5.
"""

import numpy as np
import pytest
import torch

from repro.runtime import jobs as jjobs
from repro_torch import VirtualMesh
from repro_torch.core.kmeans import generate_points, make_kmeans_step
from repro_torch.runtime.jobs import (
    WORDCOUNT_MAP,
    WORDCOUNT_REDUCE,
    make_cluster,
    run_kmeans,
    run_wordcount,
)
from repro_torch.runtime.node import MapReduceJob, SecurityPolicy

LINES = [
    "the quick brown fox jumps over the lazy dog",
    "the dog barks",
    "a quick fox",
    "lazy lazy dog",
] * 4


def _expected_counts(lines):
    want = {}
    for ln in lines:
        for w in ln.split():
            want[w] = want.get(w, 0) + 1
    return want


@pytest.mark.parametrize(
    "policy",
    [SecurityPolicy(encryption=True, enclave=True), SecurityPolicy(encryption=False, enclave=False)],
)
def test_wordcount_end_to_end(policy):
    cluster, client, _ = make_cluster(8, policy=policy)
    counts, info = run_wordcount(cluster, client, LINES, n_mappers=5, n_reducers=3)
    assert counts == _expected_counts(LINES)
    assert info["elapsed"] > 0
    assert cluster.router.stats.publications > 20


def test_wordcount_secure_matches_plain():
    c1, cl1, _ = make_cluster(6, policy=SecurityPolicy(True, True))
    r1, _ = run_wordcount(c1, cl1, LINES, 4, 2)
    c2, cl2, _ = make_cluster(6, policy=SecurityPolicy(False, False))
    r2, _ = run_wordcount(c2, cl2, LINES, 4, 2)
    assert r1 == r2


def test_kmeans_cluster_matches_device_engine():
    pts, _ = generate_points(240, 4, d=2, seed=2)
    cluster, client, _ = make_cluster(7)
    centers, hist = run_kmeans(cluster, client, pts, 4, n_mappers=4, n_reducers=2, max_iter=3,
                               threshold=0.0)
    # the port's device-level step, one iteration at a time, from the same init
    step = make_kmeans_step(VirtualMesh(1, "cpu"))
    ref = torch.from_numpy(pts[:4])
    w = torch.ones(len(pts))
    for _ in range(len(hist)):
        ref, _ = step(torch.from_numpy(pts), w, ref)
    np.testing.assert_allclose(centers, ref.numpy(), rtol=1e-4, atol=1e-5)


def test_mapper_failure_recovery():
    cluster, client, workers = make_cluster(10)
    job = MapReduceJob(job_id="wcf", map_source=WORDCOUNT_MAP, reduce_source=WORDCOUNT_REDUCE,
                       data=LINES, n_mappers=5, n_reducers=3)
    client.submit(job)
    cluster.kill_at("w0", 0.0005)
    cluster.run_until(lambda: "wcf" in client.completed)
    assert client.completed["wcf"]["pairs"]
    assert dict(client.completed["wcf"]["pairs"]) == _expected_counts(LINES)


def test_reducer_failure_recovery():
    cluster, client, workers = make_cluster(10)
    job = MapReduceJob("wcr", WORDCOUNT_MAP, WORDCOUNT_REDUCE, LINES, 4, 3)
    client.submit(job)
    cluster.run(until=0.01)
    reducers = [w for w in client._jobs["wcr"]["reducers"] if w]
    cluster.kill_at(reducers[0], 0.011)
    cluster.run_until(lambda: "wcr" in client.completed)
    assert dict(client.completed["wcr"]["pairs"]) == _expected_counts(LINES)


def test_straggler_backup_task():
    cluster, client, workers = make_cluster(8, speeds={"w0": 1e-4})
    job = MapReduceJob("wcs", WORDCOUNT_MAP, WORDCOUNT_REDUCE, LINES * 4, 4, 2)
    client.submit(job)
    cluster.run_until(lambda: "wcs" in client.completed)
    assert dict(client.completed["wcs"]["pairs"]) == _expected_counts(LINES * 4)
    assert any(sp["backup"] for sp in client._jobs["wcs"]["splits"].values())


def test_rogue_worker_not_hired():
    cluster, client, workers = make_cluster(8, rogue={"w0", "w1"})
    job = MapReduceJob("wca", WORDCOUNT_MAP, WORDCOUNT_REDUCE, LINES, 4, 2)
    client.submit(job)
    cluster.run_until(lambda: "wca" in client.completed)
    st = client._jobs["wca"]
    hired = set(st["mappers"]) | set(st["reducers"])
    assert "w0" not in hired and "w1" not in hired
    assert dict(client.completed["wca"]["pairs"]) == _expected_counts(LINES)


def test_router_confidentiality():
    """The router sees only ciphertext payloads; with encryption off it would
    see the words (negative control)."""
    def payloads(policy, job_id):
        c, cl, _ = make_cluster(6, policy=policy)
        seen = []
        orig = c.router.publish

        def spy(msg):
            seen.append(bytes(msg.payload_ct))
            return orig(msg)

        c.router.publish = spy
        run_wordcount(c, cl, LINES, 4, 2, job_id=job_id)
        return seen

    assert any(b"quick" in p for p in payloads(SecurityPolicy(False, False), "wc2"))
    assert not any(b"quick" in p for p in payloads(SecurityPolicy(True, True), "wc3"))


@pytest.mark.parametrize("secure", [True, False], ids=["secure", "plain"])
def test_wordcount_runs_as_the_reference_cluster(secure):
    """The same word count through both packages' clusters: the same counts,
    virtual times and message counts."""
    c, cl, _ = make_cluster(7, policy=SecurityPolicy(secure, secure))
    jc, jcl, _ = jjobs.make_cluster(7, policy=jjobs.SecurityPolicy(secure, secure))
    got = run_wordcount(c, cl, LINES, 4, 3)
    want = jjobs.run_wordcount(jc, jcl, LINES, 4, 3)
    assert got[0] == want[0] and got[1]["elapsed"] == want[1]["elapsed"]
    assert (c.now, c.delivered_messages) == (jc.now, jc.delivered_messages)


def test_kmeans_runs_as_the_reference_cluster():
    """The same cluster k-means through both packages: the same centres bit
    for bit, the same shift history and virtual times."""
    pts, _ = generate_points(48, 3, d=2, seed=6)
    c, cl, _ = make_cluster(5)
    jc, jcl, _ = jjobs.make_cluster(5)
    tc, th = run_kmeans(c, cl, pts, 3, n_mappers=2, n_reducers=2, max_iter=2, threshold=0.0)
    jcen, jh = jjobs.run_kmeans(jc, jcl, pts, 3, n_mappers=2, n_reducers=2, max_iter=2,
                                threshold=0.0)
    np.testing.assert_array_equal(tc, jcen)
    assert len(th) == 2
    assert [(h["shift"], h["elapsed"]) for h in th] == [(h["shift"], h["elapsed"]) for h in jh]
