"""Canonical jobs: the paper's word count (Listings 1-2) and k-means (§V).

Counterpart of `repro/runtime/jobs.py`; the four script sources are the
reference's, verbatim.

The sources below are the direct analogues of the paper's Lua scripts — the
same special functions (`map`, `combine`, `hash`, `reduce`), the same
framework-provided `push(key, value)`, shipped encrypted and exec'd only
inside the worker.
"""

from __future__ import annotations

import numpy as np

from repro_torch.crypto.keys import KeyHierarchy
from repro_torch.runtime.node import Client, MapReduceJob, SecurityPolicy, Worker
from repro_torch.runtime.sim import Cluster, TimingModel

# --- word count (paper Listings 1 & 2, ~20 LOC of user code) -----------------

WORDCOUNT_MAP = """
def map(key, value):
    for word in value.split():
        push(word, 1)

def combine(key, values):
    push(key, sum(values))

def hash(key, rcount):
    return ord(str(key)[0]) % rcount
"""

WORDCOUNT_REDUCE = """
def reduce(key, values):
    push(key, sum(values))
"""

# --- k-means (paper §III fig 1, §V) -------------------------------------------

KMEANS_MAP = """
def map(key, value):
    # value: [x, y]; consts["centers"]: [[cx, cy], ...]
    best, best_d = 0, None
    for i, c in enumerate(consts["centers"]):
        d = 0.0
        for a, b in zip(value, c):
            d += (a - b) * (a - b)
        if best_d is None or d < best_d:
            best, best_d = i, d
    push(best, value + [1.0])

def combine(key, values):
    acc = [0.0] * len(values[0])
    for v in values:
        for i, x in enumerate(v):
            acc[i] += x
    push(key, acc)

def hash(key, rcount):
    return int(key) % rcount
"""

KMEANS_REDUCE = """
def reduce(key, values):
    acc = [0.0] * len(values[0])
    for v in values:
        for i, x in enumerate(v):
            acc[i] += x
    n = max(acc[-1], 1e-9)
    push(key, [a / n for a in acc[:-1]])
"""


def make_cluster(
    n_workers: int,
    *,
    master: bytes = b"\x42" * 32,
    policy: SecurityPolicy | None = None,
    timing: TimingModel | None = None,
    speeds: dict[str, float] | None = None,
    rogue: set[str] | None = None,
):
    """Stand up client + router + workers; returns (cluster, client, workers)."""
    policy = policy or SecurityPolicy()
    kh = KeyHierarchy(master=master)
    kh.attestation.enroll(b"worker-code-v1")
    cluster = Cluster(header_key=kh.session.header, timing=timing)
    client = cluster.add(Client("client", kh, policy=policy))
    workers = []
    for i in range(n_workers):
        name = f"w{i}"
        identity = b"evil-code" if rogue and name in rogue else b"worker-code-v1"
        w = cluster.add(
            Worker(
                name,
                kh.session,
                speed=(speeds or {}).get(name, 1.0),
                code_identity=identity,
                policy=policy,
            )
        )
        w.start()
        workers.append(w)
    return cluster, client, workers


def run_wordcount(cluster: Cluster, client: Client, lines: list[str],
                  n_mappers: int, n_reducers: int, job_id: str = "wc"):
    job = MapReduceJob(
        job_id=job_id,
        map_source=WORDCOUNT_MAP,
        reduce_source=WORDCOUNT_REDUCE,
        data=lines,
        n_mappers=n_mappers,
        n_reducers=n_reducers,
    )
    client.submit(job)
    cluster.run_until(lambda: job_id in client.completed)
    return dict(client.completed[job_id]["pairs"]), client.completed[job_id]


def run_kmeans(cluster: Cluster, client: Client, points: np.ndarray, k: int,
               *, n_mappers: int, n_reducers: int, max_iter: int = 50,
               threshold: float | None = None, job_prefix: str = "km"):
    """Iterated MapReduce k-means with the paper's diag/1000 stop rule."""
    pts = [list(map(float, p)) for p in np.asarray(points)]
    centers = [list(map(float, p)) for p in np.asarray(points)[:k]]
    if threshold is None:
        lo, hi = np.min(points, axis=0), np.max(points, axis=0)
        threshold = float(np.linalg.norm(hi - lo)) / 1000.0

    history = []
    for it in range(max_iter):
        jid = f"{job_prefix}{it}"
        job = MapReduceJob(
            job_id=jid,
            map_source=KMEANS_MAP,
            reduce_source=KMEANS_REDUCE,
            data=pts,
            n_mappers=n_mappers,
            n_reducers=n_reducers,
            consts={"centers": centers},
        )
        client.submit(job)
        cluster.run_until(lambda: jid in client.completed)
        new = dict(client.completed[jid]["pairs"])
        new_centers = [new.get(i, centers[i]) for i in range(k)]
        shift = float(
            np.mean(np.linalg.norm(np.array(new_centers) - np.array(centers), axis=1))
        )
        history.append(
            {"iter": it, "shift": shift, "elapsed": client.completed[jid]["elapsed"]}
        )
        centers = new_centers
        if shift < threshold:
            break
    return np.array(centers, np.float32), history
