"""Deterministic virtual-time cluster simulation.

Counterpart of `repro/runtime/sim.py`; its admission replay buckets jobs
with the port's `repro_torch.serve.service.bucket_for`.

Entities exchange messages only through the SCBR router; the simulator
charges virtual time for network transfer, per-message enclave transitions,
cipher streaming, and enclave paging (via each worker's SecurePager). Wall
time is also tracked for the real crypto work (the ciphers actually run).

Determinism: a single event heap ordered by (time, seq); no wall-clock
dependence in control flow, so failure/straggler tests are reproducible.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.pubsub.messages import Message
from repro_torch.pubsub.router import ScbrRouter


@dataclass
class TimingModel:
    """Virtual-time cost constants (calibrated to paper-era hardware).

    The compile-vs-steady split models the serving cost structure measured
    by `benchmarks/bench_service.py`: tracing + XLA-compiling one fused
    round program (`xla_compile_s`, tens of seconds on the secure path)
    against the per-chunk host round trip (`dispatch_s`) and the per-round
    map/shuffle/reduce work — the asymmetry the size-bucketed runner cache
    exists to exploit (`repro_torch.serve.service`).
    """

    net_latency_s: float = 100e-6
    net_bw_bytes_s: float = 1.0e9  # 10 GbE-ish
    enclave_call_s: float = 4.0e-6  # ECALL/OCALL round trip
    crypto_bw_bytes_s: float = 2.0e9  # AES-CTR/ChaCha20 software stream
    item_cost_s: float = 2.0e-7  # per (key,value) map/reduce work
    epc_budget_bytes: int = 32 * 1024 * 1024  # usable trusted memory per worker
    xla_compile_s: float = 30.0  # trace + compile ONE fused-round program
    dispatch_s: float = 200e-6  # host->device round trip per chunk dispatch

    def net_delay(self, nbytes: int) -> float:
        return self.net_latency_s + nbytes / self.net_bw_bytes_s

    def crypto_delay(self, nbytes: int) -> float:
        return nbytes / self.crypto_bw_bytes_s

    def round_delay(self, n_local_items: int, item_bytes: int = 8) -> float:
        """Steady-state cost of ONE executed round on one shard's slice."""
        nbytes = n_local_items * item_bytes
        return (self.enclave_call_s + n_local_items * self.item_cost_s
                + self.crypto_delay(nbytes) + self.net_delay(nbytes))


class Entity:
    name: str = "?"
    alive: bool = True

    def attach(self, cluster: "Cluster"):
        self.cluster = cluster

    def on_message(self, msg: Message):  # pragma: no cover - interface
        raise NotImplementedError


class Cluster:
    def __init__(self, header_key: bytes, timing: TimingModel | None = None):
        self.router = ScbrRouter(header_key)
        self.timing = timing or TimingModel()
        self.now = 0.0
        self._events: list = []
        self._seq = itertools.count()
        self.entities: dict[str, Entity] = {}
        self.delivered_messages = 0
        self._fifo: dict[tuple[str, str], float] = {}  # per-channel FIFO (ZeroMQ/TCP)

    # -- entity / event plumbing ------------------------------------------------

    def add(self, entity: Entity):
        self.entities[entity.name] = entity
        entity.attach(self)
        return entity

    def schedule(self, delay: float, fn: Callable, *args):
        heapq.heappush(self._events, (self.now + delay, next(self._seq), fn, args))

    def publish(self, msg: Message, extra_delay: float = 0.0, stream: str = "data"):
        """Entity -> router -> matching outboxes, with per-target delivery events.

        Deliveries on one (sender, target, stream) channel preserve publish
        order — the FIFO guarantee a ZeroMQ/TCP connection gives the paper's
        protocol (EOS must not overtake the data that precedes it). Control
        traffic (heartbeats) uses its own stream so a busy worker's data queue
        cannot head-of-line-block its liveness signal.
        """
        targets = self.router.publish(msg)
        for t in targets:
            at = self.now + self.timing.net_delay(msg.wire_bytes) + extra_delay
            chan = (msg.sender, t, stream)
            at = max(at, self._fifo.get(chan, 0.0) + 1e-9)
            self._fifo[chan] = at
            self.schedule(at - self.now, self._deliver, t, msg)
        return targets

    def _deliver(self, target: str, msg: Message):
        e = self.entities.get(target)
        if e is None or not e.alive:
            return  # dropped on the floor — failure detector handles it
        self.delivered_messages += 1
        e.on_message(msg)

    def run(self, until: float | None = None, max_events: int = 2_000_000):
        """Process events up to virtual time `until` (periodic control-plane
        events — heartbeats, liveness checks — keep the queue nonempty, so an
        unbounded run only makes sense via `run_until`)."""
        n = 0
        while self._events and n < max_events:
            t, _, fn, args = heapq.heappop(self._events)
            if until is not None and t > until:
                self.now = until
                heapq.heappush(self._events, (t, next(self._seq), fn, args))
                return
            self.now = max(self.now, t)
            fn(*args)
            n += 1
        if n >= max_events:
            raise RuntimeError("event budget exhausted — livelock?")

    def run_until(self, predicate: Callable[[], bool], t_max: float = 300.0,
                  max_events: int = 5_000_000) -> bool:
        """Run until `predicate()` holds. Raises on virtual-time/event budget."""
        n = 0
        while self._events and n < max_events:
            if predicate():
                return True
            t, _, fn, args = heapq.heappop(self._events)
            if t > t_max:
                raise TimeoutError(f"virtual time budget {t_max}s exhausted at t={t:.3f}")
            self.now = max(self.now, t)
            fn(*args)
            n += 1
        if predicate():
            return True
        raise RuntimeError("event queue drained/budget exhausted before completion")

    # -- fault injection ---------------------------------------------------------

    def kill_at(self, name: str, t: float):
        self.schedule(max(0.0, t - self.now), self._kill, name)

    def _kill(self, name: str):
        e = self.entities.get(name)
        if e is not None:
            e.alive = False
            self.router.unsubscribe_all(name)


# -- admission-policy testbed ----------------------------------------------------
#
# Virtual-time replay of the serving scheduler (`repro_torch.serve.service`) against
# the TimingModel's compile-vs-steady cost split, so admission policies can be
# compared deterministically without a device: same FIFO admission into
# `max_concurrent` slots, same round-robin one-chunk-per-job dispatch, same
# geometric chunk ladder — only the runner-cache policy varies.


@dataclass
class SimJob:
    """One job in an arrival trace (sizes in items, budget in rounds).

    `priority > 0` jobs admit ahead of the normal FIFO class, mirroring
    `SecureJobService.submit_*(priority=...)`; active jobs are never
    preempted."""

    arrival_s: float
    n_items: int
    n_rounds: int
    kind: str = "kmeans"
    priority: int = 0


def burst_trace(n_jobs: int = 16, *, base_items: int = 4096, jitter: float = 0.3,
                n_rounds: int = 8, seed: int = 0) -> list[SimJob]:
    """A burst: `n_jobs` near-simultaneous arrivals with sizes jittered
    around `base_items` — the regime where size buckets collapse many
    distinct sizes onto few compiled programs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = base_items * rng.uniform(1.0 - jitter, 1.0 + jitter, size=n_jobs)
    return [SimJob(arrival_s=1e-3 * i, n_items=max(1, int(s)), n_rounds=n_rounds)
            for i, s in enumerate(sizes)]


def straggler_trace(n_jobs: int = 12, *, base_items: int = 4096,
                    period_s: float = 2.0, straggler_factor: int = 32,
                    straggler_rounds: int = 32, n_rounds: int = 8,
                    seed: int = 1) -> list[SimJob]:
    """Steady arrivals with ONE straggler (`straggler_factor`x bigger,
    `straggler_rounds` rounds) mid-trace — the head-of-line-blocking regime
    the round-robin chunk interleave is meant to survive."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n_jobs):
        size = max(1, int(base_items * rng.uniform(0.8, 1.2)))
        rounds = n_rounds
        if i == n_jobs // 2:
            size *= straggler_factor
            rounds = straggler_rounds
        jobs.append(SimJob(arrival_s=period_s * i, n_items=size, n_rounds=rounds))
    return jobs


class AdmissionSim:
    """Deterministic virtual-time testbed for service admission policies.

    `run(jobs, policy)` replays an arrival trace through the serving
    scheduler's exact control flow and returns makespan / latency / cache
    statistics. Policies:

      * 'bucketed'        — the shipped policy: inputs pad to geometric size
        buckets (`repro_torch.serve.service.bucket_for`) and a (kind, bucket,
        chunk) program compiles ONCE process-wide;
      * 'compile-per-job' — the pre-service behavior: every job compiles
        every chunk size it dispatches, no sharing (the ad-hoc per-call
        runner dict).

    The simulated device serves one chunk at a time (the service's single
    dispatch thread); compiles also serialize on it, which is exactly the
    cold-start convoy the bucketed cache removes.
    """

    POLICIES = ("bucketed", "compile-per-job")

    def __init__(self, timing: TimingModel | None = None, *, n_shards: int = 8,
                 max_concurrent: int = 4, bucket_growth: float = 2.0,
                 max_resident: int | None = None,
                 min_chunk: int = 1, max_chunk: int = 8,
                 chunk_growth: int = 2):
        self.timing = timing or TimingModel()
        self.n_shards = n_shards
        self.max_concurrent = max_concurrent
        self.bucket_growth = bucket_growth
        self.max_resident = max_resident  # LRU program-cache cap (None = unbounded)
        self.min_chunk = max(1, min_chunk)
        self.max_chunk = max(self.min_chunk, max_chunk)
        self.chunk_growth = max(1, chunk_growth)  # geometric ladder factor

    def run(self, jobs: list[SimJob], policy: str = "bucketed") -> dict:
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, got {policy!r}")
        from repro_torch.serve.service import bucket_for

        from collections import OrderedDict

        order = sorted(range(len(jobs)), key=lambda i: (jobs[i].arrival_s, i))
        waiting = [(jobs[i], i) for i in order]
        active: list[dict] = []
        compiled: OrderedDict = OrderedDict()  # LRU, like RunnerCache
        t = 0.0
        hits = misses = evictions = 0
        latency = [0.0] * len(jobs)

        while waiting or active:
            if not active and waiting and waiting[0][0].arrival_s > t:
                t = waiting[0][0].arrival_s
            while waiting and len(active) < self.max_concurrent \
                    and waiting[0][0].arrival_s <= t:
                # two-level admission (mirrors SecureJobService): among the
                # ARRIVED prefix, high-priority jobs drain first, FIFO within
                # each class; active jobs are never preempted.
                n_arrived = 0
                while (n_arrived < len(waiting)
                       and waiting[n_arrived][0].arrival_s <= t):
                    n_arrived += 1
                k = next((k for k in range(n_arrived)
                          if waiting[k][0].priority > 0), 0)
                job, idx = waiting.pop(k)
                n_padded = (bucket_for(job.n_items, multiple=self.n_shards,
                                       growth=self.bucket_growth)
                            if policy == "bucketed" else job.n_items)
                active.append({"job": job, "idx": idx, "done": 0,
                               "chunk": self.min_chunk, "n_padded": n_padded})
            # round-robin: ONE chunk per active job per pass
            for st in list(active):
                job = st["job"]
                n = min(st["chunk"], job.n_rounds - st["done"])
                key = ((job.kind, st["n_padded"], n) if policy == "bucketed"
                       else (st["idx"], n))
                if key in compiled:
                    hits += 1
                    compiled.move_to_end(key)
                else:
                    compiled[key] = True
                    misses += 1
                    t += self.timing.xla_compile_s
                    if self.max_resident is not None:
                        while len(compiled) > self.max_resident:
                            compiled.popitem(last=False)
                            evictions += 1
                n_local = -(-st["n_padded"] // self.n_shards)
                t += self.timing.dispatch_s + n * self.timing.round_delay(n_local)
                st["done"] += n
                st["chunk"] = min(st["chunk"] * self.chunk_growth, self.max_chunk)
                if st["done"] >= job.n_rounds:
                    active.remove(st)
                    latency[st["idx"]] = t - job.arrival_s

        return {
            "policy": policy,
            "makespan_s": t,
            "mean_latency_s": sum(latency) / len(latency) if latency else 0.0,
            "max_latency_s": max(latency) if latency else 0.0,
            "per_job_latency_s": latency,
            "compiles": misses,
            "resident": len(compiled),
            "hits": hits,
            "misses": misses,
            "evictions": evictions,
        }
