"""Persistent-mesh secure job service: bucketed runner cache + batched admission.

Counterpart of `repro/serve/service.py`. The paper's deployment is a
long-lived cluster: the enclave session is set up once and many jobs flow
through it. The entry points (`kmeans_fit`, `sample_sort`, `grep_count`) run
their rounds eagerly, about a hundred small launches each; the service keeps
what a job needs to run its rounds from cached CUDA graphs:

  * `RunnerCache` -- one keyed LRU cache of the driver's chunk runners
    (`repro_torch.core.driver.make_iterative_runner`: on the card a captured
    CUDA graph of one round, on the CPU the eager chunk), keyed by workload
    identity x padded input bucket x mesh x secure key material x knobs x
    chunk size. It serves `run_until(runners=...)` through the driver's
    `get_or_build(n_rounds, build)` contract, counts hits, misses and
    evictions, bounds residency with an LRU cap, and reports the graphs its
    runners captured (`captures`) and their pools' bytes. The same cap
    bounds the input shapes whose static buffers and captures the graph
    runners keep on the card (`driver.ShapeBudget`).

  * GEOMETRIC SIZE BUCKETS -- `bucket_for` rounds every job's input length up
    a fixed ladder (x growth, default 2, aligned to the mesh), so a job of
    1.1xN pads to the 2xN bucket an earlier job captured and replays its
    graph instead of capturing a new one. Padding is inert: k-means pads
    rows of weight 0, sort pads +inf (never shuffled), grep pads -1 tokens
    (match no pattern). Padding is done on the mesh's device.

  * `SecureJobService` -- owns one mesh and one `SecureShuffleConfig` for
    its lifetime and serves concurrent k-means / sort / grep jobs.
    `submit_*()` checks its arguments and returns a future-backed
    `JobHandle`; one scheduler thread admits queued jobs (priority class
    first, FIFO within a class) into free slots and round-robins ONE chunk
    per active job per pass through the driver's `run_until_chunks`
    generators. Every device operation of a job runs on that thread, from
    the padding to the result's copy back. Interleaving is bit-identical
    to serial execution: each suspended generator owns its carried state,
    and each job draws from a disjoint keystream range -- admission gives it
    a round BASE from a monotone counter advanced by its `max_rounds`.

The growth factor and the residency cap resolve as the reference's do:
an explicit argument, else $REPRO_BUCKET_GROWTH / $REPRO_SERVICE_MAX_RUNNERS,
else the calibrated cost model (`repro_torch.perf.model`), else 2.0 and
unbounded; a sort job's capacity is the model's `sort_capacity` answer, else
the bucket's lossless worst case. Each is resolved once per service, cache
or job. The cache reports graph captures where the reference counts XLA
compiles.

Keystream reuse. A fresh service starts its round bases at 0, as the
reference's does, so two services (or two processes) given the same
`SecureShuffleConfig` key draw the same keystream ranges: a two-time pad
between their jobs. Give each session its own key, as the reference does
with `KeyHierarchy` (`repro_torch.crypto.keys.KeyHierarchy.new_session`,
then `repro_torch.convert.secure_config` on the session's key).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.driver import ShapeBudget, resolve_state_mode, run_until_chunks
from repro_torch.core.grep import make_grep_spec
from repro_torch.core.kmeans import make_kmeans_iterative_spec, paper_threshold
from repro_torch.core.shuffle import SecureShuffleConfig, resolve_coalesce
from repro_torch.core.sort import make_sample_sort_spec
from repro_torch.perf.model import recommendation
from repro_torch.tools.opcount import spans

BUCKET_GROWTH_ENV = "REPRO_BUCKET_GROWTH"
MAX_RUNNERS_ENV = "REPRO_SERVICE_MAX_RUNNERS"


def resolve_bucket_growth(growth=None) -> float:
    """Resolve the geometric bucket-ladder growth factor (a float > 1).

    None/'auto' defers to $REPRO_BUCKET_GROWTH, then to the calibrated cost
    model when one is active (the factor minimizing AdmissionSim makespan
    under the calibrated TimingModel), then to the default 2.0; an explicit
    number always wins over the environment.
    """
    from_env = False
    if growth in (None, "auto"):
        env_val = os.environ.get(BUCKET_GROWTH_ENV)
        if env_val is None:
            rec = recommendation("bucket_growth")
            if rec is None:
                return 2.0
            growth = rec
        else:
            growth, from_env = env_val.strip(), True
    try:
        val = float(growth)
    except (TypeError, ValueError):
        val = float("nan")
    if not val > 1.0:
        if from_env:
            raise ValueError(
                f"invalid ${BUCKET_GROWTH_ENV}={growth!r} in the environment: "
                f"bucket growth must be a number > 1 "
                f"(unset ${BUCKET_GROWTH_ENV} to use the default 2.0)")
        raise ValueError(f"bucket growth must be a number > 1 or 'auto', got {growth!r}")
    return val


def resolve_max_resident(limit="auto") -> int | None:
    """Resolve the runner-cache residency cap (int >= 1, or None = unbounded).

    'auto' defers to $REPRO_SERVICE_MAX_RUNNERS, then to the calibrated cost
    model when one is active (which answers 'unbounded'), then to the
    default unbounded; 0, 'none' and 'unbounded' mean unbounded explicitly,
    and an explicit int or None always wins over the environment.
    """
    from_env = False
    if limit == "auto":
        env_val = os.environ.get(MAX_RUNNERS_ENV)
        if env_val is None:
            rec = recommendation("max_resident")
            if rec is None or rec == "unbounded":
                return None
            limit = rec
        else:
            limit, from_env = env_val.strip().lower(), True
    if limit is None or limit in ("none", "unbounded", "0", 0):
        return None
    try:
        val = int(limit)
    except (TypeError, ValueError):
        val = 0
    if val < 1:
        if from_env:
            raise ValueError(
                f"invalid ${MAX_RUNNERS_ENV}={limit!r} in the environment: "
                f"the resident-runner cap must be an integer >= 1, or 0/'none' for "
                f"unbounded (unset ${MAX_RUNNERS_ENV} to use the default unbounded)")
        raise ValueError(f"max_resident must be an integer >= 1, None, or 'auto', "
                         f"got {limit!r}")
    return val


def bucket_for(n: int, *, multiple: int = 1, growth=None) -> int:
    """Round `n` up to the geometric bucket ladder.

    The ladder starts at `multiple` (every bucket divides evenly over the
    shards) and each rung is the previous one x`growth`, rounded up to the
    next `multiple`. The rungs depend only on (multiple, growth), never on
    `n`, so every size in (rung_{i-1}, rung_i] shares rung i's runners.
    """
    growth = resolve_bucket_growth(growth)
    if n < 1:
        raise ValueError(f"bucket_for needs n >= 1, got {n}")
    if multiple < 1:
        raise ValueError(f"bucket_for needs multiple >= 1, got {multiple}")
    b = multiple
    while b < n:
        # strictly increasing even when growth barely clears the alignment
        b = max(int(math.ceil(b * growth / multiple)) * multiple, b + multiple)
    return b


def _mesh_token(mesh) -> tuple:
    return (mesh.n_shards, str(mesh.device))


def _secure_token(secure: SecureShuffleConfig | None, coalesce) -> tuple:
    """Hashable identity of the secure wire a runner was built against.

    Key, nonce and counter0 are baked into a captured graph's launches, so
    they key the cache: two sessions with different keys never share a
    runner. So do the keystream impl and the wire layout, resolved so
    'auto' never aliases a concrete layout.
    """
    if secure is None:
        return ("plain", resolve_coalesce("auto" if coalesce is None else coalesce))
    secure = secure.with_coalesce(coalesce)
    return (np.asarray(secure.key_words, np.uint32).tobytes(),
            np.asarray(secure.nonce_words, np.uint32).tobytes(),
            int(secure.counter0), secure.impl, resolve_coalesce(secure.coalesce))


class _CacheView:
    """`run_until(runners=...)` adapter bound to one fully resolved key base.

    `get_or_build(n_rounds, build)` calls `build` (closed over the caller's
    spec, mesh and secure) only on a miss; the key base pins everything the
    closure bakes in.
    """

    def __init__(self, cache: "RunnerCache", key_base: tuple):
        self.cache = cache
        self.key_base = key_base

    def get_or_build(self, n_rounds: int, build):
        return self.cache.get_or_build(self.key_base + (int(n_rounds),), build)


class RunnerCache:
    """Keyed LRU cache of the driver's chunk runners.

    Keys are (spec identity x mesh x secure material x chunk size) tuples
    assembled by `view(...)`; values are `make_iterative_runner` runners.
    `max_resident` bounds residency (least recently used out first); hits,
    misses and evictions are counted, and `captures()` sums the CUDA graphs
    the resident runners captured: a warm submit leaves it unchanged.
    `max_resident` also bounds the shapes of inputs and state whose static
    buffers (`_Statics`, with their captures) the graph runners keep on the
    card, counted over the whole cache (`shape_budget`, handed to every
    runner built here): the least recently used shape goes first, never one
    that a thread is replaying. An evicted runner's captures are freed at
    once, and so are its job's statics once no resident runner shares them
    (the budget refers to them weakly); `clear()` frees them all.
    """

    def __init__(self, max_resident="auto"):
        self.max_resident = resolve_max_resident(max_resident)
        self.shape_budget = ShapeBudget(self.max_resident)
        self._runners: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def view(self, *, spec_id, mesh, secure: SecureShuffleConfig | None = None,
             coalesce=None) -> _CacheView:
        """Bind a key base; returns the `get_or_build` view `run_until` takes.

        `spec_id` is the caller's workload identity (workload name and the
        static shape and knob facts, e.g. ("kmeans", k, d, bucket));
        mesh, secure material and knobs are folded in here. The view only
        keys: the runner is built by the driver's `build` closure, which must
        come from the same arguments (`make_kmeans_runner(cache=...)` and
        `SecureJobService` make sure of it).
        """
        return _CacheView(self, (spec_id, _mesh_token(mesh),
                                 _secure_token(secure, coalesce)))

    def get_or_build(self, key, build):
        with self._lock:
            runner = self._runners.get(key)
            if runner is not None:
                self.hits += 1
                self._runners.move_to_end(key)
                return runner
            self.misses += 1
            runner = self._runners[key] = build()
            bound = getattr(runner, "keep_shapes_within", None)  # a graph runner
            if bound is not None:
                bound(self.shape_budget)
            if self.max_resident is not None:
                while len(self._runners) > self.max_resident:
                    _drop(self._runners.popitem(last=False)[1])
                    self.evictions += 1
            return runner

    def keys(self):
        with self._lock:
            return list(self._runners.keys())

    def __len__(self):
        with self._lock:
            return len(self._runners)

    def _resident(self):
        with self._lock:
            return list(self._runners.values())

    def captures(self) -> int:
        """CUDA graphs captured by the resident runners (0 on a CPU mesh)."""
        return sum(r.captures for r in self._resident())

    def pool_bytes(self) -> int:
        """Device bytes those captures added to the graph pools."""
        return sum(r.pool_bytes for r in self._resident())

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                    "resident": len(self._runners), "max_resident": self.max_resident,
                    "shapes": len(self.shape_budget),
                    "shape_evictions": self.shape_budget.evictions,
                    "captures": self.captures(), "pool_bytes": self.pool_bytes()}

    def clear(self):
        with self._lock:
            for runner in self._runners.values():
                _drop(runner)
            self._runners.clear()


def _drop(runner) -> None:
    """Free what an evicted runner holds on the card (a graph runner's captures)."""
    drop = getattr(runner, "drop_captures", None)
    if drop is not None:
        drop()


_default_cache: RunnerCache | None = None
_default_cache_lock = threading.Lock()


def default_runner_cache() -> RunnerCache:
    """The lazily created process-wide cache."""
    global _default_cache
    with _default_cache_lock:
        if _default_cache is None:
            _default_cache = RunnerCache()
        return _default_cache


@dataclass
class JobHandle:
    """Future-backed handle of a submitted job.

    `result(timeout)` blocks for the job's output (a dict of numpy values;
    see the `submit_*` docstrings). Times are `time.perf_counter()` stamps:
    `latency_s` spans submit -> finish, `queue_s` the wait before admission;
    `chunks` counts the chunks dispatched (each one a `service.chunk` span,
    `repro_torch.tools.opcount.spans`, while a sink is open).
    `runner_misses` counts the cache misses charged to THIS job: 0 means it
    ran on cached runners only (a warm job, which captures nothing).
    """

    job_id: int
    kind: str
    n: int
    bucket: int
    round_base: int
    max_rounds: int
    priority: int = 0
    future: Future = field(default_factory=Future, repr=False)
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    runner_misses: int = 0
    chunks: int = 0

    def result(self, timeout: float | None = None):
        return self.future.result(timeout)

    def done(self) -> bool:
        return self.future.done()

    @property
    def warm(self) -> bool:
        return self.runner_misses == 0

    @property
    def latency_s(self) -> float | None:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def queue_s(self) -> float | None:
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at


class _JobRunners:
    """A `_CacheView` that charges cache misses to one job (all dispatch runs
    on the scheduler thread, so the miss counter's delta is this job's)."""

    def __init__(self, view: _CacheView, handle: JobHandle):
        self._view = view
        self._handle = handle

    def get_or_build(self, n_rounds, build):
        before = self._view.cache.misses
        runner = self._view.get_or_build(n_rounds, build)
        self._handle.runner_misses += self._view.cache.misses - before
        return runner


class _Job:
    __slots__ = ("handle", "make_gen", "finalize", "gen")

    def __init__(self, handle, make_gen, finalize):
        self.handle = handle
        self.make_gen = make_gen
        self.finalize = finalize
        self.gen = None


def _shape_of(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _padded(x, bucket: int, fill, dtype, device) -> torch.Tensor:
    """`x` (numpy or tensor) on `device`, its leading dim padded to `bucket` with `fill`."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    out = torch.full((bucket,) + tuple(x.shape[1:]), fill, dtype=dtype, device=device)
    out[:x.shape[0]] = x
    return out


def _host_min_max(values):
    """(min, max) of f32 `values` as host floats."""
    if isinstance(values, torch.Tensor):
        lo, hi = torch.aminmax(values.to(torch.float32))
        return float(lo), float(hi)
    values = np.asarray(values, np.float32)
    return float(values.min()), float(values.max())


class SecureJobService:
    """Serve concurrent secure MapReduce jobs over ONE persistent mesh.

    The service owns its mesh and (optional) `SecureShuffleConfig` for its
    lifetime. `submit_kmeans` / `submit_sort` / `submit_grep` enqueue a job
    and return a `JobHandle` at once; one daemon scheduler thread

      1. ADMITS pending jobs (priority class first, FIFO within a class) into
         up to `max_concurrent` active slots,
      2. round-robins ONE chunk per active job per pass (the driver's
         `run_until_chunks` generators, each holding its job's state and
         round offset),
      3. resolves the job's future with its host-side result.

    Every job is padded to a geometric size bucket and runs on runners from
    the shared `RunnerCache`, so a warm-bucket submit captures nothing; every
    job gets a disjoint global-round range (a monotone `round_base` advanced
    by its `max_rounds`), so concurrent secure jobs never reuse keystream.
    Jobs submitted in the same order give bit-identical results at any
    concurrency, serial included. Services may share one `RunnerCache`: a
    graph runner's statics serve one thread at a time (`_Statics.lock`),
    and captures are taken one at a time.

    Spans (`repro_torch.tools.opcount.spans`), each of one job but the
    first carrying its `job_id` as `job`: `service.pass` (one pass over the
    active jobs), `service.prepare` (a job's set-up: threshold, padding,
    initial state), `service.chunk` (one chunk of one job) and
    `service.finish` (the result's copy to the host and the future).
    """

    def __init__(self, mesh, *, secure: SecureShuffleConfig | None = None,
                 coalesce: bool | None = None, cache: RunnerCache | None = None,
                 bucket_growth=None, max_concurrent: int = 4, min_chunk: int = 1,
                 max_chunk: int = 8):
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent must be >= 1, got {max_concurrent}")
        if secure is not None:
            # resolve the wire once: the cache's knob tuple is then concrete
            secure = secure.with_coalesce(coalesce)
        self.mesh = mesh
        self.secure = secure
        self.coalesce = coalesce
        self.cache = cache if cache is not None else RunnerCache()
        self.bucket_growth = resolve_bucket_growth(bucket_growth)
        self.max_concurrent = max_concurrent
        self.min_chunk = max(1, min_chunk)
        self.max_chunk = max(self.min_chunk, max_chunk)
        self.n_shards = mesh.n_shards
        self.state_mode = resolve_state_mode("auto")

        self._cv = threading.Condition()
        # two-level admission: priority > 0 jobs admit ahead of the FIFO
        # normal class; active jobs are never preempted
        self._pending: deque[_Job] = deque()
        self._pending_high: deque[_Job] = deque()
        self._active: list[_Job] = []
        self._next_id = 0
        self._round_base = 0
        self._jobs_completed = 0
        self._closed = False
        self._thread = threading.Thread(target=self._scheduler, name="secure-job-service",
                                        daemon=True)
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def close(self, wait: bool = True):
        """Stop admitting; drain queued and active jobs, then stop the thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if wait:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> dict:
        with self._cv:
            return {"jobs_completed": self._jobs_completed,
                    "jobs_active": len(self._active),
                    "jobs_pending": len(self._pending) + len(self._pending_high),
                    "round_base": self._round_base,
                    "cache": self.cache.stats()}

    # -- scheduler ---------------------------------------------------------

    def _scheduler(self):
        while True:
            with self._cv:
                while (not self._pending and not self._pending_high
                       and not self._active and not self._closed):
                    self._cv.wait()
                if (self._closed and not self._pending
                        and not self._pending_high and not self._active):
                    return
                while ((self._pending or self._pending_high)
                       and len(self._active) < self.max_concurrent):
                    queue = self._pending_high or self._pending
                    self._active.append(queue.popleft())
                batch = list(self._active)
            with spans.span("service.pass"):
                for job in batch:
                    try:
                        if job.gen is None:
                            job.handle.started_at = time.perf_counter()
                            with spans.span("service.prepare", job=job.handle.job_id):
                                job.gen = job.make_gen(job.handle)
                        with spans.span("service.chunk", job=job.handle.job_id):
                            next(job.gen)
                        job.handle.chunks += 1
                    except StopIteration as stop:
                        self._finish(job, stop.value)
                    except BaseException as exc:  # surfaces through the future
                        self._finish(job, None, exc)

    def _finish(self, job: _Job, res, exc=None):
        with spans.span("service.finish", job=job.handle.job_id):
            if exc is None:
                try:
                    value = job.finalize(res)
                except BaseException as finalize_exc:
                    exc = finalize_exc
            job.handle.finished_at = time.perf_counter()
            with self._cv:
                self._active.remove(job)
                self._jobs_completed += 1
                self._cv.notify_all()
            if exc is not None:
                job.handle.future.set_exception(exc)
            else:
                job.handle.future.set_result(value)

    def _submit(self, kind, n, bucket, max_rounds, make_gen, finalize,
                priority: int = 0) -> JobHandle:
        priority = int(priority)
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        with self._cv:
            if self._closed:
                raise RuntimeError("SecureJobService is closed")
            handle = JobHandle(job_id=self._next_id, kind=kind, n=n, bucket=bucket,
                               round_base=self._round_base, max_rounds=max_rounds,
                               priority=priority, submitted_at=time.perf_counter())
            self._next_id += 1
            # keystream disjointness across jobs: reserve the job's whole
            # round budget on the monotone per-service counter
            self._round_base += max_rounds
            queue = self._pending_high if priority > 0 else self._pending
            queue.append(_Job(handle, make_gen, finalize))
            self._cv.notify()
        return handle

    def _run_chunks(self, spec, spec_id, inputs, init_state, handle, *, max_rounds,
                    min_chunk, max_chunk):
        view = self.cache.view(spec_id=spec_id, mesh=self.mesh, secure=self.secure,
                               coalesce=self.coalesce)
        return run_until_chunks(
            spec, inputs, init_state, self.mesh, secure=self.secure, max_rounds=max_rounds,
            round_offset=handle.round_base, min_chunk=min_chunk, max_chunk=max_chunk,
            coalesce=self.coalesce, runners=_JobRunners(view, handle), job_tag=handle.job_id)

    # -- workloads ---------------------------------------------------------

    def submit_kmeans(self, points, k: int, *, threshold: float | None = None,
                      max_rounds: int = 64, weights=None, init_centers=None,
                      min_chunk: int | None = None, max_chunk: int | None = None,
                      priority: int = 0) -> JobHandle:
        """k-means to convergence (paper §V). Result: {"centers" (k, d),
        "n_iter", "shifts" (n_iter,), "halted", "n_dispatches"}.

        `points` (n, d) and `weights` are numpy arrays or tensors. The
        threshold (default: the paper's diag/1000 rule on THIS job's data)
        rides in carried state (`runtime_threshold=True`), so jobs with other
        data share one runner per bucket; rows padded up to the bucket carry
        weight 0 and contribute nothing. `priority > 0` admits ahead of the
        normal FIFO class.
        """
        shape = _shape_of(points)
        if len(shape) != 2 or shape[0] < 1:
            raise ValueError(f"points must be (n, d) with n >= 1, got {shape}")
        n, d = shape
        if not 1 <= k <= n:
            raise ValueError(f"k must be in [1, n={n}], got {k}")
        bucket = bucket_for(n, multiple=self.n_shards, growth=self.bucket_growth)
        spec_id = ("kmeans", k, d, bucket)
        min_chunk = self.min_chunk if min_chunk is None else min_chunk
        max_chunk = self.max_chunk if max_chunk is None else max_chunk

        def make_gen(handle):
            dev = self.mesh.device
            thr = threshold
            if thr is None:
                if isinstance(points, torch.Tensor):
                    thr = paper_threshold(points)
                else:  # the reference's host rule, float for float
                    p = np.asarray(points, np.float32)
                    thr = float(np.linalg.norm(p.max(axis=0) - p.min(axis=0))) / 1000.0
            wts = torch.ones((n,), device=dev) if weights is None else weights
            inputs = {"p": _padded(points, bucket, 0.0, torch.float32, dev),
                      "w": _padded(wts, bucket, 0.0, torch.float32, dev)}  # weight 0: inert
            c0 = points[:k] if init_centers is None else init_centers
            init = {"c": torch.as_tensor(c0, dtype=torch.float32, device=dev),
                    "thr": torch.full((), thr, dtype=torch.float32, device=dev)}
            spec = make_kmeans_iterative_spec(k, self.mesh, runtime_threshold=True)
            return self._run_chunks(spec, spec_id, inputs, init, handle,
                                    max_rounds=max_rounds, min_chunk=min_chunk,
                                    max_chunk=max_chunk)

        def finalize(res):
            return {"centers": res.state["c"].cpu().numpy(), "n_iter": res.rounds_executed,
                    "shifts": np.asarray(res.aux["shift"]), "halted": res.halted,
                    "n_dispatches": res.n_dispatches}

        return self._submit("kmeans", n, bucket, max_rounds, make_gen, finalize,
                            priority=priority)

    def submit_sort(self, values, *, balance: float = 1.5, max_rounds: int = 4,
                    lo: float | None = None, hi: float | None = None,
                    capacity: int | None = None, min_chunk: int | None = None,
                    max_chunk: int | None = None, priority: int = 0) -> JobHandle:
        """Sampling sort with splitter refinement. Result: {"sorted" (<= n,),
        "counts" (R,), "rounds", "halted", "dropped" (rounds,)}.

        `values` (n,) f32, numpy or a tensor. The record total rides in
        carried state (`dynamic_total=True`) so the lossless and balanced
        halt reads the REAL size at run time; padding up to the bucket is
        +inf, never shuffled. Per-(source, destination) capacity defaults to
        the calibrated model's answer, else the bucket's lossless worst case.
        """
        shape = _shape_of(values)
        if len(shape) != 1 or shape[0] < 1:
            raise ValueError(f"values must be (n,) with n >= 1, got {shape}")
        n = shape[0]
        r = self.n_shards
        bucket = bucket_for(n, multiple=r, growth=self.bucket_growth)
        if capacity is None:
            rec = recommendation("sort_capacity", bucket=bucket, n_shards=r)
            capacity = bucket // r if rec is None else int(rec)
        spec_id = ("sort", r, capacity, float(balance), self.state_mode, bucket)
        min_chunk = self.min_chunk if min_chunk is None else min_chunk
        max_chunk = self.max_chunk if max_chunk is None else max_chunk

        def make_gen(handle):
            dev = self.mesh.device
            low, high = lo, hi
            if low is None or high is None:
                vmin, vmax = _host_min_max(values)
                low = vmin if low is None else low
                high = vmax if high is None else high
            span = max(high - low, 1e-6)
            edges = np.asarray(low + span * np.arange(r + 1) / r, np.float32)
            edges[-1] = high + 1e-3 * span  # open top edge keeps hi in-bucket
            init = {"edges": torch.from_numpy(edges).to(dev),
                    "sorted": torch.full((r, r * capacity), torch.inf, device=dev),
                    "counts": torch.zeros((r,), device=dev),
                    "total": torch.full((), float(n), dtype=torch.float32, device=dev)}
            spec = make_sample_sort_spec(self.mesh, capacity, balance=balance,
                                         shard_state=self.state_mode, dynamic_total=True)
            inputs = {"v": _padded(values, bucket, torch.inf, torch.float32, dev)}
            return self._run_chunks(spec, spec_id, inputs, init, handle,
                                    max_rounds=max_rounds, min_chunk=min_chunk,
                                    max_chunk=max_chunk)

        def finalize(res):
            rows, counts = res.state["sorted"], res.state["counts"]
            take = (torch.arange(rows.shape[1], device=rows.device)[None, :]
                    < counts.to(torch.int64)[:, None])
            return {"sorted": rows[take].cpu().numpy(),  # each row's first counts[i]
                    "counts": counts.cpu().numpy(), "rounds": res.rounds_executed,
                    "halted": res.halted, "dropped": np.asarray(res.dropped)}

        return self._submit("sort", n, bucket, max_rounds, make_gen, finalize,
                            priority=priority)

    def submit_grep(self, tokens, patterns, *, n_rounds: int = 4,
                    max_matches: int | None = None, min_chunk: int | None = None,
                    max_chunk: int | None = None, priority: int = 0) -> JobHandle:
        """Streaming grep over the token stream. Result: {"counts" (n_pat,),
        "per_round" (rounds, n_pat), "rounds", "halted"}.

        `tokens` (n,) int32, numpy or a tensor. The stream cursor rides in
        carried state (`core/grep.py`), so the job is agnostic to the round
        base the service gives it; padding up to the bucket is -1 tokens.
        Without `max_matches` the whole stream is one chunk; with it, chunks
        grow so an early limit stops the stream.
        """
        shape = _shape_of(tokens)
        if len(shape) != 1 or shape[0] < 1:
            raise ValueError(f"tokens must be (n,) with n >= 1, got {shape}")
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        n = shape[0]
        patterns = np.asarray(patterns, np.int32)
        # aligned to shards x rounds: every shard holds n_rounds equal chunks
        multiple = self.n_shards * n_rounds
        bucket = bucket_for(n, multiple=multiple, growth=self.bucket_growth)
        chunk = bucket // multiple
        spec_id = ("grep", patterns.tobytes(), chunk, max_matches, bucket)
        if min_chunk is None:
            min_chunk = n_rounds if max_matches is None else 1
        if max_chunk is None:
            max_chunk = n_rounds

        def make_gen(handle):
            dev = self.mesh.device
            init = {"hits": torch.zeros((patterns.shape[0],), device=dev),
                    "cursor": torch.zeros((), dtype=torch.int64, device=dev)}
            spec = make_grep_spec(patterns, chunk, self.mesh, max_matches=max_matches)
            inputs = {"t": _padded(tokens, bucket, -1, torch.int32, dev)}  # -1: no match
            return self._run_chunks(spec, spec_id, inputs, init, handle, max_rounds=n_rounds,
                                    min_chunk=min_chunk, max_chunk=max_chunk)

        def finalize(res):
            return {"counts": res.state["hits"].cpu().numpy(),
                    "per_round": np.asarray(res.aux["round_hits"]),
                    "rounds": res.rounds_executed, "halted": res.halted}

        return self._submit("grep", n, bucket, n_rounds, make_gen, finalize,
                            priority=priority)
