"""k-means clustering via secure MapReduce on the virtual mesh.

Counterpart of `repro/core/kmeans.py`, the paper's evaluation workload
(§III, Fig. 1): assigning each observation to its nearest centre is the map
function (the fused Hopper kernel, which also pre-aggregates per-centre
partial sums: the combiner); partials are routed to reducer c % R through
the keyed shuffle; reducers average their own centres and a psum, to which
each centre row is contributed by exactly one owner, redistributes the
table. Termination (§V): iterate until the average centre shift drops
below diag/1000 of the data's bounding box; the rule is the job's
`halt_fn`, read by `repro_torch.core.driver.run_until` after every round.

  * `make_kmeans_step` -- one round per call, kept as the oracle;
  * `kmeans_fit` -- rounds to convergence through the driver.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.driver import IterativeSpec, P, run_until
from repro_torch.core.engine import identity_hash
from repro_torch.core.shuffle import bucket_pack, keyed_all_to_all
from repro_torch.kernels.kmeans.ops import kmeans_assign
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref
from repro_torch.tree import tree_map

INERTIA_CHUNK = 1 << 18  # points per distance block of the closing inertia


@dataclass(frozen=True)
class KMeansResult:
    centers: torch.Tensor
    n_iter: int
    center_shift: list  # avg centroid move per iteration
    inertia: float
    n_dispatches: int = 0  # chunks dispatched
    n_rounds_dispatched: int = 0  # rounds shipped (>= n_iter executed)
    halted: bool = False  # the threshold stopped the job (not max_iter)


def _assign_partials(points, weights, centers, impl):
    """Map + combine for all shards: points (S, n, D) -> keys (S, K), partials."""
    s, k = points.shape[0], centers.shape[0]
    _, sums, counts = kmeans_assign(points, centers, weights, impl=impl)
    keys = torch.arange(k, dtype=torch.int32, device=points.device).expand(s, k)
    return keys, {"s": sums, "c": counts}


def _segment_sum(values, seg, k: int):
    """Per-shard segment sum of (S, M, ...) values by (S, M) segment ids.

    A one-hot product rather than `index_add_`: on the card `index_add_`
    adds duplicates with float atomics, whose order (and so whose bits)
    changes from run to run.
    """
    onehot = (seg[..., None] == torch.arange(k, device=seg.device)).to(values.dtype)
    return (onehot.transpose(1, 2) @ values.reshape(values.shape[:2] + (-1,))).reshape(
        (values.shape[0], k) + tuple(values.shape[2:]))


def _reduce_centers(centers, rk, rv, valid, *, mesh):
    """Reduce + redistribute: own-centre aggregation, psum assembly, shift.

    Returns per-shard new centres (S, K, D) and shift (S,), identical across
    shards by construction.
    """
    k = centers.shape[0]
    seg = torch.where(valid, rk, 0)
    own_sums = _segment_sum(torch.where(valid[..., None], rv["s"], 0.0), seg, k)
    own_counts = _segment_sum(torch.where(valid, rv["c"], 0.0), seg, k)

    # each centre row is owned by exactly one reducer; psum assembles the
    # full table on every shard (client gather), restoring replication
    my = mesh.axis_index()[:, None]
    mine = (torch.arange(k, device=centers.device)[None, :] % mesh.n_shards) == my
    total_sums = mesh.psum(torch.where(mine[..., None], own_sums, 0.0))
    total_counts = mesh.psum(torch.where(mine, own_counts, 0.0))

    new_centers = total_sums / torch.clamp_min(total_counts, 1e-9)[..., None]
    # keep empty clusters where they were (standard practice)
    new_centers = torch.where((total_counts > 0)[..., None], new_centers, centers)
    shift = torch.mean(torch.linalg.vector_norm(new_centers - centers, dim=-1), dim=-1)
    return new_centers, shift


def _receive(recv, s):
    rk = recv["k"].reshape(s, -1)
    rv = tree_map(lambda x: x.reshape((s, -1) + tuple(x.shape[3:])), recv["v"])
    return rk, rv


def make_kmeans_step(mesh, secure=None, impl: str = "auto", chacha_impl: str | None = None,
                     coalesce: bool | None = None):
    """One-round function over `mesh` (the oracle path).

    Returns step(points (N, D), weights (N,), centers (K, D)) ->
    (new_centers (K, D), shift ()); `impl` selects the assignment route and
    `chacha_impl`/`coalesce` the shuffle's keystream and wire layout.
    """
    if secure is not None:
        secure = secure.with_impl(chacha_impl).with_coalesce(coalesce)
    s = mesh.n_shards

    def step(points, weights, centers):
        points = mesh.shard(torch.as_tensor(points, device=mesh.device))
        weights = mesh.shard(torch.as_tensor(weights, device=mesh.device))
        centers = torch.as_tensor(centers, device=mesh.device)
        k = centers.shape[0]
        keys, partials = _assign_partials(points, weights, centers, impl)
        bk, bv, _ = bucket_pack(keys, keys % s, partials, s, -(-k // s))
        rk, rv = _receive(keyed_all_to_all({"k": bk, "v": bv}, mesh, secure), s)
        new_centers, shift = _reduce_centers(centers, rk, rv, rk >= 0, mesh=mesh)
        return new_centers[0], shift[0]

    return step


def make_kmeans_iterative_spec(k: int, mesh, *, impl: str = "auto", n_rounds: int = 1,
                               threshold: float | None = None,
                               runtime_threshold: bool = False) -> IterativeSpec:
    """The per-round math of `make_kmeans_step` as a driver spec.

    Carried state = the (K, D) centre table (replicated); aux per round =
    {"centers", "shift"}. `threshold` installs the halt predicate
    `shift < threshold`, compared in float32 like the shift itself.
    `runtime_threshold=True` carries {"c": centers, "thr": () f32} instead and
    reads the threshold from the state, so one spec serves any threshold.
    """
    s = mesh.n_shards

    def reduce(centers, rk, rv, valid):
        return _reduce_centers(centers, rk, rv, valid, mesh=mesh)

    if runtime_threshold:
        def map_fn(state, inputs, r):
            return _assign_partials(inputs["p"], inputs["w"], state["c"], impl)

        def reduce_fn(state, rk, rv, valid, r):
            new_centers, shift = reduce(state["c"], rk, rv, valid)
            thr = state["thr"].expand(s)
            return {"c": new_centers, "thr": thr}, {"centers": new_centers, "shift": shift}

        def halt_fn(state, aux, r):
            return aux["shift"] < state["thr"]

        return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, hash_fn=identity_hash,
                             capacity=-(-k // s), n_rounds=n_rounds, halt_fn=halt_fn,
                             state_specs=P())

    def map_fn(centers, inputs, r):
        return _assign_partials(inputs["p"], inputs["w"], centers, impl)

    def reduce_fn(centers, rk, rv, valid, r):
        new_centers, shift = reduce(centers, rk, rv, valid)
        return new_centers, {"centers": new_centers, "shift": shift}

    halt_fn = None
    if threshold is not None:
        thr = np.float32(threshold)

        def halt_fn(centers, aux, r):
            return aux["shift"] < torch.tensor(thr, device=aux["shift"].device)

    return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, hash_fn=identity_hash,
                         capacity=-(-k // s), n_rounds=n_rounds, halt_fn=halt_fn,
                         state_specs=P())


def paper_threshold(points: torch.Tensor) -> float:
    """Paper §V: diag/1000 of the points' bounding box (norm in float32)."""
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    return float(torch.linalg.vector_norm(hi - lo)) / 1000.0


def inertia_of(points: torch.Tensor, centers: torch.Tensor, chunk: int = INERTIA_CHUNK) -> float:
    """Σ over points of the squared distance to the nearest centre.

    Computed in blocks of `chunk` points so the (N, K) distance matrix is
    never materialized (4 GiB at N=4M, K=256); block sums add in float64.
    """
    c2 = torch.sum(centers * centers, dim=1)[None, :]
    total = 0.0
    for i in range(0, points.shape[0], chunk):
        x = points[i:i + chunk]
        d2 = torch.sum(x * x, dim=1, keepdim=True) + c2 - 2.0 * (x @ centers.T)
        total += float(torch.sum(torch.amin(d2, dim=1)).double())
    return total


def kmeans_fit(points, k: int, mesh, *, secure=None, impl: str = "auto",
               threshold: float | None = None, max_iter: int = 200, init_centers=None,
               init: str = "first", weights=None, rounds_per_dispatch: int = 8,
               min_chunk: int = 1, chacha_impl: str | None = None,
               coalesce: bool | None = None) -> KMeansResult:
    """Iterate to convergence on `mesh`. threshold=None -> paper's diag/1000 rule.

    init: "first" (paper-style arbitrary start) or "farthest" (greedy
    farthest point). Chunks grow 1, 2, 4, ... up to `rounds_per_dispatch`;
    the halt is checked after every round, and the global round index keys
    every secure round's keystream.
    """
    points = torch.as_tensor(points, dtype=torch.float32, device=mesh.device)
    n = points.shape[0]
    if weights is None:
        weights = torch.ones((n,), dtype=torch.float32, device=mesh.device)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=mesh.device)
    if init_centers is None:
        init_centers = points[:k] if init == "first" else _farthest_point_init(points, k)
    centers = torch.as_tensor(init_centers, dtype=torch.float32, device=mesh.device)
    if threshold is None:
        threshold = paper_threshold(points)

    spec = make_kmeans_iterative_spec(k, mesh, impl=impl, threshold=threshold)
    res = run_until(spec, {"p": points, "w": weights}, centers, mesh, secure=secure,
                    max_rounds=max_iter,
                    max_chunk=max(1, min(rounds_per_dispatch, max_iter)),
                    min_chunk=max(1, min_chunk), chacha_impl=chacha_impl,
                    coalesce=coalesce)
    centers = res.state
    shifts = [float(x) for x in res.aux["shift"]]
    return KMeansResult(centers=centers, n_iter=res.rounds_executed, center_shift=shifts,
                        inertia=inertia_of(points, centers), n_dispatches=res.n_dispatches,
                        n_rounds_dispatched=res.rounds_dispatched, halted=res.halted)


def _farthest_point_init(points, k: int):
    """Greedy farthest-point seeding (deterministic k-means++ variant)."""
    centers = [points[0]]
    d2 = torch.sum((points - centers[0]) ** 2, dim=1)
    for _ in range(1, k):
        nxt = points[torch.argmax(d2)]
        centers.append(nxt)
        d2 = torch.minimum(d2, torch.sum((points - nxt) ** 2, dim=1))
    return torch.stack(centers)


def kmeans_step_ref(points, centers, weights=None):
    """Single-host oracle for one iteration (tests)."""
    _, sums, counts = kmeans_assign_ref(points, centers, weights)
    new = sums / torch.clamp_min(counts, 1e-9)[:, None]
    new = torch.where((counts > 0)[:, None], new, centers)
    return new, torch.mean(torch.linalg.vector_norm(new - centers, dim=1))


def generate_points(n: int, k: int, d: int = 2, seed: int = 0, spread: float = 0.05):
    """Paper §V: n random observations around k ground-truth centers in [0,1]^d.

    The numpy recipe of `repro.core.kmeans.generate_points`, so both packages
    make identical data from one seed.
    """
    rng = np.random.default_rng(seed)
    true_centers = rng.uniform(0.1, 0.9, size=(k, d))
    idx = rng.integers(0, k, size=n)
    pts = true_centers[idx] + rng.normal(scale=spread, size=(n, d))
    return pts.astype(np.float32), true_centers.astype(np.float32)
