"""TeraSort-style sampling sort on the iterative secure driver (virtual mesh).

Counterpart of `repro/core/sort.py`. Every round range-partitions each
record to reducer i iff edge[i] <= v < edge[i+1] by the current edge table
(carried state), reducers sort what they received and count their load, and
the reduce refines the edges toward equi-depth by inverting the piecewise
linear CDF of the round's bucket counts (`equidepth_edges`). Round 0 with
uniform edges is the sampling pass; the job halts the round a partition is
lossless (every record received) and balanced (no reducer above `balance`
times its fair share), so `n_rounds` is a budget, not a cost.

The (R, R·capacity) sorted table is the largest carried leaf. It is sharded
by default (`P(axis)`): each reducer keeps only its own row across rounds
and the table is made global once, after the job. `shard_state=False` keeps
it replicated, as an all_gather that the virtual mesh holds as an expanded
view (no R-fold copy); both layouts give identical bits.

Counts are float32, as in the reference: they are exact while every count
and partial sum stays at or below 2**24, and the halt's `sum(counts) >=
total` is exact only within that range.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.driver import IterativeSpec, P, resolve_state_mode, run_until
from repro_torch.core.engine import identity_hash

_EPS = float(np.spacing(np.finfo(np.float32).eps))  # jnp.interp's flat-segment test


def _fma_f32(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64; the float64 sum
    is made round-to-odd (its exact error by TwoSum decides the last bit),
    which makes the final rounding to float32 correct.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` on float32, by the reference's own formula.

    jax 0.9's `_interp` operation for operation: the segment by a
    right-sided search, a flat segment taking its left value, then the left
    and right clamps. XLA contracts its `fp[i-1] + (delta / dx) * df` into
    one fused multiply-add, and so does this (`_fma_f32`).
    """
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    lo_x, lo_f = xp[i - 1], fp[i - 1]
    df = fp[i] - lo_f
    dx = xp[i] - lo_x
    delta = x - lo_x
    dx0 = torch.abs(dx) <= _EPS
    f = torch.where(dx0, lo_f,
                    _fma_f32(delta / torch.where(dx0, torch.ones_like(dx), dx), df, lo_f))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def equidepth_edges(edges, counts):
    """Refine bin edges toward equi-depth given observed per-bin counts.

    Inverts the piecewise-linear CDF implied by (edges, counts) at the
    equi-depth targets. Endpoints stay pinned; empty histograms return the
    edges unchanged.

    The edges decide every record's reducer, so this is the reference's
    float32 arithmetic as its compiled round runs it: the cumsum in float32,
    the targets `total * k` times the float32 reciprocal of the static R
    (XLA's rewrite of `/ R`), and the interp's multiply-add fused.
    """
    r = counts.shape[0]
    f32 = torch.float32
    dev = counts.device
    total = torch.sum(counts)
    cum = torch.cat([torch.zeros((1,), dtype=counts.dtype, device=dev),
                     torch.cumsum(counts, dim=0)])
    targets = total * torch.arange(1, r, dtype=f32, device=dev) * float(np.float32(1) / np.float32(r))
    interior = _interp(targets, cum.to(f32), edges.to(f32))
    new = torch.cat([edges[:1], interior, edges[-1:]])
    return torch.where(total > 0, new, edges)


def initial_edges(lo: float, hi: float, r: int) -> np.ndarray:
    """Uniform (r + 1,) float32 edges over [lo, hi], the top one opened past hi.

    The reference computes `lo + span * arange(r + 1) / r` in float32 (its
    Python floats are weakly typed) and the top edge `hi + 1e-3 * span` in
    Python floats before the cast; both are reproduced here bit for bit.
    """
    f32 = np.float32
    span = max(hi - lo, 1e-6)
    edges = f32(lo) + f32(span) * np.arange(r + 1, dtype=f32) / f32(r)
    edges[-1] = f32(hi + 1e-3 * span)
    return edges


def make_sample_sort_spec(mesh, capacity: int, *, axis_name: str = "data",
                          n_rounds: int = 2, halt_total: int | None = None,
                          balance: float = 1.5, shard_state="auto",
                          dynamic_total: bool = False) -> IterativeSpec:
    """Driver spec for sampling sort over the R shards of `mesh`, one reducer each.

    State: {"edges": (R+1,) f32 range-partition edges (replicated),
            "sorted": (R, R*capacity) f32 per-reducer sorted ranges
                      (+inf past each reducer's count),
            "counts": (R,) f32 per-reducer received counts (replicated)}.

    `shard_state` picks the layout of "sorted": True/'sharded' (the 'auto'
    default) declares it `P(axis)`, False/'replicated' keeps every shard's
    copy of the whole table. Edges and counts stay replicated in both: the
    refinement and the halt read them.

    `halt_total` (the job's record count) installs the halt: stop once a
    round received every record and no reducer holds more than `balance`
    times the fair share, both read from the round's replicated counts.

    `dynamic_total=True` is the serving variant: the total is a replicated
    "total" state leaf read by the halt at run time, and non-finite records
    get bucket -1 so they never enter the shuffle or the counts (jobs padded
    with +inf share one shape). `halt_total` is ignored then.
    """
    n_shards = mesh.n_shards
    if isinstance(shard_state, bool):
        sharded = shard_state
    else:
        sharded = resolve_state_mode(shard_state) == "sharded"

    def map_fn(state, inputs, r):
        v = inputs["v"]
        # destination reducer by range partition on the current edges
        bucket = torch.clamp(torch.searchsorted(state["edges"][1:-1], v, right=True),
                             0, n_shards - 1).to(torch.int32)
        if dynamic_total:
            # padding records (+inf) are invalid: bucket_pack drops keys < 0
            # without counting them
            bucket = torch.where(torch.isfinite(v), bucket, -1)
        return bucket, {"v": v}

    def reduce_fn(state, rk, rv, valid, r):
        s = rk.shape[0]
        recv = torch.where(valid, rv["v"], torch.inf)
        local_sorted = torch.sort(recv, dim=1, stable=True).values  # invalids last as +inf
        local_count = torch.sum(valid, dim=1).to(torch.float32)
        counts = mesh.all_gather(local_count)  # (S, R): every shard sees all counts
        if sharded:
            table = local_sorted[:, None, :]  # this reducer's row: its local shard
        else:
            table = mesh.all_gather(local_sorted)  # an expanded view, not R copies
        edges = equidepth_edges(state["edges"], counts[0])
        new_state = {"edges": edges.expand(s, -1), "sorted": table, "counts": counts}
        if dynamic_total:
            new_state["total"] = state["total"].expand(s)
        return new_state, {"counts": counts}

    halt_fn = None
    if dynamic_total:
        # float32 values as host floats: nothing is copied to the card; the
        # division by the static R is the reference's compiled reciprocal
        bal = float(np.float32(balance))
        inv_r = float(np.float32(1) / np.float32(n_shards))

        def halt_fn(state, aux, r):
            counts = aux["counts"]
            total = state["total"]
            fair = bal * total * inv_r
            return (torch.sum(counts) >= total) & (torch.max(counts) <= fair)
    elif halt_total is not None:
        # host floats holding float32 values: nothing is copied to the card
        fair = float(np.float32(balance * halt_total / n_shards))
        total = float(np.float32(halt_total))

        def halt_fn(state, aux, r):
            counts = aux["counts"]
            return (torch.sum(counts) >= total) & (torch.max(counts) <= fair)

    state_specs = {"edges": P(), "sorted": P(axis_name) if sharded else P(), "counts": P()}
    if dynamic_total:
        state_specs["total"] = P()
    return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn,
                         hash_fn=identity_hash,  # the key IS the destination reducer
                         capacity=capacity, n_rounds=n_rounds, halt_fn=halt_fn,
                         state_specs=state_specs)


def sample_sort(values, mesh, *, axis_name: str = "data", secure=None, n_rounds: int = 2,
                capacity: int | None = None, lo: float | None = None,
                hi: float | None = None, balance: float = 1.5,
                coalesce: bool | None = None, shard_state="auto"):
    """Sort `values` (f32, split over the mesh's shards) by sampling sort.

    Returns (sorted_values numpy, counts (R,) numpy, dropped
    (rounds_executed,) numpy): row i of the carried table holds reducer i's
    sorted range, so each row's first counts[i] entries, in row order, are
    the sorted array (length n minus any final-round drops). `capacity` is
    per-(source, destination) slots, by default the lossless worst case (a
    whole source shard landing in one range). `n_rounds` is the refinement
    budget: the job halts the round the partition is lossless and balanced
    within `balance`x of the fair share. Only drops in the last executed
    round (data loss) warn.
    """
    values = torch.as_tensor(values, dtype=torch.float32, device=mesh.device)
    n = values.shape[0]
    r = mesh.n_shards
    if capacity is None:
        capacity = n // r  # lossless even if a source sends everything one way
    if lo is None:
        lo = float(torch.min(values))
    if hi is None:
        hi = float(torch.max(values))
    init_state = {
        "edges": torch.from_numpy(initial_edges(lo, hi, r)).to(mesh.device),
        "sorted": torch.full((r, r * capacity), torch.inf, dtype=torch.float32,
                             device=mesh.device),
        "counts": torch.zeros((r,), dtype=torch.float32, device=mesh.device),
    }
    spec = make_sample_sort_spec(mesh, capacity, axis_name=axis_name, halt_total=n,
                                 balance=balance, shard_state=shard_state)
    # early-round overflow is the sampling working as designed; only drops
    # in the final executed round lose data
    res = run_until(spec, {"v": values}, init_state, mesh, secure=secure,
                    max_rounds=n_rounds, coalesce=coalesce, warn_on_overflow=False)
    if res.dropped.size and int(res.dropped[-1]) > 0:
        warnings.warn(
            f"sample_sort exhausted its {n_rounds}-round refinement budget "
            f"with {int(res.dropped[-1])} records dropped in the final round "
            f"(per-(source,destination) capacity {capacity}); the output is "
            f"TRUNCATED -- raise capacity or n_rounds",
            RuntimeWarning, stacklevel=2)
    counts = res.state["counts"]
    take = (torch.arange(r * capacity, device=mesh.device)[None, :]
            < counts.to(torch.int64)[:, None])
    out = res.state["sorted"][take].cpu().numpy()  # row-major: each row's first counts[i]
    return out, counts.cpu().numpy(), res.dropped
