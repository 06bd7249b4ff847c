"""Iterative secure MapReduce driver on the virtual mesh.

Counterpart of `repro/core/driver.py`. Each round r runs, for all shards at
once:

    mapped_k, mapped_v = spec.map_fn(state, inputs, r)      # "mapper enclave"
    [mapped_k, mapped_v = spec.combine_fn(mapped_k, mapped_v)]
    bucket  = spec.hash_fn(mapped_k) % R
    send    = bucket_pack(...)                              # (S, R, C, ...)
    recv    = keyed_all_to_all(send, mesh, secure, round_index=r)
    state, aux = spec.reduce_fn(state, keys, values, valid, r)   # "reducer"

What matches the reference is the observable contract of its halt-aware
`while` loop, not its mechanism:

  * `run_until` dispatches chunks of rounds, `min_chunk` first and then
    growing geometrically (x`growth`, default 2) up to `max_chunk`, and
    counts `rounds_dispatched` (rounds shipped, including the unexecuted
    tail of the halting chunk), `n_dispatches` and `rounds_executed`.
  * `halt_fn(state, aux, r)` is evaluated after every round on the freshly
    reduced state and that round's aux. Once it returns True the chunk stops:
    later rounds run no map, no shuffle and derive no keystream.
  * GAPLESS KEYSTREAM ACCOUNTING: chunk i+1 starts at global round
    `round_offset` + rounds executed so far, so executed rounds occupy the
    disjoint range [round_offset, round_offset + rounds_executed) of round
    indices, each of which keys its own keystream (nonce word 1).
  * Overflow is summarized once per job with global round indices.

The chunk is a Python loop that reads the halt flag after each round: one
host synchronisation per executed round. That is the known cost of this
slice's loop; the JAX program decides on the device instead.

Carried state follows the REPLICATED contract: the state and aux are held
once (no shard dim); `map_fn` and `reduce_fn` see them replicated, and
`reduce_fn` returns per-shard (S, ...) values that it made identical with a
collective (`mesh.psum`, as the paper's client redistributes the centres);
the driver keeps shard 0's copy, as JAX's `out_specs=P()` does. `halt_fn`
must depend only on replicated values. Sharded carried state is not part of
this port yet: a sharded `state_specs` leaf raises NotImplementedError.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.engine import default_hash, shuffle_round
from repro_torch.tree import tree_flatten, tree_map

CAPACITY_FACTOR = 2.0  # headroom of the auto bucket capacity: ceil(n / R) * 2.0


class P(tuple):
    """Stand-in for `jax.sharding.PartitionSpec`: P() replicated, P(axis) sharded."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclass(frozen=True)
class IterativeSpec:
    """A multi-round MapReduce job over fixed-shape shards.

    map_fn(state, inputs, round_index) -> (mapped_keys (S, n), mapped_values)
    combine_fn(keys, values) -> (keys, values)   [optional, local]
    reduce_fn(state, keys, values, valid, round_index) -> (new_state, aux),
        both per shard with a leading S dim and replicated by a collective.
    hash_fn(keys) -> u32 values; destination shard = hash_fn(k) % R.
    capacity: per-destination slots C; 0 -> auto (ceil(n_mapped / R) * 2.0).
    n_rounds: rounds of one `run_iterative_mapreduce` call.
    halt_fn(state, aux, round_index) -> bool scalar   [optional]
    state_specs: None / P() (replicated) or a tree of them; P(axis) leaves
        (sharded state) are not supported yet.
    """

    map_fn: Callable
    reduce_fn: Callable
    combine_fn: Callable | None = None
    hash_fn: Callable = default_hash
    capacity: int = 0
    n_rounds: int = 1
    halt_fn: Callable | None = None
    state_specs: Any = None


def resolve_chunk_growth(growth="auto") -> int:
    """The chunk-ladder growth factor: an explicit int >= 1, or 2 for 'auto'/None."""
    if growth in (None, "auto"):
        return 2
    try:
        val = int(growth)
    except (TypeError, ValueError):
        val = 0
    if val < 1:
        raise ValueError(f"growth must be an integer >= 1 or 'auto', got {growth!r}")
    return val


def _check_state_specs(spec: IterativeSpec, state) -> None:
    specs = spec.state_specs
    n_leaves = len(tree_flatten(state)[0])
    if specs is None or isinstance(specs, P):
        flat = [specs] * n_leaves
    else:
        flat = tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
        if len(flat) != n_leaves:
            raise ValueError("IterativeSpec.state_specs must match the carried "
                             f"state's structure; got {specs!r}")
    for p in flat:
        if p is not None and not isinstance(p, P):
            raise ValueError(f"state_specs leaves must be P(...) or None, got {p!r}")
        if p is not None and any(a is not None for a in p):
            raise NotImplementedError(
                f"sharded carried state ({p!r}) is not ported yet: it arrives with "
                "the sort slice (ROADMAP Queue 1 item 6); declare the leaf P()")


def _replica(tree):
    """Shard 0's copy of per-shard values that a collective made identical."""
    return tree_map(lambda x: x[0], tree)


def _round(spec: IterativeSpec, mesh, inputs, state, r: int, secure, coalesce, info: dict):
    mk, mv = spec.map_fn(state, inputs, r)
    if spec.combine_fn is not None:
        mk, mv = spec.combine_fn(mk, mv)
    n_mapped = mk.shape[1]
    capacity = spec.capacity or max(
        1, int(np.ceil(-(-n_mapped // mesh.n_shards) * CAPACITY_FACTOR)))
    info["capacity"], info["capacity_auto"] = capacity, not spec.capacity
    flat_k, flat_v, valid, dropped = shuffle_round(
        mk, mv, mesh, hash_fn=spec.hash_fn, capacity=capacity, secure=secure,
        round_index=r, coalesce=coalesce)
    new_state, aux = spec.reduce_fn(state, flat_k, flat_v, valid, r)
    return _replica(new_state), _replica(aux), dropped.sum()


def _run_chunk(spec, mesh, inputs, state, n_rounds: int, first_round: int, secure,
               coalesce, info: dict):
    """Up to n_rounds rounds; stops after the round whose halt_fn fires.

    Returns (state, [aux per executed round], [dropped per executed round],
    rounds_executed, halted).
    """
    auxes, drops = [], []
    for i in range(n_rounds):
        r = first_round + i
        state, aux, dropped = _round(spec, mesh, inputs, state, r, secure, coalesce, info)
        auxes.append(aux)
        drops.append(dropped)
        if spec.halt_fn is not None and bool(spec.halt_fn(state, aux, r)):
            return state, auxes, drops, i + 1, True
    return state, auxes, drops, n_rounds, False


def _prepare(spec, inputs, init_state, mesh, secure, chacha_impl, coalesce):
    if secure is not None:
        secure = secure.with_impl(chacha_impl).with_coalesce(coalesce)
    state = tree_map(lambda x: torch.as_tensor(x, device=mesh.device), init_state)
    _check_state_specs(spec, state)
    inputs = tree_map(lambda x: mesh.shard(torch.as_tensor(x, device=mesh.device)), inputs)
    return secure, state, inputs


def _warn_overflow(dropped, first_round: int, info: dict | None, stacklevel: int = 3):
    """Warn once, naming every overflowing GLOBAL round and the capacity in force."""
    dropped = np.asarray(dropped)
    bad = np.nonzero(dropped > 0)[0]
    if bad.size == 0:
        return
    info = info or {}
    cap = info.get("capacity")
    cap_s = "capacity unknown"
    if cap is not None:
        cap_s = f"auto capacity {cap}" if info.get("capacity_auto") else f"capacity {cap}"
    detail = ", ".join(
        f"round {first_round + int(j)}: n_dropped={int(dropped[j])}" for j in bad)
    warnings.warn(
        f"shuffle overflow — {detail} (per-destination {cap_s}); "
        f"raise IterativeSpec.capacity to make the job lossless",
        RuntimeWarning, stacklevel=stacklevel)


def run_iterative_mapreduce(spec: IterativeSpec, inputs, init_state, mesh, secure=None,
                            round_offset: int = 0, chacha_impl: str | None = None,
                            coalesce: bool | None = None, warn_on_overflow: bool = True):
    """Run `spec.n_rounds` rounds from global round `round_offset`.

    Returns (final_state, aux_per_round, dropped_per_round), each per-round
    tensor with a leading (n_rounds,) dim, plus (rounds_executed, halted)
    when `spec.halt_fn` is set; rounds after a halt are zero-filled.
    """
    secure, state, inputs = _prepare(spec, inputs, init_state, mesh, secure,
                                     chacha_impl, coalesce)
    info: dict = {}
    state, auxes, drops, n_exec, halted = _run_chunk(
        spec, mesh, inputs, state, spec.n_rounds, round_offset, secure, coalesce, info)
    pad = spec.n_rounds - n_exec
    aux = tree_map(lambda *xs: torch.stack(list(xs) + [torch.zeros_like(xs[0])] * pad),
                   *auxes)
    dropped = torch.stack(drops + [torch.zeros_like(drops[0])] * pad)
    if warn_on_overflow:
        _warn_overflow(dropped[:n_exec].cpu().numpy(), round_offset, info)
    if spec.halt_fn is None:
        return state, aux, dropped
    return state, aux, dropped, n_exec, halted


@dataclass(frozen=True)
class RunUntilResult:
    """Outcome of a convergence-aware `run_until` job.

    state:             final carried state (replicated tensors on the mesh's device).
    aux:               per-round aux, leaves stacked over the executed rounds (numpy).
    dropped:           (rounds_executed,) overflow counts per executed round.
    rounds_executed:   rounds whose body ran (== keystream rounds consumed).
    rounds_dispatched: rounds shipped in chunks (>= rounds_executed).
    n_dispatches:      chunks dispatched.
    halted:            True when halt_fn fired; False when max_rounds ran out.
    """

    state: Any
    aux: Any
    dropped: Any
    rounds_executed: int
    rounds_dispatched: int
    n_dispatches: int
    halted: bool


def run_until(spec: IterativeSpec, inputs, init_state, mesh, **kwargs) -> RunUntilResult:
    """Run a job until `spec.halt_fn` fires or `max_rounds` rounds executed.

    Same arguments as `run_until_chunks`, which it drives to the end.
    """
    gen = run_until_chunks(spec, inputs, init_state, mesh, **kwargs)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def run_until_chunks(spec: IterativeSpec, inputs, init_state, mesh, *, secure=None,
                     max_rounds: int = 64, round_offset: int = 0, min_chunk: int = 1,
                     growth="auto", max_chunk: int | None = None,
                     chacha_impl: str | None = None, coalesce: bool | None = None,
                     warn_on_overflow: bool = True):
    """Cooperative (generator) form of `run_until`.

    Yields {"chunk_rounds", "rounds_executed", "n_dispatches", "halted"}
    after every chunk and returns the `RunUntilResult` as StopIteration.value.
    `spec.n_rounds` is ignored: chunk sizes are chosen here.
    """
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    growth = resolve_chunk_growth(growth)
    if min_chunk < 1:
        raise ValueError(f"min_chunk must be >= 1, got {min_chunk}")
    max_chunk = min(max_chunk or max_rounds, max_rounds)
    secure, state, inputs = _prepare(spec, inputs, init_state, mesh, secure,
                                     chacha_impl, coalesce)
    executed = dispatched = n_dispatches = 0
    halted = False
    auxes: list = []
    drops: list = []
    info: dict = {}
    chunk = min(max(1, min_chunk), max_chunk)
    while executed < max_rounds and not halted:
        n = min(chunk, max_rounds - executed)
        state, a, d, n_exec, halted = _run_chunk(
            spec, mesh, inputs, state, n, round_offset + executed, secure, coalesce, info)
        auxes += a
        drops += d
        n_dispatches += 1
        dispatched += n
        executed += n_exec
        chunk = min(chunk * growth, max_chunk)
        yield {"chunk_rounds": n, "rounds_executed": executed,
               "n_dispatches": n_dispatches, "halted": halted}

    aux = tree_map(lambda *xs: torch.stack(xs).cpu().numpy(), *auxes)
    dropped = torch.stack(drops).cpu().numpy()
    if warn_on_overflow:
        _warn_overflow(dropped, round_offset, info, stacklevel=4)
    return RunUntilResult(state=state, aux=aux, dropped=dropped, rounds_executed=executed,
                          rounds_dispatched=dispatched, n_dispatches=n_dispatches,
                          halted=halted)
