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

Carried state has two tiers, chosen per leaf by `IterativeSpec.state_specs`
(a tree of `P`s matching the state; None or a bare `P` broadcasts):

  * REPLICATED leaf, `P()`: held once (no shard dim); `map_fn` and
    `reduce_fn` see it replicated, and `reduce_fn` returns per-shard
    (S, ...) values that it made identical with a collective (`mesh.psum`,
    as the paper's client redistributes the centres); the driver keeps shard
    0's copy, as JAX's `out_specs=P()` does. Aux follows the same rule.
  * SHARDED leaf, `P(axis)`: kept per shard with its leading S dim across
    rounds, (S, n / S, ...); `map_fn` and `reduce_fn` see each shard's local
    part and `reduce_fn` returns the updated local parts. The caller's
    `init_state` holds the global leaf (`mesh.shard` splits it) and the
    result holds it global again (`mesh.unshard`), as the reference's host
    gather does.

`halt_fn` must depend only on replicated values: it sees every sharded leaf
replaced by a guard whose every use raises a ValueError naming the leaf
(the reference raises at trace time; the port, which does not trace, at the
first `halt_fn` call, and the job returns no result).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.engine import default_hash, shuffle_round
from repro_torch.tree import tree_flatten, tree_map, tree_paths, tree_unflatten

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
    state_specs: None / P() (replicated) or P(axis) (sharded), or a tree of
        them matching the state (module docstring).
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


_STATE_MODES = ("replicated", "sharded")


def resolve_state_mode(mode="auto") -> str:
    """A carried-state layout selector as 'replicated' | 'sharded'.

    'auto'/None is 'sharded', the reference's default; the port reads no
    environment variable.
    """
    if mode in (None, "auto"):
        return "sharded"
    if mode not in _STATE_MODES:
        raise ValueError(
            f"carried-state mode must be one of {_STATE_MODES} or 'auto', got {mode!r}")
    return mode


def _resolve_state_specs(spec: IterativeSpec, state):
    """(flat specs, flat is-sharded flags) in the state's flat leaf order.

    None (the attribute or a leaf) means P(); a bare P broadcasts to every
    leaf. Raises ValueError, before any round runs, when the tree does not
    match the state's structure or holds a leaf that is not a P.
    """
    leaves, treedef = tree_flatten(state)
    specs = spec.state_specs
    if specs is None or isinstance(specs, P):
        flat = [P() if specs is None else specs] * len(leaves)
    else:
        flat, spec_def = tree_flatten(specs, is_leaf=lambda x: x is None or isinstance(x, P))
        if spec_def != treedef:
            raise ValueError("IterativeSpec.state_specs must be a tree matching the "
                             f"carried state's structure; got {specs!r}")
        for i, p in enumerate(flat):
            if p is not None and not isinstance(p, P):
                raise ValueError("IterativeSpec.state_specs leaves must be P(...) "
                                 f"(or None for replicated); leaf {i} is {p!r}")
        flat = [P() if p is None else p for p in flat]
    return flat, [any(a is not None for a in p) for p in flat]


class _ShardedHaltGuard:
    """Stand-in for a sharded state leaf in the state `halt_fn` sees.

    Any use -- arithmetic, a torch or numpy call, attribute access,
    iteration, truth -- raises a ValueError naming the leaf: a halt predicate
    over shard-local data would let shards disagree about the next round.
    """

    def __init__(self, path: str, pspec):
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_pspec", pspec)

    def _halt_guard_raise(self, *_a, **_k):
        raise ValueError(
            f"IterativeSpec.halt_fn touched the SHARDED carried-state leaf "
            f"state{self._path} (state_specs leaf {self._pspec!r}): the "
            "replicated-halt contract requires halt_fn to be a pure "
            "function of replicated values only (replicated state leaves, "
            "aux, round index) -- a shard-varying predicate would deadlock "
            "the mesh. Derive the halt signal from a replicated leaf or "
            "from aux, or declare this leaf P() in state_specs.")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        operands = tree_flatten([list(args), kwargs or {}])[0]
        next(a for a in operands if isinstance(a, cls))._halt_guard_raise()

    def __getattr__(self, name):
        self._halt_guard_raise()

    def __repr__(self):
        return f"_ShardedHaltGuard(state{self._path}: {self._pspec!r})"


for _name in (
    "__array__", "__bool__", "__int__", "__float__", "__index__", "__len__",
    "__iter__", "__getitem__", "__neg__", "__pos__", "__abs__", "__invert__",
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__floordiv__", "__rfloordiv__", "__mod__",
    "__rmod__", "__pow__", "__rpow__", "__matmul__", "__rmatmul__", "__and__",
    "__rand__", "__or__", "__ror__", "__xor__", "__rxor__", "__lshift__",
    "__rlshift__", "__rshift__", "__rrshift__", "__lt__", "__le__", "__gt__",
    "__ge__", "__eq__", "__ne__", "__format__",
):
    setattr(_ShardedHaltGuard, _name, _ShardedHaltGuard._halt_guard_raise)


class _StateLayout:
    """Each carried leaf's tier, resolved once per job from `spec.state_specs`."""

    def __init__(self, spec: IterativeSpec, state):
        self.specs, self.sharded = _resolve_state_specs(spec, state)
        self.paths = tree_paths(state)

    def _per_leaf(self, tree, sharded_fn, replicated_fn):
        leaves, treedef = tree_flatten(tree)
        if len(leaves) != len(self.sharded):
            raise ValueError(f"carried state has {len(leaves)} leaves, its state_specs "
                             f"declare {len(self.sharded)}")
        return tree_unflatten(treedef, [sharded_fn(x, i) if sh else replicated_fn(x, i)
                                        for i, (x, sh) in enumerate(zip(leaves, self.sharded))])

    def place(self, state, mesh):
        """The caller's global state as carried: sharded leaves split over S."""
        return self._per_leaf(state, lambda x, i: mesh.shard(x), lambda x, i: x)

    def keep(self, new_state):
        """reduce_fn's per-shard output as carried: shard 0's copy of replicated leaves."""
        return self._per_leaf(new_state, lambda x, i: x, lambda x, i: x[0])

    def for_halt(self, state):
        """halt_fn's view: sharded leaves swapped for guards."""
        if not any(self.sharded):
            return state
        return self._per_leaf(state, lambda x, i: _ShardedHaltGuard(self.paths[i], self.specs[i]),
                              lambda x, i: x)

    def gather(self, state, mesh):
        """The carried state as the caller gets it: sharded leaves global again."""
        return self._per_leaf(state, lambda x, i: mesh.unshard(x), lambda x, i: x)


def _replica(tree):
    """Shard 0's copy of per-shard values that a collective made identical."""
    return tree_map(lambda x: x[0], tree)


def _round(spec: IterativeSpec, mesh, inputs, state, r: int, secure, coalesce, info: dict,
           layout: _StateLayout):
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
    return layout.keep(new_state), _replica(aux), dropped.sum()


def _run_chunk(spec, mesh, inputs, state, n_rounds: int, first_round: int, secure,
               coalesce, info: dict, layout: _StateLayout):
    """Up to n_rounds rounds; stops after the round whose halt_fn fires.

    Returns (state, [aux per executed round], [dropped per executed round],
    rounds_executed, halted).
    """
    auxes, drops = [], []
    for i in range(n_rounds):
        r = first_round + i
        state, aux, dropped = _round(spec, mesh, inputs, state, r, secure, coalesce, info,
                                     layout)
        auxes.append(aux)
        drops.append(dropped)
        if spec.halt_fn is not None and bool(spec.halt_fn(layout.for_halt(state), aux, r)):
            return state, auxes, drops, i + 1, True
    return state, auxes, drops, n_rounds, False


def _prepare(spec, inputs, init_state, mesh, secure, chacha_impl, coalesce):
    if secure is not None:
        secure = secure.with_impl(chacha_impl).with_coalesce(coalesce)
    state = tree_map(lambda x: torch.as_tensor(x, device=mesh.device), init_state)
    layout = _StateLayout(spec, state)
    state = layout.place(state, mesh)
    inputs = tree_map(lambda x: mesh.shard(torch.as_tensor(x, device=mesh.device)), inputs)
    return secure, state, inputs, layout


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
    secure, state, inputs, layout = _prepare(spec, inputs, init_state, mesh, secure,
                                             chacha_impl, coalesce)
    info: dict = {}
    state, auxes, drops, n_exec, halted = _run_chunk(
        spec, mesh, inputs, state, spec.n_rounds, round_offset, secure, coalesce, info,
        layout)
    state = layout.gather(state, mesh)
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

    state:             final carried state on the mesh's device, sharded leaves
                       global again (`mesh.unshard`).
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
    secure, state, inputs, layout = _prepare(spec, inputs, init_state, mesh, secure,
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
            spec, mesh, inputs, state, n, round_offset + executed, secure, coalesce, info,
            layout)
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
    return RunUntilResult(state=layout.gather(state, mesh), aux=aux, dropped=dropped, rounds_executed=executed,
                          rounds_dispatched=dispatched, n_dispatches=n_dispatches,
                          halted=halted)
