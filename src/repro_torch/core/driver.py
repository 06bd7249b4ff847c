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

Runners (the serving path). A chunk runs through a runner,
`runner(inputs, state, round_offset) -> (state, aux, dropped,
rounds_executed, halted)`, built by `make_iterative_runner` and held by a
runner cache (`run_until(runners=...)`: a dict of chunk size -> runner, or a
keyed `get_or_build` view of `repro_torch.serve.RunnerCache`) in place of
the reference's jitted program:

  * On a CUDA mesh the runner is a captured CUDA graph of ONE round (one
    per shape of inputs and state), replayed up to n_rounds times per chunk
    (`_GraphRunner`). The host writes each round's id into a device scalar
    with `fill_`; the graph derives the keystream's round bits from it on
    the card (the ChaCha kernel reads them from device memory), and the
    host reads the halt flag after each replay: one synchronisation per executed round, as in the
    eager loop, but one graph launch and one fill per round in place of
    about a hundred launches. A graph of a whole chunk would need every
    round inside it to be skippable on the card (a CUDA conditional IF node,
    `torch.cuda.CUDAGraph.begin_capture_to_if_node`), and the PyTorch build
    on the card this was written for (2.11) lacks that API; so the chunk is
    a host loop over one-round replays. There is no fallback between the
    two designs and no eager fallback on the card.
  * On a CPU mesh the runner is the eager chunk (`_EagerRunner`), chosen by
    the mesh's device, so the CPU tests drive the same cache contract.
  * With `runners=None` every chunk runs the eager loop, which reads the
    halt flag after each round: a graph replayed once would pay its capture
    and save nothing, so the uncached entry points (`kmeans_fit`,
    `sample_sort`, `grep_count` without a runner) stay eager.

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
first `halt_fn` call -- in a graph runner, in the warm-up round before its
capture -- and the job returns no result).

Tuning (calibrated `auto` knobs). Every knob with an `auto` mode resolves,
in order: explicit argument -> environment variable -> calibrated cost
model -> historical default. The model is active only when
$REPRO_CALIBRATION names a calibration JSON (`python -m
repro_torch.perf.calibrate --out calibration.json`) or one is set with
`repro_torch.perf.model.set_active_model`; without one every `auto`
resolves to its historical default bit for bit.

    knob            resolver                     env var                     default
    chunk growth    resolve_chunk_growth         $REPRO_CHUNK_GROWTH         2
    auto capacity   resolve_capacity_factor      -                           2.0
    state layout    resolve_state_mode           $REPRO_STATE_SPECS          'sharded'
    coalesce        shuffle.resolve_coalesce     $REPRO_SHUFFLE_COALESCE     True
    bucket growth   serve.resolve_bucket_growth  $REPRO_BUCKET_GROWTH        2.0
    residency cap   serve.resolve_max_resident   $REPRO_SERVICE_MAX_RUNNERS  unbounded
    sort capacity   serve (submit_sort)          -                           bucket // R

The state layout reads no model, as in the reference. Each knob is resolved
once per job or runner build (the capacity factor and the wire layout when a
runner is made, the chunk growth when a job starts), never per round: a
round runs in Python on every eager round, and a resolver reads the
environment and stats the calibration file. The reference's
$REPRO_CHACHA_IMPL and $REPRO_HALT_LOOP have no counterpart: on the card the
kernel is the only keystream route, and the port has one loop shape.
"""

from __future__ import annotations

import os
import threading
import warnings
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.engine import default_hash, shuffle_round
from repro_torch.core.shuffle import resolve_coalesce
from repro_torch.crypto.chacha import MASK32, to_word_bits
from repro_torch.device import pinned_constants
from repro_torch.perf.model import recommendation
from repro_torch.tools.opcount import RoundReport, replayable, spans, wire_accounting
from repro_torch.tree import tree_flatten, tree_map, tree_paths, tree_unflatten

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
    capacity: per-destination slots C; 0 -> auto (ceil(n_mapped / R) * the
        capacity factor, `resolve_capacity_factor`: 2.0 by default).
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


STATE_SPECS_ENV = "REPRO_STATE_SPECS"
_STATE_MODES = ("replicated", "sharded")


def resolve_state_mode(mode="auto") -> str:
    """Resolve a carried-state layout selector to 'replicated' | 'sharded'.

    'auto'/None defers to $REPRO_STATE_SPECS, then to the default 'sharded'
    (no calibrated answer, as in the reference); an explicit mode always
    wins over the environment.
    """
    from_env = False
    if mode in (None, "auto"):
        env_val = os.environ.get(STATE_SPECS_ENV)
        if env_val is None:
            return "sharded"
        mode, from_env = env_val.strip().lower(), True
    if mode not in _STATE_MODES:
        if from_env:
            raise ValueError(
                f"invalid ${STATE_SPECS_ENV}={mode!r} in the environment: "
                f"carried-state mode must be one of {_STATE_MODES} "
                f"(unset ${STATE_SPECS_ENV} to use the default 'sharded')")
        raise ValueError(
            f"carried-state mode must be one of {_STATE_MODES} or 'auto', got {mode!r}")
    return mode


CHUNK_GROWTH_ENV = "REPRO_CHUNK_GROWTH"


def resolve_chunk_growth(growth="auto", *, min_chunk: int = 1, max_rounds: int = 64,
                         max_chunk: int | None = None) -> int:
    """Resolve the chunk-ladder growth factor to a concrete int >= 1.

    An explicit int always wins; 'auto'/None defers to $REPRO_CHUNK_GROWTH,
    then to the calibrated cost model when one is active (which minimizes
    distinct-ladder-size captures + dispatch round trips for THIS
    min_chunk/max_rounds/max_chunk window), then to the default 2.
    """
    from_env = False
    if growth in (None, "auto"):
        env_val = os.environ.get(CHUNK_GROWTH_ENV)
        if env_val is None:
            rec = recommendation("chunk_growth", min_chunk=min_chunk, max_rounds=max_rounds,
                                 max_chunk=max_chunk)
            return 2 if rec is None else int(rec)
        growth, from_env = env_val.strip(), True
    try:
        val = int(growth)
    except (TypeError, ValueError):
        val = 0
    if val < 1:
        if from_env:
            raise ValueError(
                f"invalid ${CHUNK_GROWTH_ENV}={growth!r} in the environment: "
                f"chunk growth must be an integer >= 1 "
                f"(unset ${CHUNK_GROWTH_ENV} to use the default 2)")
        raise ValueError(f"growth must be an integer >= 1 or 'auto', got {growth!r}")
    return val


def resolve_capacity_factor() -> float:
    """Headroom factor of the auto bucket capacity (ceil(n / R) * factor).

    The calibrated cost model's answer when one is active, which departs
    from the default 2.0 only when its calibration carries a
    deployment-measured key skew (an undershot capacity silently drops
    records, so no probe may shrink it); else 2.0.
    """
    rec = recommendation("capacity_factor")
    return 2.0 if rec is None else float(rec)


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


def _round(spec: IterativeSpec, mesh, inputs, state, r, secure, coalesce, info: dict,
           layout: _StateLayout, r_wire=None, *, capacity_factor: float):
    """One round: map, shuffle, reduce. `r` is what the callbacks get (a host
    int, or a device scalar in a graph runner); `r_wire` (default `r`) keys
    the shuffle's keystream. `coalesce` and `capacity_factor` come resolved
    by the runner: a round resolves no knob."""
    mk, mv = spec.map_fn(state, inputs, r)
    if spec.combine_fn is not None:
        mk, mv = spec.combine_fn(mk, mv)
    n_mapped = mk.shape[1]
    capacity = spec.capacity or max(
        1, int(np.ceil(-(-n_mapped // mesh.n_shards) * capacity_factor)))
    info["capacity"], info["capacity_auto"] = capacity, not spec.capacity
    flat_k, flat_v, valid, dropped = shuffle_round(
        mk, mv, mesh, hash_fn=spec.hash_fn, capacity=capacity, secure=secure,
        round_index=r if r_wire is None else r_wire, coalesce=coalesce)
    new_state, aux = spec.reduce_fn(state, flat_k, flat_v, valid, r)
    return layout.keep(new_state), _replica(aux), dropped.sum()


def _run_chunk(spec, mesh, inputs, state, n_rounds: int, first_round: int, secure,
               coalesce, info: dict, layout: _StateLayout, capacity_factor: float):
    """Up to n_rounds rounds; stops after the round whose halt_fn fires.

    Returns (state, [aux per executed round], [dropped per executed round],
    rounds_executed, halted).
    """
    auxes, drops = [], []
    for i in range(n_rounds):
        r = first_round + i
        state, aux, dropped = _round(spec, mesh, inputs, state, r, secure, coalesce, info,
                                     layout, capacity_factor=capacity_factor)
        auxes.append(aux)
        drops.append(dropped)
        if spec.halt_fn is not None and bool(spec.halt_fn(layout.for_halt(state), aux, r)):
            return state, auxes, drops, i + 1, True
    return state, auxes, drops, n_rounds, False


def _with_knobs(secure, coalesce):
    """The secure config with its wire layout resolved to a bool
    (`shuffle.resolve_coalesce`)."""
    if secure is None:
        return None
    return secure.with_coalesce(resolve_coalesce(
        secure.coalesce if coalesce is None else coalesce))


def _on_device(tree, mesh):
    return tree_map(lambda x: torch.as_tensor(x, device=mesh.device), tree)


def _place(spec: IterativeSpec, mesh, inputs, state):
    """The caller's global inputs and state as a round takes them: on the
    mesh's device, inputs and sharded state leaves split over the shards.
    Returns (inputs, carried state, layout)."""
    state = _on_device(state, mesh)
    layout = _StateLayout(spec, state)
    inputs = tree_map(lambda x: mesh.shard(torch.as_tensor(x, device=mesh.device)), inputs)
    return inputs, layout.place(state, mesh), layout


def _stacked(rows: list, n_rounds: int):
    """Per-round values stacked to (n_rounds, ...), zero past the executed ones."""
    pad = n_rounds - len(rows)
    return torch.stack(list(rows) + [torch.zeros_like(rows[0])] * pad)


# --- runners: what a runner cache holds ----------------------------------------


class _EagerRunner:
    """The chunk as a Python loop over eager rounds (the CPU mesh's runner,
    and `run_until`'s chunk without a runner cache): the halt flag is read
    after every round."""

    captures = 0
    pool_bytes = 0

    def __init__(self, spec: IterativeSpec, mesh, secure, n_rounds: int, coalesce=None,
                 capacity_factor: float | None = None):
        self.spec, self.mesh, self.secure, self.n_rounds = spec, mesh, secure, n_rounds
        self.coalesce = resolve_coalesce(coalesce)  # the plaintext wire's layout
        self.capacity_factor = (resolve_capacity_factor() if capacity_factor is None
                                else capacity_factor)
        self.trace_info: dict = {}

    def __call__(self, inputs, state, round_offset: int = 0):
        inputs, carried, layout = _place(self.spec, self.mesh, inputs, state)
        carried, auxes, drops, n_exec, halted = _run_chunk(
            self.spec, self.mesh, inputs, carried, self.n_rounds, int(round_offset),
            self.secure, self.coalesce, self.trace_info, layout, self.capacity_factor)
        aux = tree_map(lambda *xs: _stacked(xs, self.n_rounds), *auxes)
        return (layout.gather(carried, self.mesh), aux, _stacked(drops, self.n_rounds), n_exec,
                halted)


def _shape_key(inputs, carried) -> tuple:
    """The shapes and dtypes a captured round is tied to."""
    return tuple((tuple(t.shape), t.dtype) for t in tree_flatten([inputs, carried])[0])


def _pool_bytes(pool) -> int:
    """Bytes of device memory a CUDA graph memory pool holds."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == pool)


class _Statics:
    """The static buffers that a job's graph runners share for one set of
    input and state shapes, whatever their chunk size: a copy of the inputs,
    the carried state, the round id and the chunk's first round (int64
    scalars), the halt flag, the aux template, the device constants the
    rounds read (`pinned_constants`: block tables, exchange ids, kept alive
    here for as long as the graphs replay), the graphs' memory pool, and the
    captured round of each chunk size (`captured`). A graph reads and writes
    only these (and its own aux rows), so the runners of one spec copy each
    input once per job and replay from one pool.

    Made empty by `ShapeBudget.use` and filled by the first call that holds
    `lock` (`fill`, then the runner's warm-up round: `ready`). One thread at
    a time: a call holds `lock` from the warm-up or `load` through its
    capture and every replay to the clone of its result. Without it two
    threads on one shape (two services on one `RunnerCache`, a fit beside a
    served job) would overwrite each other's inputs, state and round id
    between replays and hand back a wrong result with no error. `users`
    counts the calls holding or waiting for the lock: statics in use are
    never evicted (`ShapeBudget`)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.users = 0
        self.ready = False
        self.constants: dict = {}
        self.aux = self.dropped = self.pool = None
        self.captured: dict = {}  # n_rounds -> _Captured

    def fill(self, src, inputs, carried, layout, device, round_offset: int) -> None:
        self.layout = layout
        self.inputs = tree_map(torch.clone, inputs)
        self._src = [(weakref.ref(t), t._version) for t in src]  # the copy's sources
        self.state = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                              carried)
        # the warm-up round before the first capture runs the job's own first
        # round: its keystream is that round's, which the first replay redraws
        self.r = torch.full((), int(round_offset), dtype=torch.int64, device=device)
        self.base = self.r.clone()
        self.halt = torch.zeros((), dtype=torch.bool, device=device)

    def _holds(self, src) -> bool:
        """Whether the input copy is of these tensors, unmodified since."""
        return len(src) == len(self._src) and all(
            ref() is t and t._version == version for t, (ref, version) in zip(src, self._src))

    def load(self, src, inputs, carried) -> None:
        """Copy the caller's state, and its inputs (`src`: the caller's
        tensors, `inputs`: as sharded) unless the copy is already of them,
        into the static buffers. The copy's sources are tracked by weak
        reference: a source that died, or changed in place, is copied again."""
        if not self._holds(src):
            for dst, x in zip(tree_flatten(self.inputs)[0], tree_flatten(inputs)[0]):
                dst.copy_(x)
            self._src = [(weakref.ref(t), t._version) for t in src]
        for dst, x in zip(tree_flatten(self.state)[0], tree_flatten(carried)[0]):
            dst.copy_(x)


class _Store(dict):
    """A job's graph runners' statics by shape key, shared by the runners of
    its chunk sizes; `budget` is the `ShapeBudget` that counts them."""

    __slots__ = ("budget", "__weakref__")

    def __init__(self, budget: "ShapeBudget"):
        super().__init__()
        self.budget = budget


class ShapeBudget:
    """How many shapes' statics (each with its captured rounds) the graph
    runners of one `repro_torch.serve.RunnerCache` keep on the card: at most
    `limit` (the cache's `max_resident`; None: no bound), the least recently
    used shape first out, never one that a call is using. The cache hands
    its budget to every graph runner it builds (`keep_shapes_within`); a
    runner made alone counts its shapes in an unbounded budget of its own.

    The budget refers to the stores weakly: once a store's runners are all
    dropped (evicted from the cache, or the cache cleared) its statics are
    freed at once and leave the count. Its lock guards the stores' dicts and
    the statics' `users`."""

    def __init__(self, limit: int | None = None):
        self.limit = limit
        self.lock = threading.Lock()
        self._lru: OrderedDict = OrderedDict()  # (id(store), key) -> (weakref(store), key)
        self.evictions = 0

    def __len__(self):
        with self.lock:
            self._prune()
            return len(self._lru)

    def use(self, store: _Store, key) -> _Statics:
        """The statics of `key` in `store`, marked in use and most recently
        used; on a miss new empty ones, which the caller fills under their
        lock (the warm-up runs outside the budget's lock). The caller must
        `release` them."""
        with self.lock:
            st = store.get(key)
            if st is None:
                st = store[key] = _Statics()
            st.users += 1
            self._lru[(id(store), key)] = (weakref.ref(store), key)
            self._lru.move_to_end((id(store), key))
            self._shrink()
            return st

    def release(self, store: _Store, key, st: _Statics) -> None:
        """End a call's use of `st`; statics whose warm-up raised and that no
        other call holds are dropped (the runner keeps nothing of the key)."""
        with self.lock:
            st.users -= 1
            if not st.ready and st.users == 0 and store.get(key) is st:
                del store[key]
                self._lru.pop((id(store), key), None)
            self._shrink()

    def _prune(self) -> None:
        """Forget entries whose store was dropped."""
        for lru_key, (ref, key) in list(self._lru.items()):
            store = ref()
            if store is None or key not in store:
                del self._lru[lru_key]

    def _shrink(self) -> None:
        """Evict least recently used statics not in use until within the limit."""
        self._prune()
        if self.limit is None:
            return
        for lru_key, (ref, key) in list(self._lru.items()):
            if len(self._lru) <= self.limit:
                return
            store = ref()
            if store is None or key not in store:
                del self._lru[lru_key]
            elif store[key].users == 0:
                del store[key]
                del self._lru[lru_key]
                self.evictions += 1


# torch.cuda.graph captures on one shared side stream: one capture at a time
_CAPTURE_LOCK = threading.Lock()


@dataclass
class _Captured:
    """One captured round of a runner for one shape key."""

    graph: Any
    aux: Any  # (n_rounds, ...) rows per aux leaf
    dropped: Any  # (n_rounds,)
    reported: RoundReport  # the wire records and kernel calls made at capture
    pool_bytes: int  # bytes its capture added to the (shared) pool
    trace_info: dict  # the resolved capacity at capture


class _GraphRunner:
    """A CUDA graph of ONE round, replayed up to `n_rounds` times per chunk.

    A graph is tied to the shapes of the inputs and state it was captured
    on: per shape key the runner's store holds one `_Statics` (inputs,
    carried state, round id, halt flag, device constants), which the runners
    of the same job at other chunk sizes share (`share_with`), and in it one
    `_Captured` per chunk size (the graph, its aux and dropped rows). The
    store's `ShapeBudget` (the runner cache's) bounds the shapes kept, least
    recently used out first. Before the first capture of a key one eager
    warm-up round runs on new statics, at the call's own first round: it
    builds the kernels, fills and pins the device constants, fixes the aux
    shapes and runs the halt guard (a sharded leaf touched by `halt_fn`
    raises its ValueError there, and the runner keeps nothing of the key).
    Per round the host writes the round id into a device scalar with `fill_`
    (a launch carrying the value, not a copy from host memory that a later
    write could race) and replays; inside the graph the keystream's u32
    round bits and the aux row (the round id less the chunk's first, written
    once per chunk) come from that scalar, and the callbacks get it as `r`.
    After each replay the host reads the halt flag: one synchronising call
    per executed round, and none in a chunk without `halt_fn`. A call holds
    the statics' lock while it warms them up or copies the caller's state,
    and its inputs when they are not the last call's, into the static
    buffers, replays, and clones fresh tensors out: another job's chunk, on
    this thread or another, may replay this graph next. The shuffle's wire
    record and the kernel calls made at capture are re-emitted for every
    executed round (the capture itself counts none).

    Spans (`repro_torch.tools.opcount.spans`): `driver.capture` (a miss:
    the warm-up and the capture), `driver.load` (the copies into the static
    buffers), `driver.replay` (a round's id written and its graph
    launched), `driver.halt_read` (the sync on the halt flag) and
    `driver.gather` (the clones out at the chunk's end).
    """

    def __init__(self, spec: IterativeSpec, mesh, secure, n_rounds: int, coalesce=None,
                 share_with=None):
        self.spec, self.mesh, self.secure, self.n_rounds = spec, mesh, secure, n_rounds
        self.coalesce = resolve_coalesce(coalesce)  # the plaintext wire's layout
        self.capacity_factor = resolve_capacity_factor()
        self.trace_info: dict = {}
        # shape key -> _Statics, shared by a job's runners and counted by a budget
        self._statics = _Store(ShapeBudget()) if share_with is None else share_with._statics

    def keep_shapes_within(self, budget: ShapeBudget) -> None:
        """Count this runner's shapes (and its job's other runners') in
        `budget`: a runner cache calls this on every runner it builds."""
        self._statics.budget = budget

    def drop_captures(self) -> None:
        """Free this runner's captures (its runner cache evicted it); its
        job's statics stay while another runner of the job shares them."""
        with self._statics.budget.lock:
            for st in self._statics.values():
                st.captured.pop(self.n_rounds, None)

    def _mine(self) -> list:
        with self._statics.budget.lock:
            return [st.captured[self.n_rounds] for st in self._statics.values()
                    if self.n_rounds in st.captured]

    @property
    def captures(self) -> int:
        """CUDA graphs of this chunk size held for the shapes kept."""
        return len(self._mine())

    @property
    def pool_bytes(self) -> int:
        """Bytes those captures added to the shared memory pools."""
        return sum(c.pool_bytes for c in self._mine())

    def _body(self, st: _Statics):
        """One round on the static buffers: (state, aux, dropped, halt)."""
        spec, dev = self.spec, self.mesh.device
        r_wire = to_word_bits(st.r & MASK32).reshape(1)
        state, aux, dropped = _round(spec, self.mesh, st.inputs, st.state, st.r, self.secure,
                                     self.coalesce, self.trace_info, st.layout, r_wire=r_wire,
                                     capacity_factor=self.capacity_factor)
        halt = None
        if spec.halt_fn is not None:
            halt = spec.halt_fn(st.layout.for_halt(state), aux, st.r)
            if not isinstance(halt, torch.Tensor):
                halt = torch.full((), bool(halt), device=dev)
            halt = halt.to(torch.bool).reshape(())
        return state, aux, dropped, halt

    def _warm(self, st: _Statics, src, inputs, carried, layout, round_offset: int) -> None:
        """Fill new statics and run the warm-up round on them."""
        st.fill(src, inputs, carried, layout, self.mesh.device, round_offset)
        with wire_accounting.isolated(), pinned_constants(st.constants):
            _, aux, dropped, _ = self._body(st)  # the warm-up: no round of the job
        st.aux, st.dropped = aux, dropped  # templates of the per-round rows
        st.ready = True

    def _capture(self, st: _Statics) -> _Captured:
        aux_rows = tree_map(lambda a: a.new_zeros((self.n_rounds,) + tuple(a.shape)), st.aux)
        drop_rows = st.dropped.new_zeros((self.n_rounds,))
        before = 0 if st.pool is None else _pool_bytes(st.pool)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, replayable() as reported, pinned_constants(st.constants), \
                torch.cuda.graph(graph, pool=st.pool, capture_error_mode="thread_local"):
            state, aux, dropped, halt = self._body(st)
            row = (st.r - st.base).reshape(1)
            for dst, src in zip(tree_flatten(st.state)[0], tree_flatten(state)[0]):
                dst.copy_(src)
            for dst, src in zip(tree_flatten(aux_rows)[0], tree_flatten(aux)[0]):
                dst.index_copy_(0, row, src.unsqueeze(0))
            drop_rows.index_copy_(0, row, dropped.reshape(1))
            if halt is not None:
                st.halt.copy_(halt)
        st.pool = graph.pool()
        return _Captured(graph, aux_rows, drop_rows, reported, _pool_bytes(st.pool) - before,
                         dict(self.trace_info))

    def __call__(self, inputs, state, round_offset: int = 0):
        spec, mesh = self.spec, self.mesh
        inputs = _on_device(inputs, mesh)
        src = tree_flatten(inputs)[0]
        inputs, carried, layout = _place(spec, mesh, inputs, state)
        key = _shape_key(inputs, carried)
        store = self._statics
        budget = store.budget
        st = budget.use(store, key)
        try:
            with st.lock:
                cap = st.captured.get(self.n_rounds)
                if cap is None:  # new statics have no captures
                    with spans.span("driver.capture"):
                        if not st.ready:
                            self._warm(st, src, inputs, carried, layout, int(round_offset))
                        cap = st.captured[self.n_rounds] = self._capture(st)
                self.trace_info.update(cap.trace_info)
                with spans.span("driver.load"):
                    st.load(src, inputs, carried)
                    st.base.fill_(int(round_offset))
                n_exec, halted = 0, False
                for i in range(self.n_rounds):
                    with spans.span("driver.replay"):
                        st.r.fill_(int(round_offset) + i)
                        cap.graph.replay()
                    n_exec += 1
                    if spec.halt_fn is not None:
                        with spans.span("driver.halt_read"):
                            halted = bool(st.halt)
                        if halted:
                            break
                with spans.span("driver.gather"):
                    out = layout.gather(tree_map(torch.clone, st.state), mesh)
                    aux = tree_map(lambda a: _zero_past(a, n_exec), cap.aux)
                    dropped = _zero_past(cap.dropped, n_exec)
        finally:
            budget.release(store, key, st)
        cap.reported.emit(n_exec)
        return out, aux, dropped, n_exec, halted


def _zero_past(rows, n_exec: int):
    """A fresh copy of per-round rows with the rows past `n_exec` zeroed."""
    out = rows.clone()
    out[n_exec:] = 0
    return out


def make_iterative_runner(spec: IterativeSpec, mesh, secure=None, n_rounds: int | None = None,
                          *, coalesce: bool | None = None, share_with=None):
    """The chunk runner a runner cache holds: built once, called many times.

    Returns runner(inputs, state, round_offset=0) -> (state, aux, dropped,
    rounds_executed, halted), `inputs` and `state` as `run_until` takes them
    (global leaves) and the state returned the same way; aux leaves and
    dropped carry a leading (n_rounds,) dim, zero past rounds_executed.
    `runner.trace_info` holds the resolved capacity after the first call,
    `runner.captures` the CUDA graphs it captured and `runner.pool_bytes`
    their private pool's bytes. `n_rounds` defaults to `spec.n_rounds`.

    On a CUDA mesh the runner is a CUDA graph of one round per shape of
    inputs and state (`_GraphRunner`); on a CPU mesh it is the eager chunk.
    The mesh's device chooses, so the cache contract runs the same on both.
    `share_with`, a runner built from the same spec, mesh, secure and knobs
    for another chunk size, lends its static buffers and memory pool
    (`_Statics`). A graph runner keeps the statics of every shape it is
    called on until its runner cache bounds them (`keep_shapes_within`,
    which `repro_torch.serve.RunnerCache` calls on the runners it builds).
    """
    secure = _with_knobs(secure, coalesce)
    n = spec.n_rounds if n_rounds is None else int(n_rounds)
    if n < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n}")
    if mesh.device.type == "cuda":
        return _GraphRunner(spec, mesh, secure, n, coalesce, share_with)
    return _EagerRunner(spec, mesh, secure, n, coalesce)


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
                            round_offset: int = 0, coalesce: bool | None = None,
                            warn_on_overflow: bool = True):
    """Run `spec.n_rounds` rounds from global round `round_offset`, eagerly.

    Returns (final_state, aux_per_round, dropped_per_round), each per-round
    tensor with a leading (n_rounds,) dim, plus (rounds_executed, halted)
    when `spec.halt_fn` is set; rounds after a halt are zero-filled.
    """
    runner = _EagerRunner(spec, mesh, _with_knobs(secure, coalesce), spec.n_rounds, coalesce)
    state, aux, dropped, n_exec, halted = runner(inputs, init_state, round_offset)
    if warn_on_overflow:
        _warn_overflow(dropped[:n_exec].cpu().numpy(), round_offset, runner.trace_info)
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
                     growth="auto", max_chunk: int | None = None, coalesce: bool | None = None,
                     warn_on_overflow: bool = True, runners=None, job_tag=None):
    """Cooperative (generator) form of `run_until`.

    Yields {"chunk_rounds", "rounds_executed", "n_dispatches", "halted"}
    after every chunk and returns the `RunUntilResult` as StopIteration.value.
    `spec.n_rounds` is ignored: chunk sizes are chosen here.

    `runners`: a runner cache reused across calls -- a plain dict (chunk size
    -> runner) or any object with `get_or_build(n_rounds, build)` (a
    `repro_torch.serve.RunnerCache` or one of its keyed views, which bound
    the shapes their runners keep). The caller owns its validity: it
    must hold runners built from the SAME spec, mesh, secure and knobs. With
    None, every chunk runs the eager loop: a graph replayed once would pay
    its capture and save nothing. `job_tag` wraps each chunk in
    `wire_accounting.tagged`, so interleaved jobs sharing a
    `record_wire_bytes` sink stay separable. The copy of the per-round
    values to the host at the job's end is the span `driver.collect`.
    """
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    growth = resolve_chunk_growth(growth, min_chunk=min_chunk, max_rounds=max_rounds,
                                  max_chunk=max_chunk)
    if min_chunk < 1:
        raise ValueError(f"min_chunk must be >= 1, got {min_chunk}")
    max_chunk = min(max_chunk or max_rounds, max_rounds)
    secure = _with_knobs(secure, coalesce)
    if runners is None:  # the job's eager chunks share the knobs, resolved once
        eager_knobs = (resolve_coalesce(coalesce), resolve_capacity_factor())
    get_or_build = getattr(runners, "get_or_build", None)
    inputs, state = _on_device(inputs, mesh), _on_device(init_state, mesh)
    executed = dispatched = n_dispatches = 0
    halted = False
    auxes: list = []
    drops: list = []
    info: dict = {}
    chunk = min(max(1, min_chunk), max_chunk)
    runner = None
    while executed < max_rounds and not halted:
        n = min(chunk, max_rounds - executed)

        def build(n=n, prev=runner):  # a job's runners share their static buffers
            return make_iterative_runner(spec, mesh, secure, n, coalesce=coalesce,
                                         share_with=prev)

        if runners is None:
            runner = _EagerRunner(spec, mesh, secure, n, *eager_knobs)
        elif get_or_build is not None:
            runner = get_or_build(n, build)
        else:
            runner = runners.get(n)
            if runner is None:
                runner = runners[n] = build()
        with wire_accounting.tagged(job_tag):
            state, aux, dropped, n_exec, halted = runner(inputs, state, round_offset + executed)
        info = runner.trace_info
        auxes.append(tree_map(lambda a: a[:n_exec], aux))
        drops.append(dropped[:n_exec])
        n_dispatches += 1
        dispatched += n
        executed += n_exec
        chunk = min(chunk * growth, max_chunk)
        yield {"chunk_rounds": n, "rounds_executed": executed,
               "n_dispatches": n_dispatches, "halted": halted}

    with spans.span("driver.collect"):
        aux = tree_map(lambda *xs: torch.cat(xs).cpu().numpy(), *auxes)
        dropped = torch.cat(drops).cpu().numpy()
    if warn_on_overflow:
        _warn_overflow(dropped, round_offset, info, stacklevel=4)
    return RunUntilResult(state=state, aux=aux, dropped=dropped, rounds_executed=executed,
                          rounds_dispatched=dispatched, n_dispatches=n_dispatches,
                          halted=halted)
