"""Secure MapReduce engine on the virtual mesh: one round per call.

Counterpart of `repro/core/engine.py`:

    split (sharded input, leading shard dim S)
      └─ map_fn        per shard, batched over S ("mapper enclave")
      └─ combine_fn    optional local pre-aggregation (paper's combiner)
      └─ bucket_pack   hash(key) % R  ->  (S, R, C, ...) send buffers
      └─ keyed_all_to_all   [+ ChaCha20 on the wire in secure mode]
      └─ reduce_fn     per shard over received pairs ("reducer enclave")

User functions take and return tensors with the leading shard dim and reach
collectives through the `VirtualMesh` they close over. `run_mapreduce_until`
repeats such a job through the iterative driver until its halt predicate
fires.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.shuffle import bucket_pack, keyed_all_to_all
from repro_torch.crypto.chacha import as_u32, u32_mul
from repro_torch.tree import tree_map


def default_hash(keys):
    """Knuth multiplicative mix in u32 -- the paper's `hash(key, rcount)` slot.
    Returns int64 values in [0, 2**32)."""
    return u32_mul(as_u32(keys), 2654435761) >> 1


def identity_hash(keys):
    return as_u32(keys)


@dataclass(frozen=True)
class MapReduceSpec:
    """A MapReduce job over fixed-shape shards.

    map_fn(keys, values)            -> (mapped_keys, mapped_values)
    combine_fn(keys, values)        -> (keys, values)  [optional, local]
    reduce_fn(keys, values, valid)  -> per-shard output (S, ...)
    hash_fn(keys) -> u32            destination = hash_fn(k) % R
    capacity: per-destination slots C; 0 -> ceil(n_mapped / R) * 2.
    """

    map_fn: Callable
    reduce_fn: Callable
    combine_fn: Callable | None = None
    hash_fn: Callable = default_hash
    capacity: int = 0


def shuffle_round(mk, mv, mesh, *, hash_fn, capacity: int, secure, round_index=None,
                  coalesce=None):
    """bucket_pack + keyed_all_to_all of one round's mapped pairs.

    Returns (flat_k (S, R*C), flat_v, valid, n_dropped (S,)).
    """
    s = mesh.n_shards
    bucket = (hash_fn(mk) % s).to(torch.int32)
    bk, bv, dropped = bucket_pack(mk, bucket, mv, s, capacity)
    recv = keyed_all_to_all({"k": bk, "v": bv}, mesh, secure, round_index=round_index,
                            coalesce=coalesce)
    flat_k = recv["k"].reshape(s, -1)
    flat_v = tree_map(lambda x: x.reshape((s, -1) + tuple(x.shape[3:])), recv["v"])
    return flat_k, flat_v, flat_k >= 0, dropped


def run_mapreduce(spec: MapReduceSpec, keys, values, mesh, secure=None,
                  out_specs: str = "replicated", coalesce: bool | None = None):
    """Run one round over the mesh's shards. `keys` (N,) and `values`
    (leaves (N, ...)) are global tensors split on their leading dim.

    `out_specs` 'replicated' returns shard 0's output (reduce_fn must end in
    a collective, as under JAX's `P()`); 'sharded' concatenates the shards.
    Returns (output, n_dropped) -- n_dropped must be 0 for a lossless job.
    """
    if secure is not None:
        secure = secure.with_coalesce(coalesce)
    keys = mesh.shard(torch.as_tensor(keys, device=mesh.device))
    values = tree_map(lambda v: mesh.shard(torch.as_tensor(v, device=mesh.device)), values)
    mk, mv = spec.map_fn(keys, values)
    if spec.combine_fn is not None:
        mk, mv = spec.combine_fn(mk, mv)
    n_mapped = mk.shape[1]
    capacity = spec.capacity or max(1, -(-n_mapped // mesh.n_shards) * 2)
    flat_k, flat_v, valid, dropped = shuffle_round(
        mk, mv, mesh, hash_fn=spec.hash_fn, capacity=capacity, secure=secure,
        coalesce=coalesce)
    out = spec.reduce_fn(flat_k, flat_v, valid)
    if out_specs == "replicated":
        out = tree_map(lambda x: x[0], out)
    elif out_specs == "sharded":
        out = tree_map(mesh.unshard, out)
    else:
        raise ValueError(f"out_specs must be 'replicated' or 'sharded', got {out_specs!r}")
    return out, dropped.sum()


def run_mapreduce_until(spec: MapReduceSpec, keys, values, init_state, mesh, *, halt_fn,
                        fold_fn=None, max_rounds: int = 16, secure=None,
                        coalesce: bool | None = None, min_chunk: int = 1, growth=2,
                        max_chunk: int | None = None):
    """Repeat a single-round MapReduce job until `halt_fn` says stop.

    Lifts `spec` into the iterative driver (`repro_torch.core.driver.run_until`):
    every round re-maps the same sharded (keys, values), reduces per shard,
    folds the round's reduce output into the carried state with
    `fold_fn(state, round_output)` (default: the output replaces the state),
    then evaluates `halt_fn(state, round_output, round_index)` on the folded
    state. Secure rounds draw disjoint keystreams as every driver round does.
    `spec.reduce_fn` must end in a collective, and `fold_fn` must keep the
    state replicated: the lifted job's state is `P()`.

    Returns the driver's `RunUntilResult` (state, per-round aux = the raw
    reduce outputs, rounds executed vs dispatched, halted).
    """
    # local import: the driver imports this module for default_hash
    from repro_torch.core.driver import IterativeSpec, P, run_until

    def map_fn(state, inputs, r):
        return spec.map_fn(inputs["k"], inputs["v"])

    def reduce_fn(state, rk, rv, valid, r):
        out = spec.reduce_fn(rk, rv, valid)
        return (out if fold_fn is None else fold_fn(state, out)), out

    ispec = IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, combine_fn=spec.combine_fn,
                          hash_fn=spec.hash_fn, capacity=spec.capacity, halt_fn=halt_fn,
                          state_specs=P())
    return run_until(ispec, {"k": keys, "v": values}, init_state, mesh, secure=secure,
                     max_rounds=max_rounds, min_chunk=min_chunk, growth=growth,
                     max_chunk=max_chunk, coalesce=coalesce)
