"""Word count -- the paper's Listing 1/2 example, on the secure engine.

Counterpart of `repro/core/wordcount.py`. The mapper emits (word, 1), the
combiner sums per key (a local bincount, so the shuffle carries at most |V|
pairs per mapper), `hash(key, rcount)` picks the reducer and the reducer
sums again. "Words" are token ids over a fixed vocabulary. Counts are
float32, as in the reference: exact while every count stays at or below
2**24.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import MapReduceSpec, identity_hash, run_mapreduce
from repro_torch.core.grep import segment_sum


def wordcount(tokens, vocab_size: int, mesh, *, secure=None):
    """Histogram of `tokens` (int32, split over the mesh's shards) over
    [0, vocab_size). Returns (counts (vocab_size,) f32, n_dropped)."""

    def map_fn(keys, values):  # emit (word, 1)
        return keys, values

    def combine_fn(keys, values):  # local bincount -> (vocab, count) pairs
        # as in the reference, a padding token (< 0) counts toward word 0
        counts = segment_sum(values, torch.where(keys >= 0, keys, 0), vocab_size)
        ks = torch.arange(vocab_size, dtype=torch.int32, device=keys.device)
        return torch.where(counts > 0, ks, -1), counts  # empty words: padding

    def reduce_fn(keys, values, valid):  # sum grouped values
        out = segment_sum(values, torch.where(valid, keys, -1), vocab_size)
        return mesh.psum(out)

    spec = MapReduceSpec(map_fn=map_fn, combine_fn=combine_fn, reduce_fn=reduce_fn,
                         hash_fn=identity_hash,  # paper: first byte of key % rcount
                         capacity=-(-vocab_size // mesh.n_shards))
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=mesh.device)
    ones = torch.ones(tokens.shape, dtype=torch.float32, device=mesh.device)
    return run_mapreduce(spec, tokens, ones, mesh, secure=secure)
