"""Multi-round streaming grep on the iterative secure driver (virtual mesh).

Counterpart of `repro/core/grep.py`. Mappers scan records for the patterns
and emit (pattern_id, 1) per hit, reducers sum per pattern. Each shard's
corpus is a stream of `n_rounds` chunks: every executed round maps the next
one, selected by a stream CURSOR carried in state (not the global round
index, which a serving session shifts by its `round_offset`), and the
running per-pattern hits ride in the same state. The chunk is gathered at a
device-side index, so a round synchronises only where the driver reads its
halt flag.

Patterns are token ids over a fixed vocabulary (the same modelling of
"words" as `core/wordcount.py`); a hit is an exact token match.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.driver import IterativeSpec, P, run_until
from repro_torch.core.engine import identity_hash


SPILL = 1024  # scratch segments per shard that take the dropped ids


def segment_sum(values, segments, num_segments: int):
    """Per-shard segment sum: (S, M) values by (S, M) ids -> (S, num_segments).

    Ids outside [0, num_segments) are dropped, as `jax.ops.segment_sum` drops
    them; they land, spread by position, in SPILL scratch segments that are
    cut off, so a round whose slots are mostly padding does not pile its
    atomics onto one address. On the card `index_add_` adds with float
    atomics in no fixed order; the callers (grep's and wordcount's reduces,
    and wordcount's combiner) add integer-valued float32 whose every partial
    sum stays at or below 2**24, where any order gives the same bits as the
    reference's.
    """
    s, m = segments.shape
    width = num_segments + SPILL
    dev = segments.device
    inside = (segments >= 0) & (segments < num_segments)
    spill = num_segments + torch.arange(m, device=dev) % SPILL
    ids = torch.where(inside, segments.to(torch.int64), spill)
    ids = ids + width * torch.arange(s, device=dev)[:, None]
    out = torch.zeros((s * width,), dtype=values.dtype, device=dev)
    out.index_add_(0, ids.reshape(-1), values.reshape(-1))
    return out.reshape(s, width)[:, :num_segments]


def make_grep_spec(patterns, chunk: int, mesh, *, max_matches: int | None = None
                   ) -> IterativeSpec:
    """Driver spec: state = {"hits": running (n_patterns,) f32 counts,
    "cursor": () int64 stream position} -- both replicated.

    The cursor advances by one per EXECUTED round (halted rounds advance
    neither the cursor nor the keystream), so the spec serves any
    `round_offset`. `max_matches` installs a `grep -m` halt: stop once the
    total hit count (summed over patterns) reaches the limit. Tokens < 0 are
    padding: they match no pattern and never enter the shuffle.
    """
    patterns = torch.as_tensor(patterns, dtype=torch.int32, device=mesh.device)
    n_pat = patterns.shape[0]
    offsets = torch.arange(chunk, device=mesh.device)

    def map_fn(state, inputs, r):
        t = inputs["t"]
        # the chunk at a device-side index; the start clamps as
        # lax.dynamic_slice clamps it
        start = torch.clamp(state["cursor"] * chunk, 0, t.shape[1] - chunk)
        toks = torch.index_select(t, 1, start + offsets)
        # pattern id per token (the first match), -1 (padding) where none does
        eq = toks[..., None] == patterns
        pid = torch.where(torch.any(eq, dim=-1), torch.argmax(eq.to(torch.uint8), dim=-1), -1)
        return pid.to(torch.int32), {"one": torch.ones(toks.shape, dtype=torch.float32,
                                                       device=toks.device)}

    def reduce_fn(state, rk, rv, valid, r):
        hits = segment_sum(rv["one"], torch.where(valid, rk, -1), n_pat)
        hits = mesh.psum(hits)
        new_state = {"hits": state["hits"] + hits, "cursor": (state["cursor"] + 1).expand(
            rk.shape[0])}
        return new_state, {"round_hits": hits}

    halt_fn = None
    if max_matches is not None:
        limit = float(np.float32(max_matches))  # a host float: no copy to the card

        def halt_fn(state, aux, r):
            return torch.sum(state["hits"]) >= limit

    return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn,
                         hash_fn=identity_hash,  # reducer = pattern_id % R
                         capacity=chunk,  # lossless: a chunk may be all one pattern
                         halt_fn=halt_fn, state_specs=P())


def grep_count(tokens, patterns, mesh, *, secure=None, n_rounds: int = 4,
               max_matches: int | None = None, coalesce: bool | None = None):
    """Count occurrences of each pattern token in `tokens` (int32, split
    over the mesh's shards).

    Each shard's stream is cut into `n_rounds` chunks, one per round.
    Returns (counts (n_patterns,) f32 tensor, per_round_hits
    (rounds_executed, n_patterns) numpy, dropped (rounds_executed,) numpy).
    Without `max_matches` the whole stream is one dispatch; with it the job
    starts at one round and grows its chunks, and stops the round the total
    hit count reaches the limit.
    """
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=mesh.device)
    n = tokens.shape[0]
    r = mesh.n_shards
    n_loc = n // r
    if n != n_loc * r or n_loc % n_rounds != 0:
        raise ValueError(f"n={n} must split into {r} shards x {n_rounds} chunks")
    chunk = n_loc // n_rounds
    patterns = torch.as_tensor(patterns, dtype=torch.int32, device=mesh.device)
    spec = make_grep_spec(patterns, chunk, mesh, max_matches=max_matches)
    init = {"hits": torch.zeros(patterns.shape, dtype=torch.float32, device=mesh.device),
            "cursor": torch.zeros((), dtype=torch.int64, device=mesh.device)}
    res = run_until(spec, {"t": tokens}, init, mesh, secure=secure, max_rounds=n_rounds,
                    min_chunk=n_rounds if max_matches is None else 1, coalesce=coalesce)
    return res.state["hits"], res.aux["round_hits"], res.dropped
