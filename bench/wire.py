"""The encrypted shuffle as the benchmark sees it: the session it keys,
the wires it carries, and the keystream that should cover them.

`session` draws the shuffle's key, nonce and first counter from the seed.
`tapped_mesh` is the port's one-card mesh with a tap on its all_to_all: it
hands every int32 wire (an encrypted shuffle's ciphertext) to a callback as
it crosses. `keystream` is the benchmark's own ChaCha20 (RFC 8439) over
the layout `core/shuffle.py` states for a wire of S x S rows: the row that
shard j sent to shard i is encrypted under nonce (word 0 ^ j, word 1 ^
round id, word 2), its blocks counted from a first counter plus i times the
row's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import common
from bench.reference import chacha20 as ref_chacha


def session(seed: int, purpose: str):
    """A SecureShuffleConfig: key, nonce and first counter drawn from the seed."""
    from repro_torch.core.shuffle import SecureShuffleConfig

    rng = np.random.default_rng(common.derive_seed(seed, purpose))
    return SecureShuffleConfig(
        key_words=rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32),
        nonce_words=rng.integers(0, 2**32, 3, dtype=np.uint64).astype(np.uint32),
        counter0=int(rng.integers(0, 2**20)))


def tapped_mesh(n_shards: int, device, on_wire):
    """A VirtualMesh that calls `on_wire(wire)` on each int32 tensor its
    all_to_all produces (S, S, words), on the card or while a CUDA graph
    captures it."""
    from repro_torch.mesh import VirtualMesh

    class TappedMesh(VirtualMesh):
        def all_to_all(self, x):
            out = super().all_to_all(x)
            if out.dtype == torch.int32:
                on_wire(out)
            return out

    return TappedMesh(n_shards, device)


def keystream(secure, shards: int, rounds, first: int, row_blocks: int, blocks: int,
              device) -> torch.Tensor:
    """Keystream words (len(rounds), S*S, blocks*16), int32 bits, of the
    first `blocks` blocks of every received row (i, j) = (i * S + j), whose
    counters start at `first + row_blocks * i`."""
    s = shards
    i = torch.arange(s, device=device).repeat_interleave(s)
    j = torch.arange(s, device=device).repeat(s)
    base = np.asarray(secure.nonce_words, np.int64)
    rr = torch.as_tensor(np.asarray(rounds, np.int64) & 0xFFFFFFFF, device=device)
    nonce = torch.stack(torch.broadcast_tensors(
        j[None, :, None] ^ int(base[0]), rr[:, None, None] ^ int(base[1]),
        torch.full((1, 1, 1), int(base[2]), dtype=torch.int64, device=device)), dim=-1)
    ctr = (int(secure.counter0) + first + row_blocks * i[None, :, None]
           + torch.arange(blocks, device=device)[None, None, :])
    ks = ref_chacha.keystream(np.asarray(secure.key_words, np.int64), nonce, ctr)
    return ref_chacha.as_int32_bits(ks).reshape(len(rounds), s * s, blocks * 16)
