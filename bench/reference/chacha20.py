"""ChaCha20 per RFC 8439, in plain PyTorch (int64 lanes masked to 32 bits).

State words: 0-3 the constants, 4-11 the key, 12 the block counter, 13-15
the nonce. `keystream(key, nonces, counters)` returns one 64-byte block per
(nonce, counter) pair as 16 u32 words held in int64.
"""

from __future__ import annotations

import torch

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
MASK = 0xFFFFFFFF


def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & MASK


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & MASK
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & MASK
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & MASK
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & MASK
    s[b] = _rotl(s[b] ^ s[c], 7)


def keystream(key_words, nonce_words, counters) -> torch.Tensor:
    """Blocks for broadcastable `nonce_words` (..., 3) and `counters` (...):
    int64 tensors of u32 values. `key_words` is 8 u32 values. Returns (..., 16)."""
    counters = torch.as_tensor(counters, dtype=torch.int64) & MASK
    nonce_words = torch.as_tensor(nonce_words, dtype=torch.int64, device=counters.device) & MASK
    shape = torch.broadcast_shapes(counters.shape, nonce_words.shape[:-1])
    dev = counters.device
    init = [torch.full(shape, c, dtype=torch.int64, device=dev) for c in CONSTANTS]
    init += [torch.full(shape, int(w) & MASK, dtype=torch.int64, device=dev) for w in key_words]
    init.append(counters.expand(shape))
    init += [nonce_words[..., i].expand(shape) for i in range(3)]
    s = [t.clone() for t in init]
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return torch.stack([(a + b) & MASK for a, b in zip(s, init)], dim=-1)


def words_from_bytes(data: bytes) -> list[int]:
    """Little-endian u32 words of a byte string whose length is a multiple of 4."""
    return [int.from_bytes(data[i:i + 4], "little") for i in range(0, len(data), 4)]


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> the same bits as int32 (the wire's word type)."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def xor_bytes(key: bytes, nonce: bytes, counter: int, data: bytes) -> bytes:
    """RFC 8439 §2.4 encryption of `data` from block `counter` on."""
    n_blocks = -(-len(data) // 64)
    ks = keystream(words_from_bytes(key), torch.tensor(words_from_bytes(nonce)),
                   torch.arange(counter, counter + n_blocks))
    stream = b"".join(int(w).to_bytes(4, "little") for w in ks.reshape(-1).tolist())
    return bytes(a ^ b for a, b in zip(data, stream))
