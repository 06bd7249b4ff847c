"""ChaCha20 (RFC 8439): a tensor implementation and a numpy host path.

State (16 u32 words):
    0..3   constants "expa" "nd 3" "2-by" "te k"
    4..11  key (8 words, little-endian)
    12     block counter
    13..15 nonce (3 words, little-endian)

The tensor path computes in int64 with every add and shift masked to 32
bits: torch's CPU build has no `+`, `<<` or `>>` for uint32, and `>>` on
int32 is arithmetic, so a rotate written in either silently or loudly fails.
Results are returned as int32 tensors that carry the u32 bit patterns.
`chacha20_block_from_state` is the one ARX core shared with the plain
version of the Hopper kernel (`repro_torch.kernels.chacha20.ref`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

CONSTANT_WORDS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

# Quarter-round schedule: 4 column rounds then 4 diagonal rounds.
_QR_SCHEDULE = (
    (0, 4, 8, 12),
    (1, 5, 9, 13),
    (2, 6, 10, 14),
    (3, 7, 11, 15),
    (0, 5, 10, 15),
    (1, 6, 11, 12),
    (2, 7, 8, 13),
    (3, 4, 9, 14),
)

MASK32 = 0xFFFFFFFF


def key_to_words(key: bytes) -> np.ndarray:
    """32-byte key -> (8,) u32 little-endian words."""
    if len(key) != 32:
        raise ValueError(f"ChaCha20 key must be 32 bytes, got {len(key)}")
    return np.frombuffer(key, dtype="<u4").copy()


def nonce_to_words(nonce: bytes) -> np.ndarray:
    """12-byte nonce -> (3,) u32 little-endian words."""
    if len(nonce) != 12:
        raise ValueError(f"ChaCha20 nonce must be 12 bytes, got {len(nonce)}")
    return np.frombuffer(nonce, dtype="<u4").copy()


# ---------------------------------------------------------------------------
# u32 arithmetic on int64 tensors
# ---------------------------------------------------------------------------


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer array, tensor or scalar -> int64 tensor in [0, 2**32)."""
    if isinstance(x, torch.Tensor):
        t = x.to(device) if device is not None else x
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        return t.to(torch.int64) & MASK32
    a = np.asarray(x)
    if a.dtype.kind == "u":
        a = a.astype(np.uint64).astype(np.int64)
    return torch.as_tensor(a.astype(np.int64), device=device) & MASK32


def to_word_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 tensor holding the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def u32_mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 operands in [0, 2**32), without overflow.

    The product is split at 16 bits so no partial product reaches 2**63.
    """
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x, n: int):
    return ((x << n) & MASK32) | (x >> (32 - n))


def chacha20_block_from_state(init: list) -> torch.Tensor:
    """20 ARX rounds + feed-forward over 16 broadcastable int64 state words.

    Returns (..., 16) int64 keystream words in serialization order.
    """
    shape = torch.broadcast_shapes(*(t.shape for t in init))
    init = [t.expand(shape) for t in init]
    xs = list(init)
    for _ in range(10):
        for a, b, c, d in _QR_SCHEDULE:
            xa, xb, xc, xd = xs[a], xs[b], xs[c], xs[d]
            xa = (xa + xb) & MASK32
            xd = _rotl(xd ^ xa, 16)
            xc = (xc + xd) & MASK32
            xb = _rotl(xb ^ xc, 12)
            xa = (xa + xb) & MASK32
            xd = _rotl(xd ^ xa, 8)
            xc = (xc + xd) & MASK32
            xb = _rotl(xb ^ xc, 7)
            xs[a], xs[b], xs[c], xs[d] = xa, xb, xc, xd
    return torch.stack([(x + x0) & MASK32 for x, x0 in zip(xs, init)], dim=-1)


def _words_of(x, device) -> list:
    """u32 words as int64 (1,) tensors on `device`. Host words become
    scalar multiples of a device one (a fill, not a host-to-device copy, so
    a crypt on the card with host key material never synchronises)."""
    if isinstance(x, torch.Tensor):
        t = as_u32(x, device).reshape(-1)
        return [t[i:i + 1] for i in range(t.shape[0])]
    one = torch.ones((1,), dtype=torch.int64, device=device)
    return [one * int(w) for w in np.asarray(x).astype(np.uint64).reshape(-1) & MASK32]


def chacha20_block_words(key_words, counters, nonce_words, device=None) -> torch.Tensor:
    """Vectorized ChaCha20 block function.

    Args:
      key_words:   (8,)  u32
      counters:    (B,)  u32 -- one block counter per output block
      nonce_words: (3,)  u32
      device:      where to compute; defaults to `counters`' device when it
                   is a tensor, else the card (see `resolve_device`)

    Returns: (B, 16) int32 keystream words (u32 bits, serialization order).
    """
    if device is None and isinstance(counters, torch.Tensor):
        device = counters.device
    device = resolve_device(device)
    ctr = as_u32(counters, device)
    one = torch.ones((1,), dtype=torch.int64, device=device)
    init = [one * w for w in CONSTANT_WORDS]
    init += _words_of(key_words, device)
    init.append(ctr)
    init += _words_of(nonce_words, device)
    return to_word_bits(chacha20_block_from_state(init))


def chacha20_keystream_words(key_words, nonce_words, counter0, n_words: int,
                             device=None) -> torch.Tensor:
    """Keystream of `n_words` words starting at block counter `counter0` (a
    host int or a 0-d tensor, never read back to the host)."""
    device = resolve_device(device)
    n_blocks = -(-n_words // 16)
    blocks = torch.arange(n_blocks, device=device)
    if isinstance(counter0, torch.Tensor):
        counters = (as_u32(counter0, device) + blocks) & MASK32
    else:
        counters = (blocks + (int(counter0) & MASK32)) & MASK32
    ks = chacha20_block_words(key_words, counters, nonce_words, device=device)
    return ks.reshape(-1)[:n_words]


# ---------------------------------------------------------------------------
# numpy host path (pub/sub wire encryption; no device involvement)
# ---------------------------------------------------------------------------


def _chacha20_blocks_np(key_words: np.ndarray, counters: np.ndarray, nonce_words: np.ndarray) -> np.ndarray:
    b = counters.shape[0]
    xs = np.empty((16, b), dtype=np.uint32)
    for i, w in enumerate(CONSTANT_WORDS):
        xs[i] = w
    for i in range(8):
        xs[4 + i] = key_words[i]
    xs[12] = counters
    for i in range(3):
        xs[13 + i] = nonce_words[i]
    init = xs.copy()

    def rotl(x, n):
        return (x << np.uint32(n)) | (x >> np.uint32(32 - n))

    with np.errstate(over="ignore"):
        for _ in range(10):
            for a, bq, c, d in _QR_SCHEDULE:
                xs[a] += xs[bq]
                xs[d] = rotl(xs[d] ^ xs[a], 16)
                xs[c] += xs[d]
                xs[bq] = rotl(xs[bq] ^ xs[c], 12)
                xs[a] += xs[bq]
                xs[d] = rotl(xs[d] ^ xs[a], 8)
                xs[c] += xs[d]
                xs[bq] = rotl(xs[bq] ^ xs[c], 7)
        xs += init
    return xs.T  # (B, 16)


def chacha20_encrypt_bytes(key: bytes, nonce: bytes, counter0: int, data: bytes) -> bytes:
    """Host-side ChaCha20-CTR over raw bytes (encrypt == decrypt)."""
    kw = key_to_words(key)
    nw = nonce_to_words(nonce)
    n = len(data)
    n_blocks = -(-n // 64) if n else 0
    if n_blocks == 0:
        return b""
    counters = (np.uint32(counter0) + np.arange(n_blocks, dtype=np.uint32)).astype(np.uint32)
    ks = _chacha20_blocks_np(kw, counters, nw)  # (B, 16) u32
    ks_bytes = ks.astype("<u4").tobytes()[:n]
    buf = np.frombuffer(data, dtype=np.uint8) ^ np.frombuffer(ks_bytes, dtype=np.uint8)
    return buf.tobytes()
