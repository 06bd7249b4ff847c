"""Keyed polynomial universal MAC over u32 lanes (Carter-Wegman style).

Counterpart of `repro/crypto/mac.py`: an encrypt-then-MAC construction with
a polynomial hash over GF(p), p = 2^31-1, and four independent (r, s) pairs
drawn from the ChaCha20 keystream giving a 4x31-bit tag. A performance-shape
stand-in for Poly1305, as in the reference, not a vetted primitive.

    tag_j = ( sum_i m_i * r_j^(n-i) + s_j ) mod p        m = [n, words...]

The device path (`mac_tag_words`) computes it in `torch.int64` on the
tensor's device as the blocked Horner form of the reference's host path:
a product of two values below 2^31 is below 2^62, exact in int64, so no
16-bit split is needed; the powers of r come by doubling; each level sums
blocks of `BLOCK` words against the powers and hands the block sums, a
message BLOCK times shorter, to the next level with r^BLOCK. Every step is
exact arithmetic mod p, so the tag is the reference's bit for bit, in any
order of summation.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.chacha import MASK32, _chacha20_blocks_np, as_u32

P31 = (1 << 31) - 1
BLOCK = 1024  # words per block of one Horner level


def _mod31(x):
    """Reduce a non-negative int64 tensor mod 2^31-1."""
    return torch.remainder(x, P31)


def _mulmod31(a, b):
    """(a*b) mod 2^31-1 for int64 tensors a, b < 2^31 (the product < 2^62)."""
    return torch.remainder(a * b, P31)


def _powers(r: torch.Tensor, m: int) -> torch.Tensor:
    """(L, m) int64: r^0 .. r^(m-1) mod p per lane, m a power of two, by doubling."""
    e = torch.ones_like(r)[:, None]
    rk = r
    while e.shape[1] < m:
        e = torch.cat([e, _mulmod31(e, rk[:, None])], dim=1)
        rk = _mulmod31(rk, rk)
    return e


def _horner(msg: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sum_i msg_i * r^(len-1-i) mod p, for (len,) int64 msg < p and a (1,) r."""
    while msg.shape[0] > 1:
        b = min(BLOCK, 1 << (msg.shape[0] - 1).bit_length())
        pad = (-msg.shape[0]) % b
        if pad:  # leading zeros contribute nothing to the polynomial
            msg = torch.nn.functional.pad(msg, (pad, 0))
        e = _powers(r, b)[0]  # r^0 .. r^(b-1)
        msg = _mod31(_mulmod31(msg.reshape(-1, b), e.flip(0)).sum(dim=1))
        r = _mulmod31(e[-1:], r)  # r^b
    return msg[0]


def mac_tag_words(words: torch.Tensor, rs, ss) -> torch.Tensor:
    """Tag an (n,) message of u32 words (int32 bit patterns, or any integer
    tensor) with 4 lanes; rs, ss (4,) u32. Returns the (4,) tag as int32 on
    the words' device (every value < 2^31-1). Reads nothing back to the host."""
    dev = words.device
    msg = as_u32(words.reshape(-1))
    n = torch.full((1,), msg.shape[0], dtype=torch.int64, device=dev)
    msg = _mod31(torch.cat([n & MASK32, msg]))
    rs = _mod31(as_u32(rs, dev))
    ss = _mod31(as_u32(ss, dev))
    h = torch.stack([_horner(msg, rs[j:j + 1]) for j in range(4)])
    return _mod31(h + ss).to(torch.int32)


# ---------------------------------------------------------------------------
# numpy host path -- identical tags
# ---------------------------------------------------------------------------


def mac_tag_host(words: np.ndarray, rs: np.ndarray, ss: np.ndarray) -> np.ndarray:
    """Block-vectorized Horner (identical tags to the word-at-a-time form:
    leading zero words contribute nothing to the polynomial)."""
    words = np.asarray(words, dtype=np.uint64).reshape(-1)
    rs = np.asarray(rs, dtype=np.uint64) % np.uint64(P31)
    ss = np.asarray(ss, dtype=np.uint64)
    p = np.uint64(P31)
    msg = np.concatenate([np.array([len(words)], np.uint64), words]) % p

    blk = 64
    pad = (-len(msg)) % blk
    if pad:
        msg = np.concatenate([np.zeros(pad, np.uint64), msg])
    msg = msg.reshape(-1, blk)  # (n_blocks, blk)

    # rp[l, j] = rs[l]^(blk-1-j) mod p ;  r_blk = rs^blk mod p
    rp = np.empty((4, blk), np.uint64)
    rp[:, blk - 1] = 1
    for j in range(blk - 2, -1, -1):
        rp[:, j] = (rp[:, j + 1] * rs) % p
    r_blk = (rp[:, 0] * rs) % p

    h = np.zeros(4, np.uint64)
    for row in msg:
        acc = ((row[None, :] * rp) % p).sum(axis=1) % p  # < 2^31·blk, fits u64
        h = (h * r_blk + acc) % p
    return ((h + ss % p) % p).astype(np.uint32)


def mac_verify_host(words: np.ndarray, rs, ss, tag) -> bool:
    return bool(np.all(mac_tag_host(words, rs, ss) == np.asarray(tag, np.uint32)))


def mac_keys_from_keystream(key_words, nonce_words, counter0):
    """Derive (rs, ss) from one keystream block (host-side numpy)."""
    blk = _chacha20_blocks_np(
        np.asarray(key_words, np.uint32),
        np.array([counter0], np.uint32),
        np.asarray(nonce_words, np.uint32),
    )[0]
    rs = blk[:4] % np.uint32(P31)
    ss = blk[4:8] % np.uint32(P31)
    return rs, ss
