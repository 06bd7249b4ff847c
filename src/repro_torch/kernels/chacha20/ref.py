"""Plain PyTorch versions of the ChaCha20 keystream-XOR kernel.

Computes in int64 with 32-bit masks (see `repro_torch.crypto.chacha`), so
it runs on the CPU build of torch; the CPU tests and `chip_smoke.py` hold
the CUDA kernel to it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.chacha import (
    CONSTANT_WORDS,
    MASK32,
    as_u32,
    chacha20_block_from_state,
    to_word_bits,
    u32_mul,
)


def chacha20_xor_rows_ref(x, state0, nonce_ids, ctr_rows, ctr_base, ctr_rowmul):
    """XOR an (n_rows, n_blocks, 16) int32 buffer with per-(row, block) keystream.

    Row i, block j draws keystream from
      nonce   = state0 nonce with word 0 XOR nonce_ids[i]
      counter = ctr_base[j] + ctr_rowmul[j] * ctr_rows[i]   (mod 2**32)
    and state0[12] is ignored -- the contract of
    `repro.kernels.chacha20.kernel.chacha20_xor_row_lanes`.
    """
    dev = x.device
    s0 = as_u32(state0, dev)
    nid = as_u32(nonce_ids, dev)[:, None, None]
    rows = as_u32(ctr_rows, dev)[:, None, None]
    base = as_u32(ctr_base, dev)[None, :, None]
    mul = as_u32(ctr_rowmul, dev)[None, :, None]
    ctr = (base + u32_mul(mul, rows)) & MASK32  # (n_rows, n_blocks, 1)
    init = [s0[w:w + 1] for w in range(16)]
    init[12] = ctr
    init[13] = s0[13:14] ^ nid
    ks = chacha20_block_from_state(init)[..., 0, :]  # (n_rows, n_blocks, 16)
    return x ^ to_word_bits(ks)


def chacha20_xor_packed_ref(x, table, key_words, nonce_words, counter0, nonce_ids,
                            ctr_rows, round_dev=None):
    """XOR an (n_rows, row_words) packed wire with its keystream.

    `table` is a `table.BlockTable` of (n_blocks, 4) u32 {ctr_base,
    ctr_rowmul, packed_start, n_valid}: block j of row i draws keystream from nonce word 0 XOR
    nonce_ids[i] and counter counter0 + ctr_base[j] + ctr_rowmul[j] *
    ctr_rows[i] (mod 2**32), and its first n_valid[j] words land on the
    packed words packed_start[j] ... `round_dev`, None or one u32 round id
    held in a tensor (int32 bits), is XORed into nonce word 1: the round the
    kernel reads from device memory. Computed as the aligned keystream of
    `chacha20_xor_rows_ref` (XOR with zeros), sliced onto the packed words and
    XORed: the composition the fused kernel replaces.
    """
    dev = x.device
    tab = as_u32(table.words, dev)
    n_rows, row_words = x.shape
    state0 = as_u32(np.concatenate([np.asarray(CONSTANT_WORDS, np.uint64),
                                    np.asarray(key_words, np.uint64).reshape(8), [0],
                                    np.asarray(nonce_words, np.uint64).reshape(3)]), dev)
    if round_dev is not None:
        state0 = torch.cat([state0[:14], state0[14:15] ^ as_u32(round_dev, dev).reshape(1),
                            state0[15:]])
    zeros = torch.zeros((n_rows, tab.shape[0], 16), dtype=torch.int32, device=dev)
    ks = chacha20_xor_rows_ref(zeros, state0, nonce_ids, ctr_rows,
                               (tab[:, 0] + (int(counter0) & MASK32)) & MASK32, tab[:, 1])
    w = torch.arange(16, device=dev)
    keep = w[None, :] < tab[:, 3:4]  # (n_blocks, 16)
    pos = (tab[:, 2:3] + w[None, :])[keep]
    ks_packed = torch.zeros((n_rows, row_words), dtype=torch.int32, device=dev)
    ks_packed[:, pos] = ks[:, keep]
    return x ^ ks_packed


def place_rows_ref(y, place_rows: int = 0):
    """(n_rows, row_words) `y` with its rows where the kernel's placed store
    puts them: the n_rows rows as an (n_rows/R, R) grid, transposed, so row
    s·R + r lands on row r·(n_rows/R) + s (R = `place_rows`; 0 leaves y as
    it is)."""
    n_rows = y.shape[0]
    check_place_rows(n_rows, place_rows)
    if not place_rows:
        return y
    return y.reshape(n_rows // place_rows, place_rows, -1).transpose(0, 1).reshape(n_rows, -1)


def check_place_rows(n_rows: int, place_rows: int) -> None:
    """Refuse a `place_rows` that is negative or does not divide n_rows."""
    if place_rows < 0 or (place_rows and n_rows % place_rows):
        raise ValueError(f"place_rows must be 0 or divide the {n_rows} rows, got {place_rows}")
