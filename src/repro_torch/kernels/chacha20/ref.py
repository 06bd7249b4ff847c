"""Plain PyTorch version of the ChaCha20 keystream-XOR kernel.

Computes in int64 with 32-bit masks (see `repro_torch.crypto.chacha`), so
it runs on the CPU build of torch; the CPU tests and `chip_smoke.py` hold
the CUDA kernel to it bit for bit.
"""

from __future__ import annotations

from repro_torch.crypto.chacha import (
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
