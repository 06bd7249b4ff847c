"""Layout wrappers over the one ChaCha20 kernel, and device dispatch.

Counterpart of `repro/kernels/chacha20/ops.py`. Every entry point lowers onto
the same keystream XOR of a (n_rows, row_words) word wire placed by a
per-block table {ctr_base, ctr_rowmul, packed_start, n_valid}: a CUDA tensor
launches the Hopper kernel (`kernel.chacha20_xor_packed_cuda`), a CPU tensor
runs its plain version (`ref.chacha20_xor_packed_ref`). The row-aligned entry
points use the table {j, 1, 16j, min(16, n - 16j)}, so a partial last block
is cut in the kernel and nothing is padded; the coalesced shuffle builds its
table once per wire layout (`repro_torch.core.shuffle`).

Key, nonce and counter0 are host values, passed to the kernel by value (a
device counter0 enters `ctr_crypt_array` as the row's counter start). The
entry points that take a 16-word `state0` read it on the host: a state0 on
the card costs one copy back (they are not on the shuffle's path).

`impl` keeps its name for parity with the JAX package: 'auto' lets the
tensor's device decide; 'torch' asks for the plain version and is refused
for a CUDA tensor, where the kernel is the only route.

A tensor that is not on the card goes through the operator
`torch.ops.repro_torch.chacha20_xor_packed`: its CPU implementation is the
plain version, and its fake (shape-only) implementation gives an abstract
run on the `meta` device the output's shape (`repro_torch.launch.dryrun`).
A CUDA tensor calls the kernel's wrapper directly: through the operator's
dispatch a warm crypt call took 0.060-0.099 ms of host time on an H100
against 0.026-0.035 ms direct.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.crypto import ctr as _ctr
from repro_torch.crypto.chacha import CONSTANT_WORDS, as_u32, to_word_bits
from repro_torch.device import device_constant, resolve_device
from repro_torch.kernels import kernel_calls, uses_kernel
from repro_torch.kernels.chacha20.kernel import chacha20_xor_packed_cuda, params_words
from repro_torch.kernels.chacha20.ref import (
    check_place_rows,
    chacha20_xor_packed_ref,
    place_rows_ref,
)
from repro_torch.kernels.chacha20.table import BlockTable, block_table, host_u32, row_table


def ids_on(v, device) -> torch.Tensor:
    """Per-row ids as contiguous int32 bits on `device`; an int32 tensor
    already there passes through without a device operation."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.int32 and v.device == device \
            and v.dim() == 1 and v.is_contiguous():
        return v
    return to_word_bits(as_u32(v, device)).reshape(-1).contiguous()


@functools.lru_cache(maxsize=16)
def _zero_id(device) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=device)


_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("chacha20_xor_packed(Tensor x, Tensor table, bool aligned, int[] params, "
            "Tensor nonce_ids, Tensor ctr_rows, Tensor? round_dev, int place_rows) -> Tensor")


def _xor_packed_cpu(x, table, aligned, params, nonce_ids, ctr_rows, round_dev, place_rows):
    return place_rows_ref(chacha20_xor_packed_ref(x, BlockTable(table, aligned), params[:8],
                                                  params[8:11], params[11], nonce_ids,
                                                  ctr_rows, round_dev=round_dev), place_rows)


_lib.impl("chacha20_xor_packed", _xor_packed_cpu, "CPU")


@torch.library.register_fake("repro_torch::chacha20_xor_packed")
def _(x, table, aligned, params, nonce_ids, ctr_rows, round_dev, place_rows):
    check_place_rows(x.shape[0], place_rows)
    return torch.empty_like(x)


def chacha20_xor_packed(x, table, key_words, nonce_words, counter0, nonce_ids, ctr_rows,
                        *, impl: str = "auto", round_dev=None, place_rows: int = 0):
    """XOR an (n_rows, row_words) int32 wire with the keystream its table places.

    Block j of row i uses nonce word 0 XOR nonce_ids[i] and counter counter0
    + ctr_base[j] + ctr_rowmul[j] · ctr_rows[i] (mod 2**32) and XORs its first
    n_valid[j] words onto words packed_start[j]... of row i. `round_dev`
    (None, or one round id as a tensor on x's device; an int32 one is taken
    as u32 bits, any other integer masked to 32 bits) is XORed into nonce
    word 1 on the device. `place_rows` R (0, or a divisor of n_rows) stores
    the rows as an (n_rows/R, R) grid transposed: row s·R + r's result at row
    r·(n_rows/R) + s, its keystream still row s·R + r's
    (`ref.place_rows_ref`).
    """
    kernel_calls.note("chacha20_xor_packed")
    dev = x.device
    nonce_ids, ctr_rows = ids_on(nonce_ids, dev), ids_on(ctr_rows, dev)
    if round_dev is not None:
        round_dev = ids_on(round_dev.reshape(1), dev)
    if uses_kernel(impl, x):
        return chacha20_xor_packed_cuda(x.contiguous(), table, key_words, nonce_words,
                                        counter0, nonce_ids, ctr_rows, round_dev=round_dev,
                                        place_rows=place_rows)
    params = [int(v) for v in params_words(key_words, nonce_words, counter0)]  # key, nonce, ctr
    return torch.ops.repro_torch.chacha20_xor_packed(x, table.words, table.aligned, params,
                                                     nonce_ids, ctr_rows, round_dev,
                                                     place_rows)


def make_state0(key_words, nonce_words, counter0, device=None) -> torch.Tensor:
    """The 16-word template state: constants | key | counter | nonce (int32 bits)."""
    device = resolve_device(device)
    parts = [torch.tensor(CONSTANT_WORDS, dtype=torch.int64, device=device),
             as_u32(key_words, device).reshape(-1),
             as_u32(counter0, device).reshape(1),
             as_u32(nonce_words, device).reshape(-1)]
    return to_word_bits(torch.cat(parts))


def _split_state0(state0):
    """(key (8,), nonce (3,), counter) host words of a 16-word state0."""
    s = host_u32(state0).reshape(16)
    return s[4:12], s[13:16], int(s[12])


def chacha20_xor_words(words, state0, *, impl: str = "auto"):
    """XOR a flat (n,) word stream with the keystream starting at state0.

    Block i draws counter state0[12] + i (one row, contiguous counters).
    """
    key, nonce, counter0 = _split_state0(state0)
    return _xor_flat(words, key, nonce, counter0, impl)


def _xor_flat(words, key, nonce, counter0, impl, counter_dev=None):
    """One row, block j at counter0 + j; `counter_dev` (a device counter)
    enters as the row's counter start, which the row table adds to every
    block (ctr_rowmul 1), so it is never read on the host."""
    n = words.shape[0]
    if n == 0:
        return words
    dev = words.device
    zero = device_constant(_zero_id, dev)
    rows = zero if counter_dev is None else counter_dev
    return chacha20_xor_packed(words.reshape(1, n), device_constant(row_table, n, dev), key,
                               nonce, counter0, zero, rows, impl=impl).reshape(n)


def chacha20_xor_rows(words, state0, nonce_ids, ctr_starts, *, impl: str = "auto",
                      round_dev=None):
    """XOR an (R, n_words) wire with per-row keystreams.

    Row i uses nonce word 0 XOR nonce_ids[i] and block counters starting at
    ctr_starts[i] (absolute; state0[12] is ignored) -- the per-leaf wire.
    `round_dev` is XORed into nonce word 1 on the device, as in
    `chacha20_xor_packed`.
    """
    r, n = words.shape
    if n == 0 or r == 0:
        return words
    key, nonce, _ = _split_state0(state0)
    return chacha20_xor_packed(words, device_constant(row_table, n, words.device), key, nonce,
                               0, nonce_ids, ctr_starts, impl=impl, round_dev=round_dev)


def chacha20_xor_rows_coalesced(words, state0, nonce_ids, ctr_rows, ctr_base,
                                ctr_rowmul, *, impl: str = "auto"):
    """XOR an (R, 16·n_blocks) coalesced wire with per-row keystreams.

    Block j of row i draws keystream from nonce word 0 XOR nonce_ids[i] and
    counter ctr_base[j] + ctr_rowmul[j] · ctr_rows[i] (absolute). n_words
    must be a multiple of 16: the keystream layout is block-aligned.
    """
    r, n = words.shape
    if n % 16:
        raise ValueError(f"coalesced wire must be block-aligned, got n_words={n}")
    if n == 0 or r == 0:
        return words
    key, nonce, _ = _split_state0(state0)
    j = np.arange(n // 16, dtype=np.int64)
    table = block_table(ctr_base, ctr_rowmul, 16 * j, np.full_like(j, 16), words.device)
    return chacha20_xor_packed(words, table, key, nonce, 0, nonce_ids, ctr_rows, impl=impl)


def ctr_crypt_array(x, key_words, nonce_words, counter0=0, *, impl: str = "auto"):
    """Encrypt/decrypt an arbitrary-dtype tensor through the kernel (XOR stream).

    `counter0` is a host int, or a 0-d tensor (a counter kept on the card)
    that reaches the kernel from device memory: one launch either way.
    """
    words, pad = _ctr._to_words(x)
    key, nonce = host_u32(key_words), host_u32(nonce_words)
    if isinstance(counter0, torch.Tensor):
        out = _xor_flat(words, key, nonce, 0, impl, ids_on(counter0.reshape(1), words.device))
    else:
        out = _xor_flat(words, key, nonce, int(counter0), impl)
    return _ctr._from_words(out, x.shape, x.dtype, pad)
