"""Layout wrappers over the one ChaCha20 kernel, and device dispatch.

Counterpart of `repro/kernels/chacha20/ops.py`. Every entry point lowers onto
the same per-(row, block) keystream XOR: a CUDA tensor launches the Hopper
kernel (`kernel.chacha20_xor_rows_cuda`), a CPU tensor runs its plain version
(`ref.chacha20_xor_rows_ref`). The only pad is the one that completes a
partial last block of a flat or per-row stream; it stays inside the wrapper
and never reaches a wire.

`impl` keeps its name for parity with the JAX package: 'auto' lets the
tensor's device decide; 'torch' asks for the plain version and is refused
for a CUDA tensor, where the kernel is the only route.
"""

from __future__ import annotations

import torch

from repro_torch.crypto import ctr as _ctr
from repro_torch.crypto.chacha import CONSTANT_WORDS, as_u32, to_word_bits
from repro_torch.device import resolve_device
from repro_torch.kernels import uses_kernel
from repro_torch.kernels.chacha20.kernel import chacha20_xor_rows_cuda
from repro_torch.kernels.chacha20.ref import chacha20_xor_rows_ref


def _words(v, device) -> torch.Tensor:
    """u32 values (array, tensor or scalar) -> contiguous int32 bits on device."""
    return to_word_bits(as_u32(v, device)).reshape(-1).contiguous()


def make_state0(key_words, nonce_words, counter0, device=None) -> torch.Tensor:
    """The 16-word template state: constants | key | counter | nonce (int32 bits)."""
    device = resolve_device(device)
    parts = [torch.tensor(CONSTANT_WORDS, dtype=torch.int64, device=device),
             as_u32(key_words, device).reshape(-1),
             as_u32(counter0, device).reshape(1),
             as_u32(nonce_words, device).reshape(-1)]
    return to_word_bits(torch.cat(parts))


def _xor_rows(x, state0, nonce_ids, ctr_rows, ctr_base, ctr_rowmul, impl):
    """Dispatch one (n_rows, n_blocks, 16) buffer to the kernel or the plain version."""
    dev = x.device
    args = [_words(v, dev) for v in (state0, nonce_ids, ctr_rows, ctr_base, ctr_rowmul)]
    if uses_kernel(impl, x):
        return chacha20_xor_rows_cuda(x.contiguous(), *args)
    return chacha20_xor_rows_ref(x, *args)


def _block_rows(words: torch.Tensor):
    """(R, n) words -> (R, ceil(n/16), 16), zero-padding the last block."""
    r, n = words.shape
    n_blocks = -(-n // 16)
    pad = n_blocks * 16 - n
    if pad:
        words = torch.cat([words, words.new_zeros((r, pad))], dim=1)
    return words.reshape(r, n_blocks, 16), n_blocks


def chacha20_xor_words(words, state0, *, impl: str = "auto"):
    """XOR a flat (n,) word stream with the keystream starting at state0.

    Block i draws counter state0[12] + i (one row, contiguous counters).
    """
    n = words.shape[0]
    x, n_blocks = _block_rows(words.reshape(1, n))
    if n_blocks == 0:
        return words
    dev = words.device
    s0 = _words(state0, dev)
    y = _xor_rows(x, s0, torch.zeros(1, dtype=torch.int32, device=dev), s0[12:13],
                  torch.arange(n_blocks, device=dev), torch.ones(n_blocks, device=dev,
                                                                 dtype=torch.int64),
                  impl)
    return y.reshape(-1)[:n]


def chacha20_xor_rows(words, state0, nonce_ids, ctr_starts, *, impl: str = "auto"):
    """XOR an (R, n_words) wire with per-row keystreams.

    Row i uses nonce word 0 XOR nonce_ids[i] and block counters starting at
    ctr_starts[i] (absolute; state0[12] is ignored) -- the per-leaf wire.
    """
    r, n = words.shape
    x, n_blocks = _block_rows(words)
    if n_blocks == 0 or r == 0:
        return words
    dev = words.device
    y = _xor_rows(x, state0, nonce_ids, ctr_starts, torch.arange(n_blocks, device=dev),
                  torch.ones(n_blocks, device=dev, dtype=torch.int64), impl)
    return y.reshape(r, -1)[:, :n]


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
    y = _xor_rows(words.reshape(r, n // 16, 16), state0, nonce_ids, ctr_rows,
                  ctr_base, ctr_rowmul, impl)
    return y.reshape(r, n)


def ctr_crypt_array(x, key_words, nonce_words, counter0=0, *, impl: str = "auto"):
    """Encrypt/decrypt an arbitrary-dtype tensor through the kernel (XOR stream)."""
    words, pad = _ctr._to_words(x)
    state0 = make_state0(key_words, nonce_words, counter0, device=x.device)
    out = chacha20_xor_words(words, state0, impl=impl)
    return _ctr._from_words(out, x.shape, x.dtype, pad)
