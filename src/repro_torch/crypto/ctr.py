"""Counter-mode encryption of tensors and pytrees of tensors.

Arbitrary-dtype tensors are bitcast to 32-bit words, XORed with the ChaCha20
keystream and bitcast back; encryption and decryption are the same XOR.
Narrow dtypes (1 or 2 bytes) pack little-endian into words, element i of a
word at bit 8·width·i, which on a little-endian machine is exactly the
tensor's memory viewed as int32 -- the same words `repro.crypto.ctr` builds
with shifts. A tensor whose element count does not fill its last word is
padded with zeros (`pad_for`), and the pad is dropped on the way back.

Counter-space layout: every logical payload gets a distinct (nonce,
counter0) pair; within a payload, block counters increase sequentially.
Pytrees allocate disjoint counter ranges per leaf, in JAX's leaf order.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.crypto.chacha import chacha20_keystream_words
from repro_torch.tree import tree_flatten, tree_unflatten

WORD = torch.int32  # the wire's word type: u32 bit patterns


def words_for(shape, dtype) -> int:
    """Number of 32-bit keystream words needed to cover an array."""
    nbytes = math.prod(shape) * dtype.itemsize
    return -(-nbytes // 4)


def pad_for(shape, dtype) -> int:
    """Narrow-element pad count `_to_words` uses for this shape."""
    width = dtype.itemsize
    if width >= 4:
        return 0
    return (-math.prod(shape)) % (4 // width)


def _to_words(x: torch.Tensor, lead: int = 0):
    """Bitcast + pack into int32 words, independently per leading-dim row.

    `lead` leading dims are kept: the result is (*x.shape[:lead], n_words)
    where n_words = words_for(x.shape[lead:]). Returns (words, pad).
    """
    lead_shape = tuple(x.shape[:lead])
    width = x.dtype.itemsize
    flat = x.contiguous().reshape(lead_shape + (math.prod(x.shape[lead:]),))
    pad = pad_for(x.shape[lead:], x.dtype)
    if pad:
        flat = torch.cat(
            [flat, torch.zeros(lead_shape + (pad,), dtype=x.dtype, device=x.device)], dim=-1)
    if width == 1 and x.dtype != torch.uint8:
        flat = flat.view(torch.uint8)
    return flat.contiguous().view(WORD), pad


def _from_words(words: torch.Tensor, shape, dtype, pad: int, lead: int = 0):
    """Inverse of `_to_words`: (*lead, n_words) int32 -> (*lead, *shape)."""
    lead_shape = tuple(words.shape[:lead])
    out_shape = lead_shape + tuple(shape)
    words = words.contiguous()
    if dtype.itemsize == 1 and dtype != torch.uint8:
        narrow = words.view(torch.uint8)
    else:
        narrow = words.view(dtype)
    if pad:
        narrow = narrow[..., :-pad]
    if narrow.dtype != dtype:
        narrow = narrow.contiguous().view(dtype)
    return narrow.reshape(out_shape)


def encrypt_array(x: torch.Tensor, key_words, nonce_words, counter0) -> torch.Tensor:
    """XOR `x` with the ChaCha20 keystream; same shape and dtype back."""
    words, pad = _to_words(x)
    ks = chacha20_keystream_words(key_words, nonce_words, counter0, words.shape[0],
                                  device=x.device)
    return _from_words(words ^ ks, x.shape, x.dtype, pad)


decrypt_array = encrypt_array  # CTR: same operation


def encrypt_tree(tree: Any, key_words, nonce_words, counter0=0):
    """Encrypt every leaf with disjoint counter ranges. Returns (tree, next ctr).

    The same call decrypts (XOR). Counter ranges are assigned in leaf order,
    so both sides derive identical layouts from the structure alone.
    """
    leaves, treedef = tree_flatten(tree)
    out = []
    ctr = int(counter0)
    for leaf in leaves:
        out.append(encrypt_array(leaf, key_words, nonce_words, ctr))
        ctr += -(-words_for(leaf.shape, leaf.dtype) // 16)
    return tree_unflatten(treedef, out), ctr


decrypt_tree = encrypt_tree
