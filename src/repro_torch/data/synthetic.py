"""Synthetic token streams with learnable structure (for the drivers and tests).

A verbatim copy of `repro/data/synthetic.py` (numpy only). A k-order
Markov-ish stream: token t depends on (t-1) via a fixed random permutation
mixed with noise, so a model can reduce loss well below uniform -- enough
to validate end-to-end training dynamics without external data.
"""

from __future__ import annotations

import numpy as np


def synthetic_tokens(n_tokens: int, vocab: int, seed: int = 0, noise: float = 0.3):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(vocab)
    noise_draw = rng.random(n_tokens)
    noise_tok = rng.integers(0, vocab, n_tokens)
    for i in range(1, n_tokens):
        toks[i] = noise_tok[i] if noise_draw[i] < noise else perm[toks[i - 1]]
    return toks


def batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Yield (batch, seq) int32 batches forever (with wraparound)."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        idx = rng.integers(0, n, batch)
        yield np.stack([tokens[i : i + seq] for i in idx]).astype(np.int32)
