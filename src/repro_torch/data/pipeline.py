"""Secure sharded input pipeline -- the paper's data path feeding the train step.

Counterpart of `repro/data/pipeline.py`. Shards are encrypted at rest (k_data)
exactly like the paper's MAP_DATATYPE splits; `next_batch()` hands the
*ciphertext* plus its keystream counter to the step, which decrypts it
(`repro_torch.train.step.SecureIngest`). The batch is drawn on the host as
the reference draws it (same rng, same windows), moved to `device` and
encrypted there by `crypto/ctr.py::encrypt_array`: the ChaCha20 kernel on
the card, the plain ARX on the CPU; same bits either way, and the same as
the reference's. A checkpoint restart resumes the counter and the rng
exactly (`state`, `restore`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.crypto.ctr import encrypt_array, words_for
from repro_torch.crypto.keys import SessionKeys
from repro_torch.device import resolve_device


@dataclass
class SecureShardedSource:
    """Encrypts fixed-shape batches drawn from a token array, on `device`
    (the card unless named)."""

    tokens: np.ndarray
    batch: int
    seq: int
    session: SessionKeys
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        self._kw = self.session.words("data")
        self._nw = SessionKeys.nonce_words("data", 0)
        self._ctr = 0
        self._blocks_per_batch = -(-words_for((self.batch, self.seq), torch.int32) // 16)

    @property
    def state(self) -> dict:
        return {"ctr": self._ctr, "rng": self._rng.bit_generator.state}

    def restore(self, state: dict):
        self._ctr = state["ctr"]
        self._rng.bit_generator.state = state["rng"]

    def next_batch(self) -> dict:
        """{"tokens": ciphertext (B, S) int32, "ctr": 0-d int64}, on the device."""
        n = len(self.tokens) - self.seq - 1
        idx = self._rng.integers(0, n, self.batch)
        plain = np.stack([self.tokens[i : i + self.seq] for i in idx]).astype(np.int32)
        ctr = self._ctr
        self._ctr += self._blocks_per_batch
        ct = encrypt_array(torch.from_numpy(plain).to(self._device), self._kw, self._nw, ctr)
        return {"tokens": ct, "ctr": torch.tensor(ctr, dtype=torch.int64, device=self._device)}
