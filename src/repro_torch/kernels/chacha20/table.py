"""The per-block table that places the ChaCha20 keystream on a word wire.

Block j of a table is four u32 words {ctr_base, ctr_rowmul, packed_start,
n_valid}: row i's block j draws counter counter0 + ctr_base[j] +
ctr_rowmul[j] · ctr_rows[i] and XORs its first n_valid[j] keystream words
onto words packed_start[j]... of row i. The kernel and its plain version both
take a `BlockTable`; `aligned` (every block whole, at a multiple of 4 words)
lets the kernel move whole blocks as 16-byte vectors, and is known on the
host so that no launch reads the table back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.crypto.chacha import MASK32


@dataclass(frozen=True, eq=False)
class BlockTable:
    words: torch.Tensor  # (n_blocks, 4) int32: ctr_base, ctr_rowmul, packed_start, n_valid
    aligned: bool

    @property
    def n_blocks(self) -> int:
        return self.words.shape[0]


def host_u32(v) -> np.ndarray:
    """u32 values (array, list, scalar or tensor) as a host uint32 array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        v = v.view(torch.int32) if v.dtype == torch.uint32 else v
        v = v.to(torch.int64).numpy()
    return (np.asarray(v).astype(np.int64) & MASK32).astype(np.uint32)


def block_table(ctr_base, ctr_rowmul, packed_start, n_valid, device) -> BlockTable:
    """A `BlockTable` on `device` from its four columns (host values)."""
    cols = [host_u32(c).reshape(-1) for c in (ctr_base, ctr_rowmul, packed_start, n_valid)]
    tab = np.stack(cols, axis=1)
    aligned = bool(np.all(tab[:, 3] == 16) and np.all(tab[:, 2] % 4 == 0))
    words = torch.from_numpy(np.ascontiguousarray(tab.view(np.int32))).to(device)
    return BlockTable(words=words, aligned=aligned)


@functools.lru_cache(maxsize=64)
def row_table(n_words: int, device) -> BlockTable:
    """The row-aligned table of an n_words row: block j = words 16j.., counter j."""
    j = np.arange(-(-n_words // 16), dtype=np.int64)
    return block_table(j, np.ones_like(j), 16 * j, np.minimum(16, n_words - 16 * j), device)
