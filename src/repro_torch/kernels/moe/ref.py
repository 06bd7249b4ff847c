"""Plain PyTorch versions of the MoE prefill's dispatch and combine kernels.

On the CPU and `meta` devices they are the path itself, and they give the
bits of the k-fold copy, `bucket_pack` and `_combine` that a gradient path
takes (`models/moe.py`): the same rows land in the same slots, and the
combine rounds the same products and sums in the same order.
"""

from __future__ import annotations

import torch


def moe_dispatch_ref(x2, slots, k: int):
    """The (R, S, d) send buffer: slot s of shard r holds x2[r, slots[r, s] // k],
    zeros where slots[r, s] is not an entry of [0, n·k) (-1: empty)."""
    r, n, d = x2.shape
    src = torch.where((slots >= 0) & (slots < n * k), slots // k, n).long()
    rows = torch.arange(r, device=x2.device)[:, None]
    return torch.cat([x2, x2.new_zeros((r, 1, d))], dim=1)[rows, src]


def to_prompt_order(y, batch: int | None):
    """(R, n, d) -> (B, T, d) when `batch` is given: shard r's token i is
    token (i // (n / B), r·n / B + i % (n / B)) of the prompt batch."""
    if batch is None:
        return y
    r, n, d = y.shape
    return y.reshape(r, batch, n // batch, d).transpose(0, 1).reshape(batch, r * n // batch, d)


def moe_combine_ref(got, pos, gates, batch: int | None = None):
    """Each token's k expert outputs weighted and added in index order:
    y = +0, then y = y + got[r, pos[r, i·k + j]] · gates[r, i, j] for j in
    0..k-1, each product and sum rounded to the working dtype; an entry whose
    pos is not a slot of [0, S) (dropped: S) adds a zero row. got (R, S, d),
    pos (R, n·k), gates (R, n, k); (R, n, d), or (B, T, d) with `batch`."""
    r, slots, d = got.shape
    n, k = gates.shape[1:]
    p = pos.reshape(r, n, k)
    kept = (p >= 0) & (p < slots)
    idx = torch.where(kept, p, 0).long()
    rows = torch.arange(r, device=got.device)[:, None]
    y = torch.zeros((r, n, d), dtype=got.dtype, device=got.device)
    for j in range(k):
        v = torch.where(kept[:, :, j, None], got[rows, idx[:, :, j]], 0)
        y = y + v * gates[:, :, j, None]
    return to_prompt_order(y, batch)
