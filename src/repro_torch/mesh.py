"""Virtual mesh: R shards of a `shard_map` program on one device.

The JAX package runs its per-shard functions under `shard_map` over a mesh
axis and calls collectives by axis name (`lax.axis_index`, `lax.psum`,
`lax.all_to_all`). On one card the port holds every per-shard tensor with a
leading shard dimension S instead, and the collectives become tensor
operations over that dimension:

    axis_index()      -> (S,) shard ids, one per shard
    psum(x)           -> sum over S in the fixed order 0, 1, ..., S-1,
                         broadcast back to every shard
    all_gather(x)     -> every shard sees the shards' values stacked
    all_to_all(x)     -> JAX's tiled all_to_all on (S, R, ...) with R == S:
                         row i of shard j moves to row j of shard i, which
                         is `x.transpose(0, 1)`

A replicated value (JAX's `P()`) is held once, without the shard dimension,
and broadcasts against per-shard tensors. Spec functions are written against
this interface only, so a `torch.distributed` backend can sit behind the
same methods later.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


class VirtualMesh:
    """`n_shards` virtual shards on one device (the card unless named)."""

    def __init__(self, n_shards: int, device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)

    def __repr__(self):
        return f"VirtualMesh(n_shards={self.n_shards}, device={self.device})"

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """Split the leading dim of a global tensor into (S, n / S, ...)."""
        n = x.shape[0]
        if n % self.n_shards:
            raise ValueError(
                f"leading dim {n} does not divide over {self.n_shards} shards")
        return x.reshape((self.n_shards, n // self.n_shards) + tuple(x.shape[1:]))

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of `shard`: (S, n, ...) -> (S * n, ...)."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def axis_index(self) -> torch.Tensor:
        """(S,) int64: each shard's index on the axis."""
        return torch.arange(self.n_shards, device=self.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over shards in a fixed order, broadcast back as (S, ...).

        The order is fixed so that the result is identical from run to run
        (no atomics, no data-dependent reduction tree).
        """
        total = x[0]
        for s in range(1, x.shape[0]):
            total = total + x[s]
        return total.unsqueeze(0).expand_as(x)

    def all_gather(self, x: torch.Tensor, tiled: bool = False) -> torch.Tensor:
        """(S, n, ...) -> every shard's view of all shards: (S, S, n, ...),
        or (S, S * n, ...) with `tiled=True`, as JAX's `lax.all_gather`."""
        s = x.shape[0]
        g = x.unsqueeze(0).expand((s,) + tuple(x.shape))
        return g.reshape((s, -1) + tuple(x.shape[2:])) if tiled else g

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all_to_all over the rows of an (S, R, ...) buffer, R == S."""
        if x.shape[1] != x.shape[0]:
            raise ValueError(
                f"all_to_all needs one row per shard, got shape {tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()
