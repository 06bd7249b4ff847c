"""Device dispatch for the fused k-means kernel.

Counterpart of `repro/kernels/kmeans/ops.py::kmeans_assign`. A CUDA tensor
launches the Hopper kernel, a CPU tensor runs the plain version. `impl`
keeps its name for parity: 'auto' lets the device decide, 'torch' asks for
the plain version and is refused on a CUDA tensor. Both forms are accepted:
(N, D) points give sums (K, D) and counts (K,); shard-batched (S, N, D)
points give per-shard sums (S, K, D) and counts (S, K) from one launch.
Zero-weight points contribute nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import uses_kernel
from repro_torch.kernels.kmeans.kernel import kmeans_assign_cuda
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref


def kmeans_assign(points, centers, weights=None, *, impl: str = "auto"):
    """assign (…, N) int32, sums (…, K, D) f32, counts (…, K) f32."""
    if points.dim() not in (2, 3):
        raise ValueError(f"points must be (N, D) or (S, N, D), got {tuple(points.shape)}")
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=torch.float32, device=points.device)
    if not uses_kernel(impl, points):
        return kmeans_assign_ref(points, centers, weights)
    batched = points.dim() == 3
    p = points if batched else points[None]
    w = weights if batched else weights[None]
    assign, sums, counts = kmeans_assign_cuda(
        p.contiguous(), centers.contiguous(), w.to(torch.float32).contiguous())
    if batched:
        return assign, sums, counts
    return assign[0], sums[0], counts[0]
