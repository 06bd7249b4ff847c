"""Device dispatch for the fused k-means kernel.

Counterpart of `repro/kernels/kmeans/ops.py::kmeans_assign`. A CUDA tensor
launches the Hopper kernel, a CPU tensor runs the plain version. `impl`
keeps its name for parity: 'auto' lets the device decide, 'torch' asks for
the plain version and is refused on a CUDA tensor. Both forms are accepted:
(N, D) points give sums (K, D) and counts (K,); shard-batched (S, N, D)
points give per-shard sums (S, K, D) and counts (S, K) from one launch.
Zero-weight points contribute nothing.

Points that are not on the card go through the operator
`torch.ops.repro_torch.kmeans_assign`: its CPU implementation is the plain
version, and its fake (shape-only) implementation gives an abstract run on
the `meta` device the outputs' shapes. CUDA points call the kernel's
wrapper directly, without the operator's dispatch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import kernel_calls, uses_kernel
from repro_torch.kernels.kmeans.kernel import kmeans_assign_cuda
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref

_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("kmeans_assign(Tensor points, Tensor centers, Tensor weights) "
            "-> (Tensor, Tensor, Tensor)")
_lib.impl("kmeans_assign", kmeans_assign_ref, "CPU")


@torch.library.register_fake("repro_torch::kmeans_assign")
def _(points, centers, weights):
    lead, k = points.shape[:-1], centers.shape[0]
    return (points.new_empty(lead, dtype=torch.int32),
            points.new_empty(lead[:-1] + (k, points.shape[-1]), dtype=torch.float32),
            points.new_empty(lead[:-1] + (k,), dtype=torch.float32))


def kmeans_assign(points, centers, weights=None, *, impl: str = "auto"):
    """assign (…, N) int32, sums (…, K, D) f32, counts (…, K) f32."""
    if points.dim() not in (2, 3):
        raise ValueError(f"points must be (N, D) or (S, N, D), got {tuple(points.shape)}")
    kernel_calls.note("kmeans_assign")
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=torch.float32, device=points.device)
    if not uses_kernel(impl, points):
        return torch.ops.repro_torch.kmeans_assign(points, centers, weights)
    batched = points.dim() == 3
    p = points if batched else points[None]
    w = weights if batched else weights[None]
    assign, sums, counts = kmeans_assign_cuda(
        p.contiguous(), centers.contiguous(), w.to(torch.float32).contiguous())
    if batched:
        return assign, sums, counts
    return assign[0], sums[0], counts[0]
