"""Plain PyTorch version of the fused k-means assign + accumulate kernel."""

from __future__ import annotations

import torch


def kmeans_accumulate_ref(points, assign, weights, k: int):
    """Weighted per-centre sums (…, K, D) and counts (…, K) for given assignments."""
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    onehot = onehot * weights[..., None]
    sums = onehot.transpose(-1, -2) @ points
    counts = onehot.sum(dim=-2)
    return sums, counts


def kmeans_assign_ref(points, centers, weights=None):
    """Map step of the paper's k-means: nearest centre + weighted partials.

    Args:
      points:  (N, D) or (S, N, D) f32
      centers: (K, D) f32
      weights: (N,) or (S, N) f32 validity/sample weights (None -> ones)

    Returns assign (…, N) int32, sums (…, K, D) f32, counts (…, K) f32, with
    the expression of `repro/kernels/kmeans/ref.py`; `torch.argmin` takes the
    first index on ties, as `jnp.argmin` does.
    """
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=torch.float32, device=points.device)
    x2 = torch.sum(points * points, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)
    d2 = x2 + c2 - 2.0 * (points @ centers.T)
    assign = torch.argmin(d2, dim=-1).to(torch.int32)
    sums, counts = kmeans_accumulate_ref(points, assign, weights, centers.shape[0])
    return assign, sums, counts
