"""Lloyd's k-means as the paper runs it (arXiv:1705.05684 §V), in plain PyTorch.

Each round assigns every point to its nearest centre (squared distances
|x|^2 - 2 x.c + |c|^2 in float32, TF32 off), averages each centre's points
(sums in float64), keeps an empty centre where it was, and reports the
round's shift: the mean over centres of |new - old|. A job halts after the
first round whose shift falls below the threshold, diag/1000 of the
points' bounding box.

`precision="tf32"` is the control: the distance product's inputs are
rounded to TF32's 10-bit mantissa first, as the tensor cores round them.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 18  # points per distance block


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def paper_threshold(points: torch.Tensor) -> float:
    """diag/1000 of the points' bounding box, the norm in float32."""
    span = torch.amax(points, dim=0) - torch.amin(points, dim=0)
    return float(torch.linalg.vector_norm(span)) / 1000.0


def assign(points: torch.Tensor, centers: torch.Tensor, precision: str = "float32"):
    """Index of each point's nearest centre (the first of equals)."""
    c = tf32_round(centers) if precision == "tf32" else centers
    c2 = torch.sum(centers * centers, dim=1)[None, :]
    out = torch.empty(points.shape[0], dtype=torch.int64, device=points.device)
    for i in range(0, points.shape[0], BLOCK):
        x = points[i:i + BLOCK]
        xq = tf32_round(x) if precision == "tf32" else x
        d2 = torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (xq @ c.T) + c2
        out[i:i + BLOCK] = torch.argmin(d2, dim=1)
    return out


def lloyd_round(points, centers, precision: str = "float32"):
    """One round: (new centres (k, d) float32, shift float, points a centre (k,))."""
    k, d = centers.shape
    a = assign(points, centers, precision)
    sums = torch.zeros((k, d), dtype=torch.float64, device=points.device)
    ids = torch.arange(k, device=points.device)
    for i in range(0, points.shape[0], BLOCK):  # one-hot products: no atomics, no order
        onehot = (a[i:i + BLOCK, None] == ids[None, :]).double()
        sums += onehot.T @ points[i:i + BLOCK].double()
    counts = torch.bincount(a, minlength=k).double()
    new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1)[:, None],
                      centers.double()).float()
    shift = float(torch.mean(torch.linalg.vector_norm((new - centers).double(), dim=1)))
    return new, shift, counts


def fit(points, init, *, threshold: float, max_rounds: int, min_rounds: int = 0,
        precision: str = "float32"):
    """Rounds from `init` until the shift falls below `threshold` (and at
    least `min_rounds`), or `max_rounds`. Returns (centres after each round,
    each round's shift, each round's points a centre, the halting round)."""
    centers, history, shifts, counts, halted_at = init.float(), [], [], [], None
    for r in range(max_rounds):
        with _tf32_off():
            centers, shift, n = lloyd_round(points, centers, precision)
        history.append(centers)
        shifts.append(shift)
        counts.append(n)
        if halted_at is None and shift < threshold:
            halted_at = r + 1
        if halted_at is not None and r + 1 >= min_rounds:
            break
    return history, shifts, counts, halted_at or max_rounds


class _tf32_off:
    """TF32 off for the reference's products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
