"""Operations, bytes and peaks that rooflines and `mfu` are counted against.

Counted from shapes, never from a kernel: a later kernel that does the same
work is held to the same count. Peaks are one NVIDIA H100 SXM's (NVIDIA's
data sheet, dense, at its 700 W power limit). A language model's counts
(parameters, a prefill's and a decode step's operations, its attention's,
the expert exchange's bytes) come from the configuration's own reference
module (`bench/reference/<module>.py`, `bench/drivers/lm.py`), so that a
model of another shape brings its own.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_TF32 = 495e12  # FLOP/s, tensor cores
HBM_BW = 3.35e12  # B/s


# --- k-means -------------------------------------------------------------------


def kmeans_assign_s(n: int, k: int, d: int) -> float:
    """Least time of one assignment pass over n real points: 2 n k d
    operations at the TF32 peak, or the points and centres read once and one
    index a point written once, at the HBM rate; the larger."""
    flops = 2.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d + n)
    return max(flops / PEAK_TF32, nbytes / HBM_BW)


def kmeans_round_flops(n: int, k: int, d: int) -> float:
    """A round's useful operations: the distances (2 n k d) and the
    per-centre sums of the points (n d)."""
    return 2.0 * n * k * d + 1.0 * n * d


def kmeans_wire_words(k: int, d: int, shards: int) -> int:
    """Words of one wire row of a k-means round: ceil(k / S) slots of a key
    (int32), a count and d sums (float32)."""
    return -(-k // shards) * (2 + d)


def crypt_s(wire_bytes: float) -> float:
    """Least time of one keystream XOR over a wire: read once, written once."""
    return 2.0 * wire_bytes / HBM_BW
