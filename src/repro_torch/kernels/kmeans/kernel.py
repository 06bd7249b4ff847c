"""Wrapper of the Hopper k-means kernel (`csrc/kmeans.cu`).

Replaces `repro/kernels/kmeans/kernel.py::kmeans_assign_tiles`. One call
computes the fused assign + accumulate for S shards at once (points
(S, n, D), one centre table) with two kernels issued by one C entry point:
per-CTA partials, then a fixed-order reduction over CTAs. It counts as one
launch in `launches`. The ragged last tile is masked inside the kernel, so
no point is padded or copied.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

THREADS = 512  # points per tile; must match csrc/kmeans.cu
DMAX = 64
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
CTAS_PER_SM = 2  # target CTAs per SM over the whole grid (two waves)


def smem_bytes(k: int, d: int) -> int:
    """Dynamic shared memory stage 1 needs (mirrors `kmeans_smem_bytes`)."""
    d4 = -(-d // 4)
    return k * d4 * 16 + k * 4 + k * d * 4 + k * 4 + 3 * THREADS * 4


def _lib():
    lib = _build.load("kmeans")
    fn = lib.kmeans_assign_accumulate
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_for(n_shards: int, n: int, n_sms: int) -> tuple[int, int]:
    """(CTAs per shard, tiles per CTA) for n points per shard."""
    tiles = max(1, -(-n // THREADS))
    want = max(1, -(-CTAS_PER_SM * n_sms // n_shards))
    per_cta = -(-tiles // min(want, tiles))
    return -(-tiles // per_cta), per_cta


def _check(t, name, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kmeans_assign_cuda(points, centers, weights):
    """assign (S, n) int32, sums (S, K, D) f32, counts (S, K) f32 in one launch.

    points (S, n, D) f32, centers (K, D) f32, weights (S, n) f32, all
    contiguous CUDA tensors on one device; 1 <= D <= 64.
    """
    global launches
    s, n, d = points.shape
    k = centers.shape[0]
    _check(points, "points", (s, n, d), torch.float32)
    _check(centers, "centers", (k, d), torch.float32)
    _check(weights, "weights", (s, n), torch.float32)
    if centers.device != points.device or weights.device != points.device:
        raise ValueError("points, centers and weights must be on the same device")
    if not 1 <= d <= DMAX:
        raise ValueError(f"the k-means kernel takes 1 <= D <= {DMAX}, got D={d}")
    if smem_bytes(k, d) > SMEM_LIMIT:
        raise ValueError(f"K={k}, D={d} needs {smem_bytes(k, d)} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} a CTA may use")
    dev = points.device
    assign = torch.empty((s, n), dtype=torch.int32, device=dev)
    sums = torch.empty((s, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((s, k), dtype=torch.float32, device=dev)
    if n == 0:
        return assign, sums.zero_(), counts.zero_()
    n_ctas, per_cta = grid_for(s, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_sums = torch.empty((s, n_ctas, k, d), dtype=torch.float32, device=dev)
    part_counts = torch.empty((s, n_ctas, k), dtype=torch.float32, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(points.data_ptr(), centers.data_ptr(), weights.data_ptr(), assign.data_ptr(),
             part_sums.data_ptr(), part_counts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
             s, n, d, k, n_ctas, per_cta, stream)
    _build.check(err, "kmeans_assign_accumulate launch")
    launches += 1
    return assign, sums, counts
