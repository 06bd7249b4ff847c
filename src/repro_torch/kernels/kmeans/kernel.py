"""Wrapper of the Hopper k-means kernel (`csrc/kmeans.cu`).

Replaces `repro/kernels/kmeans/kernel.py::kmeans_assign_tiles`. One call
computes the assign + accumulate for S shards at once (points (S, n, D),
one centre table) with three kernels issued by one C entry point: the
assignments on the tensor cores (3xTF32), per-CTA partials in point order,
then a fixed-order reduction over CTAs. It counts as one launch in
`launches`. Ragged tiles are masked inside the kernels, so no point is
padded or copied. Any K >= 1 and D >= 1 is taken: D > 64 runs the assign
kernel that walks D in chunks of 64 columns, and a (K, D) table of partial
sums too large for one CTA's shared memory is accumulated in blocks of
centres x columns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

ASSIGN_TILE = 128  # points an assign CTA takes per step: two warpgroups x 64 (csrc/kmeans.cu)
ACC_TILE = 256  # points per tile of the accumulate kernel (C_TILE)
DCHUNK = 64  # above this D the assign kernel walks D in chunks of this many columns
CBLOCK = 128  # centres per block of that kernel's table (one wgmma's N)


def dchunk_scratch(k: int, d: int) -> int:
    """Floats of scratch the D > 64 assign kernel takes: |c|^2 per block of
    128 centres, and each block's hi/lo split per chunk of 64 columns."""
    cblocks = -(-k // CBLOCK)
    return cblocks * CBLOCK + cblocks * -(-d // DCHUNK) * 2 * DCHUNK * CBLOCK


def admits(k: int, d: int) -> bool:
    """The (K, D) the entry point takes: every K >= 1 and D >= 1 (device
    memory permitting: the partial sums take S x CTAs x K x D floats)."""
    return k >= 1 and d >= 1


def _lib():
    lib = _build.load("kmeans")
    fn = lib.kmeans_assign_accumulate
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_for(n_shards: int, n: int, n_sms: int) -> tuple[int, int, int]:
    """(assign CTAs, accumulate CTAs per shard, accumulate tiles per CTA).

    The assign kernel is persistent: one CTA per SM, at most one per tile of
    the flattened S*n points. The accumulate kernel gives each shard an equal
    share of the SMs (at least one CTA) and each CTA a contiguous run of tiles.
    """
    assign_ctas = max(1, min(n_sms, -(-n_shards * n // ASSIGN_TILE)))
    tiles = max(1, -(-n // ACC_TILE))
    want = max(1, n_sms // n_shards)
    per_cta = -(-tiles // min(want, tiles))
    return assign_ctas, -(-tiles // per_cta), per_cta


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
    contiguous CUDA tensors on one device; any K >= 1, D >= 1.
    """
    global launches
    s, n, d = points.shape
    k = centers.shape[0]
    _check(points, "points", (s, n, d), torch.float32)
    _check(centers, "centers", (k, d), torch.float32)
    _check(weights, "weights", (s, n), torch.float32)
    if centers.device != points.device or weights.device != points.device:
        raise ValueError("points, centers and weights must be on the same device")
    if not admits(k, d):
        raise ValueError(f"the k-means kernel needs K >= 1 and D >= 1, got K={k}, D={d}")
    dev = points.device
    assign = torch.empty((s, n), dtype=torch.int32, device=dev)
    sums = torch.empty((s, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((s, k), dtype=torch.float32, device=dev)
    if n == 0:
        return assign, sums.zero_(), counts.zero_()
    assign_ctas, n_ctas, per_cta = grid_for(
        s, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_sums = torch.empty((s, n_ctas, k, d), dtype=torch.float32, device=dev)
    part_counts = torch.empty((s, n_ctas, k), dtype=torch.float32, device=dev)
    scratch = (torch.empty((dchunk_scratch(k, d),), dtype=torch.float32, device=dev)
               if d > DCHUNK else None)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(points.data_ptr(), centers.data_ptr(), weights.data_ptr(), assign.data_ptr(),
             part_sums.data_ptr(), part_counts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
             None if scratch is None else scratch.data_ptr(), s, n, d, k, assign_ctas, n_ctas,
             per_cta, stream)
    _build.check(err, "kmeans_assign_accumulate launch")
    launches += 1
    return assign, sums, counts
