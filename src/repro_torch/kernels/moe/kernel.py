"""Wrappers of the MoE prefill's dispatch and combine kernels (`csrc/moe.cu`).

Replace no TPU kernel (the JAX package's MoE is plain jnp code); they take
the place of the k-fold token copy, `bucket_pack`'s value gather and scatter
and `_combine`'s element-wise gather and k adds in a prefill with no
gradient. One call is one launch. bf16 or float32, any d; the rows move in
the widest unit of 16, 8, 4 or 2 bytes that divides the row's bytes, its
strides and its pointers. Both read their inputs through row strides (d
contiguous) and write a new tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

dispatch_launches = 0  # moe_dispatch_cuda's launches
combine_launches = 0  # moe_combine_cuda's launches

DTYPES = (torch.bfloat16, torch.float32)
MAX_TOP_K = 32  # a token's entries are passed between a warp's lanes

_fns: dict = {}


def _lib():
    if not _fns:
        lib = _build.load("moe")
        fn = lib.moe_dispatch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["dispatch"] = fn
        fn = lib.moe_combine
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["combine"] = fn
    return _fns


def _unit(itemsize: int, *quantities: int) -> int:
    """The widest of 16, 8 and 4 bytes dividing every row size, stride and
    address given, else one element."""
    for unit in (16, 8, 4):
        if unit >= itemsize and all(q % unit == 0 for q in quantities):
            return unit
    return itemsize


def _check(t, name, ref, dtype=None, dim=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, the rows on {ref.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-d, got shape {tuple(t.shape)}")


def _rows(t, name):
    if t.dtype not in DTYPES:
        raise ValueError(f"{name} must be one of {DTYPES}, got {t.dtype}")
    _check(t, name, t, dim=3)
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} needs d contiguous, got strides {t.stride()}")


def moe_dispatch_cuda(x2, slots, k: int):
    """The (R, S, d) send buffer in x2's dtype, one launch: slot s of shard r
    holds x2[r, slots[r, s] // k], zeros where slots[r, s] is not in [0, n·k).
    x2 (R, n, d); slots (R, S) int32."""
    global dispatch_launches
    _rows(x2, "x2")
    _check(slots, "slots", x2, torch.int32, 2)
    r, n, d = x2.shape
    if slots.shape[0] != r:
        raise ValueError(f"slots must be (R, S) with R = {r}, got {tuple(slots.shape)}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    slots = slots.contiguous()
    s = slots.shape[1]
    out = torch.empty((r, s, d), dtype=x2.dtype, device=x2.device)
    if out.numel() == 0:
        return out
    size = x2.element_size()
    row = d * size
    unit = _unit(size, row, x2.stride(0) * size, x2.stride(1) * size, x2.data_ptr(),
                 out.data_ptr())
    with torch.cuda.device(x2.device):
        err = _lib()["dispatch"](x2.data_ptr(), slots.data_ptr(), out.data_ptr(), r, s, n, k,
                                 x2.stride(0) * size, x2.stride(1) * size, row, unit,
                                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "moe_dispatch launch")
    dispatch_launches += 1
    return out


def moe_combine_cuda(got, pos, gates, batch: int | None = None):
    """Each token's k expert outputs weighted and added in index order, from
    +0, each product and sum rounded to the working dtype; an entry whose pos
    is not in [0, S) adds a zero row. got (R, S, d), pos (R, n·k) int32,
    gates (R, n, k) in got's dtype; (R, n, d), or (B, T, d) with `batch`
    (shard r's token i is token (i // (n / B), r·n / B + i % (n / B))). One
    launch."""
    global combine_launches
    _rows(got, "got")
    _check(gates, "gates", got, got.dtype, 3)
    _check(pos, "pos", got, torch.int32, 2)
    r, s, d = got.shape
    n, k = gates.shape[1:]
    if gates.shape[0] != r or tuple(pos.shape) != (r, n * k):
        raise ValueError(f"gates must be (R, n, k) and pos (R, n·k) with R = {r}; got "
                         f"{tuple(gates.shape)} and {tuple(pos.shape)}")
    if not 1 <= k <= MAX_TOP_K:
        raise ValueError(f"the combine takes 1 to {MAX_TOP_K} entries a token, got {k}")
    if batch is not None and (batch < 1 or n % batch):
        raise ValueError(f"a batch of {batch} does not divide a shard's {n} tokens")
    tps = n if batch is None else n // batch
    shape = (r, n, d) if batch is None else (batch, r * tps, d)
    out = torch.empty(shape, dtype=got.dtype, device=got.device)
    if out.numel() == 0:
        return out
    size = got.element_size()
    row = d * size
    if batch is None:
        o_r, o_b, o_t = n * row, 0, row
    else:
        o_r, o_b, o_t = tps * row, r * tps * row, row
    unit = _unit(size, row, got.stride(0) * size, got.stride(1) * size, got.data_ptr(),
                 out.data_ptr())
    pos, gates = pos.contiguous(), gates.contiguous()
    with torch.cuda.device(got.device):
        err = _lib()["combine"](got.data_ptr(), pos.data_ptr(), gates.data_ptr(),
                                out.data_ptr(), r, n, k, s, got.stride(0) * size,
                                got.stride(1) * size, row, tps, o_r, o_b, o_t,
                                int(got.dtype == torch.float32), unit,
                                torch.cuda.current_stream(got.device).cuda_stream)
    _build.check(err, "moe_combine launch")
    combine_launches += 1
    return out
