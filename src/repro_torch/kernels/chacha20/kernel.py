"""Wrapper of the Hopper ChaCha20 kernel (`csrc/chacha20.cu`).

Replaces `repro/kernels/chacha20/kernel.py::chacha20_xor_row_lanes`. The
TPU kernel's blocks-on-lanes layout and its lane-tile padding were chosen for
TPU vector registers; this kernel runs one thread per 64-byte block on the
(rows, blocks, 16) order the callers already hold, so it needs no transpose
and no pad. `launches` counts the launches this process has made.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0


def _lib():
    lib = _build.load("chacha20")
    fn = lib.chacha20_xor_rows
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (u32 words), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def chacha20_xor_rows_cuda(x, state0, nonce_ids, ctr_rows, ctr_base, ctr_rowmul):
    """y = x ^ keystream over an (n_rows, n_blocks, 16) int32 CUDA buffer.

    Same contract as `ref.chacha20_xor_rows_ref`. All operands are int32
    CUDA tensors holding u32 bits; one launch on the current stream.
    """
    global launches
    n_rows, n_blocks = x.shape[0], x.shape[1]
    _check(x, "x", (n_rows, n_blocks, 16))
    _check(state0, "state0", (16,))
    _check(nonce_ids, "nonce_ids", (n_rows,))
    _check(ctr_rows, "ctr_rows", (n_rows,))
    _check(ctr_base, "ctr_base", (n_blocks,))
    _check(ctr_rowmul, "ctr_rowmul", (n_blocks,))
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    for t in (state0, nonce_ids, ctr_rows, ctr_base, ctr_rowmul):
        if t.device != x.device:
            raise ValueError("all operands must be on the same device")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), state0.data_ptr(), nonce_ids.data_ptr(),
             ctr_rows.data_ptr(), ctr_base.data_ptr(), ctr_rowmul.data_ptr(),
             n_rows, n_blocks, stream)
    _build.check(err, "chacha20_xor_rows launch")
    launches += 1
    return y
