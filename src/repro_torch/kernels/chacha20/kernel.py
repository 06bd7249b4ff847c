"""Wrapper of the Hopper ChaCha20 kernel (`csrc/chacha20.cu`).

Replaces `repro/kernels/chacha20/kernel.py::chacha20_xor_row_lanes`. The
TPU kernel's blocks-on-lanes layout and its lane-tile padding were chosen for
TPU vector registers; this kernel runs four lanes per 64-byte block on a
small wire and one thread per block on a large one (`lanes_for`), and XORs
the keystream straight onto a packed (n_rows, row_words) word wire, placed
by a per-block table (`table.BlockTable`; `ref.chacha20_xor_packed_ref`
states the contract). Key, nonce and counter0 travel by value in the launch, so a call
is one launch: nothing is copied to the card and nothing synchronises. An
optional `round_dev`, one u32 on the card, is XORed into nonce word 1 by the
kernel: a launch captured in a CUDA graph then keys every replay's round from
device memory. An optional `place_rows` R stores the rows as an (n_rows/R, R)
grid transposed (each row's keystream unchanged): the shuffle's send side
writes each ciphertext row where its receiver reads it.
`launches` counts the launches this process has made.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chacha20.ref import check_place_rows

launches = 0
_fn = None
_sms: dict = {}


def _lib():
    global _fn
    if _fn is None:
        fn = _build.load("chacha20").chacha20_xor_packed
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(t: torch.Tensor, name: str, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (u32 words), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def params_words(key_words, nonce_words, counter0) -> np.ndarray:
    """The kernel's by-value parameters: (12,) u32 {key[8], nonce[3], counter0}."""
    p = np.empty(12, np.int64)
    p[:8] = np.asarray(key_words, np.int64).reshape(8)
    p[8:11] = np.asarray(nonce_words, np.int64).reshape(3)
    p[11] = int(counter0)
    return (p & 0xFFFFFFFF).astype(np.uint32)


def lanes_for(n_items: int, device) -> int:
    """Lanes per block: 4 while four lanes per block fit one wave of the card
    (512 per SM: 67,584 blocks on 132 SMs), where the launch is bound by its
    latency; 1 beyond, where the shuffles' extra instructions would bind it."""
    sms = _sms.get(device.index)
    if sms is None:
        sms = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 if n_items <= 512 * sms else 1


def chacha20_xor_packed_cuda(x, table, key_words, nonce_words, counter0, nonce_ids,
                             ctr_rows, *, round_dev=None, place_rows: int = 0,
                             lanes: int | None = None):
    """y = x ^ keystream over an (n_rows, row_words) int32 CUDA wire.

    Same contract as `ref.chacha20_xor_packed_ref`. `table` is a
    `table.BlockTable` on the card; `nonce_ids` and `ctr_rows` (n_rows,) are
    int32 CUDA tensors holding u32 bits; key_words (8,), nonce_words (3,)
    and counter0 are host values. `round_dev`, None or a (1,) int32 CUDA
    tensor of u32 bits, is XORed into nonce word 1 on the card.
    `place_rows` R (0, or a divisor of n_rows) stores row s·R + r's output at
    row r·(n_rows/R) + s (`ref.place_rows_ref`); 0 keeps row i at row i.
    `lanes` (4 or 1) overrides `lanes_for`.
    One launch on the current stream; the table must cover every word of a
    row exactly once (the output is not initialised elsewhere).
    """
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be (n_rows, row_words), got shape {tuple(x.shape)}")
    n_rows, row_words = x.shape
    n_blocks = table.n_blocks
    _check(x, "x", (n_rows, row_words))
    _check(table.words, "table", (n_blocks, 4))
    _check(nonce_ids, "nonce_ids", (n_rows,))
    _check(ctr_rows, "ctr_rows", (n_rows,))
    operands = [table.words, nonce_ids, ctr_rows]
    if round_dev is not None:
        _check(round_dev, "round_dev", (1,))
        operands.append(round_dev)
    for t in operands:
        if t.device != x.device:
            raise ValueError("all operands must be on the same device")
    n_items = n_rows * n_blocks
    if n_items * 4 >= 2**31:
        raise ValueError(f"wire of {n_rows} x {n_blocks} blocks is past the kernel's "
                         "2**29-block range")
    check_place_rows(n_rows, place_rows)
    lanes = lanes_for(n_items, x.device) if lanes is None else lanes
    if lanes not in (1, 4):
        raise ValueError(f"lanes must be 1 or 4, got {lanes}")
    y = torch.empty_like(x)
    if n_items == 0:
        return y
    params = params_words(key_words, nonce_words, counter0)
    err = _lib()(x.data_ptr(), y.data_ptr(), table.words.data_ptr(), nonce_ids.data_ptr(),
                 ctr_rows.data_ptr(), None if round_dev is None else round_dev.data_ptr(),
                 params.ctypes.data, n_rows, n_blocks, row_words, place_rows, lanes,
                 int(table.aligned), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "chacha20_xor_packed launch")
    launches += 1
    return y
