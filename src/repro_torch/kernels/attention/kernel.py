"""Wrapper of the Hopper prefill attention kernel (`csrc/attention.cu`).

Replaces no TPU kernel (the JAX package's attention is plain jnp code); it
takes the place of the port's chunked score passes in a prefill. One call
is one launch: the whole prompt, every (batch, head), causal over positions
0..T-1. q (B, T, H, Dh), k and v (B, T, Hkv, Dh) are read through their
strides as the projections leave them (Dh contiguous); the context comes
back as a new (B, T, H, Dh) tensor in q's dtype. bf16 (products on the
tensor cores) or float32 (products in float32 on the CUDA cores), Dh from
16 to 128 in steps of 16, one library built for each head size on its
first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

HEAD_DIMS = tuple(range(16, 129, 16))
DTYPES = (torch.bfloat16, torch.float32)

_fns: dict = {}  # head size -> the loaded C entry


def _lib(dh: int):
    fn = _fns.get(dh)
    if fn is None:
        fn = _build.load("attention", {"HEAD_DIM": dh}).attention_prefill
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dh] = fn
    return fn


def _check(t, name, q):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype not in DTYPES or t.dtype != q.dtype:
        raise ValueError(f"{name} must be one of {DTYPES}, as q is; got {t.dtype} and {q.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-d, got shape {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs Dh contiguous, strides a multiple of 8 elements and "
                         f"16-byte alignment; got strides {t.stride()}")


def attention_prefill_cuda(q, k, v):
    """Causal softmax(q k^T / sqrt(Dh)) v per head over positions 0..T-1,
    query head h on key/value head h // (H // Hkv): (B, T, H, Dh) in q's
    dtype, one launch."""
    global launches
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q)
    b, t_len, h, dh = q.shape
    hkv = k.shape[2]
    if tuple(k.shape) != (b, t_len, hkv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, T, Hkv, Dh) = ({b}, {t_len}, Hkv, {dh}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"query heads {h} must be a multiple of key/value heads {hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes Dh in {HEAD_DIMS}, got {dh}")
    out = torch.empty((b, t_len, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _lib(dh)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t_len, h, hkv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attention_prefill launch")
    launches += 1
    return out
