"""Wrapper of the Hopper prefill attention kernel (`csrc/attention.cu`).

Replaces no TPU kernel (the JAX package's attention is plain jnp code); it
takes the place of the port's chunked score passes in a prefill. One call
is one launch: the whole prompt, every (batch, head), causal over positions
0..T-1. q (B, T, H, Dqk), k (B, T, Hkv, Dqk) and v (B, T, Hkv, Dv) are
read through their strides as the projections leave them (the last
dimension contiguous); the context comes back as a new (B, T, H, Dv)
tensor in q's dtype. bf16 (products on the tensor cores) or float32
(products in float32 on the CUDA cores). One library is built for each
(Dqk, Dv) pair of `BUILDS` on its first use: Dqk = Dv from 16 to 128 in
steps of 16 (grouped-query attention), and (192, 128), latent attention's
heads (`models/attention.py`'s MLA at Moonlight's widths).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

HEAD_DIMS = tuple(range(16, 129, 16))  # grouped-query attention's Dh: Dqk = Dv = Dh
LATENT_DIMS = ((192, 128),)  # latent attention's (Dqk, Dv)
BUILDS = tuple((d, d) for d in HEAD_DIMS) + LATENT_DIMS
DTYPES = (torch.bfloat16, torch.float32)

_fns: dict = {}  # (Dqk, Dv) -> the loaded C entry


def _lib(dqk: int, dv: int):
    fn = _fns.get((dqk, dv))
    if fn is None:
        fn = _build.load("attention", {"QK_DIM": dqk, "V_DIM": dv}).attention_prefill
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dqk, dv] = fn
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
        raise ValueError(f"{name} needs its last dimension contiguous, strides a multiple of "
                         f"8 elements and "
                         f"16-byte alignment; got strides {t.stride()}")


def attention_prefill_cuda(q, k, v):
    """Causal softmax(q k^T / sqrt(Dqk)) v per head over positions 0..T-1,
    query head h on key/value head h // (H // Hkv): (B, T, H, Dv) in q's
    dtype, one launch."""
    global launches
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q)
    b, t_len, h, dqk = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    if tuple(k.shape) != (b, t_len, hkv, dqk) or tuple(v.shape) != (b, t_len, hkv, dv):
        raise ValueError(f"k must be (B, T, Hkv, Dh) = ({b}, {t_len}, Hkv, {dqk}), Dh q's, and "
                         f"v (B, T, Hkv, Dv); got {tuple(k.shape)} and {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"query heads {h} must be a multiple of key/value heads {hkv}")
    if (dqk, dv) not in BUILDS:
        raise ValueError(f"the attention kernel takes Dh in {HEAD_DIMS} with Dv = Dh, or "
                         f"(Dh, Dv) in {LATENT_DIMS}; got Dh {dqk}, Dv {dv}")
    out = torch.empty((b, t_len, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _lib(dqk, dv)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t_len, h, hkv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attention_prefill launch")
    launches += 1
    return out
