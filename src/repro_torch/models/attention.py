"""GQA/MQA attention: dense, query-chunked (memory-safe long context), decode.

Counterpart of `repro/models/attention.py`, in plain `torch.matmul`: the
masked softmax runs in `cfg.softmax_dtype` as the reference's does, which
`scaled_dot_product_attention` would not. Layouts: q (B, T, H, Dh); k/v
(B, S, Hkv, Dh); GQA groups G = H // Hkv. The query-chunked path walks query
blocks of `cfg.attn_chunk` against the full K/V, so the live scores are
O(C·S) instead of O(T·S). Decode (T=1) always takes the dense path.

A serving prefill goes through `prefill_self_attention`, which on the card
launches the fused causal kernel (`repro_torch.kernels.attention`: the
scores stay on chip) and elsewhere runs `attend` as `self_attention` does.
Training (the kernel has no backward), decode, cross-attention and the
encoder's non-causal attention keep `self_attention` and `attend`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import kernel_calls, uses_kernel
from repro_torch.kernels.attention.kernel import attention_prefill_cuda
from repro_torch.models.layers import Norm, Params, rmsnorm, rope

NEG_INF = -1e30


class Attention(Params):
    def __init__(self, cfg, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.weight("wq", (d, h * dh), cfg, device)
        self.weight("wk", (d, hkv * dh), cfg, device)
        self.weight("wv", (d, hkv * dh), cfg, device)
        self.weight("wo", (h * dh, d), cfg, device, fan_in=h * dh)
        if cfg.qk_norm:
            self.qn = Norm(dh, device)
            self.kn = Norm(dh, device)


def project_q(cfg, params, x, positions, apply_rope=True):
    b, t, _ = x.shape
    q = (x @ params.wq.to(x.dtype)).reshape(b, t, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params.qn, q)
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta)
    return q


def project_kv(cfg, params, x, positions, apply_rope=True):
    b, s, _ = x.shape
    k = (x @ params.wk.to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params.wv.to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(params.kn, k)
    if apply_rope:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def _softmax_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.softmax_dtype == "bfloat16" else torch.float32


def _attend_dense(cfg, q, k, v, q_pos, k_pos, k_valid, causal):
    """Scores in the compute dtype, then in the softmax dtype: / sqrt(Dh),
    the NEG_INF mask, softmax, cast to q's dtype; k_valid is (B, S) or None."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, t, hkv, g, dh).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * t, dh)
    scores = torch.matmul(qg, k.permute(0, 2, 3, 1)).reshape(b, hkv, g, t, s)
    scores = scores.to(_softmax_dtype(cfg))
    scores.div_(dh**0.5)  # in place: at prefill a chunk's scores are GBs
    mask = None
    if causal:
        mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B, T, S)
    if k_valid is not None:
        mask = k_valid[:, None, :] if mask is None else mask & k_valid[:, None, :]
    if mask is not None:
        scores.masked_fill_(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    del scores
    w = w.to(q.dtype).reshape(b, hkv, g * t, s)
    ctx = torch.matmul(w, v.permute(0, 2, 1, 3))  # (B, Hkv, G*T, Dh)
    return ctx.reshape(b, hkv, g, t, dh).permute(0, 3, 1, 2, 4).reshape(b, t, h, dh)


def _attend_chunked(cfg, q, k, v, q_pos, k_pos, k_valid, causal, chunk):
    t = q.shape[1]
    if t % chunk != 0 or t <= chunk:
        return _attend_dense(cfg, q, k, v, q_pos, k_pos, k_valid, causal)
    return torch.cat([_attend_dense(cfg, q[:, i:i + chunk], k, v, q_pos[:, i:i + chunk],
                                    k_pos, k_valid, causal)
                      for i in range(0, t, chunk)], dim=1)


def attend(cfg, q, k, v, q_pos, k_pos, k_valid=None, causal=True):
    if cfg.attn_chunk and q.shape[1] > cfg.attn_chunk:
        return _attend_chunked(cfg, q, k, v, q_pos, k_pos, k_valid, causal, cfg.attn_chunk)
    return _attend_dense(cfg, q, k, v, q_pos, k_pos, k_valid, causal)


def out_proj(cfg, params, ctx):
    b, t = ctx.shape[:2]
    return ctx.reshape(b, t, -1) @ params.wo.to(ctx.dtype)


def self_attention(cfg, params, x, positions, k_valid=None, causal=None, kv=None):
    """Full self-attention over x (prefill). `kv`, the (k, v) that
    `project_kv` gives for the same x and positions, saves projecting them
    again when the caller needs them too (the engine's cache)."""
    causal = cfg.causal if causal is None else causal
    q = project_q(cfg, params, x, positions)
    k, v = kv if kv is not None else project_kv(cfg, params, x, positions)
    ctx = attend(cfg, q, k, v, positions, positions, k_valid, causal)
    return out_proj(cfg, params, ctx)


def prefill_self_attention(cfg, params, x, positions, kv):
    """Causal `self_attention` of a serving prefill over positions 0..T-1,
    no gradient, `kv` the (k, v) that `project_kv` gives for x: the fused
    kernel for a CUDA tensor, `attend` (the same bits as `self_attention`)
    for any other. Each call is noted in `kernel_calls["attention_prefill"]`."""
    if not cfg.causal:
        raise ValueError("a serving prefill's self-attention is causal")
    q = project_q(cfg, params, x, positions)
    k, v = kv
    kernel_calls.note("attention_prefill")
    if uses_kernel("auto", q):
        ctx = attention_prefill_cuda(q, k, v)
    else:
        ctx = attend(cfg, q, k, v, positions, positions, None, True)
    return out_proj(cfg, params, ctx)


def cross_attention(cfg, params, x, enc_kv, positions, enc_valid=None):
    """Decoder->encoder attention; enc_kv = (k, v) projected encoder states
    (B, S, Hkv, Dh), q without rope, no causal mask."""
    q = project_q(cfg, params, x, positions, apply_rope=False)
    k, v = enc_kv
    s = k.shape[1]
    k_pos = torch.arange(s, device=x.device)[None].expand(x.shape[0], s)
    ctx = attend(cfg, q, k, v, positions, k_pos, enc_valid, causal=False)
    return out_proj(cfg, params, ctx)


def decode_self_attention(cfg, params, x, cache_k, cache_v, position):
    """One-token decode: x (B, 1, d); cache (B, S, Hkv, Dh); position (B,).

    Writes the new K/V into `cache_k`/`cache_v` in place at `position` and
    returns (out, cache_k, cache_v). As the reference's
    `lax.dynamic_update_slice`, a position past S - 1 writes the last slot
    (and one below 0 the first), while the validity mask keeps the
    unclamped position.
    """
    b = x.shape[0]
    pos = position[:, None]  # (B, 1)
    q = project_q(cfg, params, x, pos)
    k_new, v_new = project_kv(cfg, params, x, pos)
    s = cache_k.shape[1]
    slot = position.clamp(0, s - 1)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    idx = torch.arange(s, device=x.device)[None]  # (1, S)
    k_valid = idx <= pos
    ctx = attend(cfg, q, cache_k, cache_v, pos, idx.expand(b, s), k_valid, causal=False)
    return out_proj(cfg, params, ctx), cache_k, cache_v
