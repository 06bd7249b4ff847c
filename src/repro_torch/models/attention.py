"""GQA/MQA attention: dense, query-chunked (memory-safe long context), decode;
and multi-head latent attention (MLA, `cfg.attention == "mla"`).

Counterpart of `repro/models/attention.py`, in plain `torch.matmul`: the
masked softmax runs in `cfg.softmax_dtype` as the reference's does, which
`scaled_dot_product_attention` would not. Layouts: q (B, T, H, Dqk); k
(B, S, Hkv, Dqk); v (B, S, Hkv, Dv), Dv v's own width (Dqk = Dv = Dh but
in MLA); GQA groups G = H // Hkv; scores scaled by 1 / sqrt(Dqk). The
query-chunked path walks query blocks of `cfg.attn_chunk` against the full
K/V, so the live scores are O(C·S) instead of O(T·S). Decode (T=1) always
takes the dense path.

MLA (the port's own; the reference has none), with r = `kv_lora_rank`,
nope / rope / v the head widths `qk_nope_head_dim`, `qk_rope_head_dim`,
`v_head_dim`:
  q = x W_q                      (H, nope + rope), the rope part rotated
  [c, k_pe] = x W_kva            r + rope; c = RMSNorm(c); k_pe rotated
                                 once, shared by every head
  [k_nope, v] = c W_kvb          (H, nope + v)
  k = [k_nope, k_pe]; softmax(q k^T / sqrt(nope + rope)) v, then W_o.
Rotation is the port's half-split rope over the rope columns. A prefill
expands the latent to per-head K and V (`mla_expand`) and runs the same
attention as GQA with H = Hkv; its cache holds c and k_pe alone. A decode
step reads that cache in the absorbed form (`decode_mla_attention`):
q_nope through W_kvb's key part gives a latent query, scores are q_lat · c
+ q_pe · k_pe, and the context latent goes through W_kvb's value part.

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
from repro_torch.tools.opcount import spans

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


class MLA(Params):
    """Multi-head latent attention's parameters (see the module's docstring):
    `wq` (d, H (nope + rope)), `wkva` (d, r + rope), `kv_norm` (r), `wkvb`
    (r, H (nope + v)), each head's key columns then its value columns, and
    `wo` (H v, d)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        nope, rp, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.weight("wq", (d, h * (nope + rp)), cfg, device)
        self.weight("wkva", (d, r + rp), cfg, device)
        self.kv_norm = Norm(r, device)
        self.weight("wkvb", (r, h * (nope + dv)), cfg, device)
        self.weight("wo", (h * dv, d), cfg, device, fan_in=h * dv)


def attention_params(cfg, device):
    """A self-attention's parameters: `MLA` or `Attention` by `cfg.attention`."""
    return MLA(cfg, device) if cfg.attention == "mla" else Attention(cfg, device)


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
    """Scores in the compute dtype, then in the softmax dtype: / sqrt(Dqk),
    the NEG_INF mask, softmax, cast to q's dtype; k_valid is (B, S) or None.
    The context is (B, T, H, Dv), v's width."""
    b, t, h, dh = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
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
    ctx = torch.matmul(w, v.permute(0, 2, 1, 3))  # (B, Hkv, G*T, Dv)
    return ctx.reshape(b, hkv, g, t, dv).permute(0, 3, 1, 2, 4).reshape(b, t, h, dv)


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
    again when the caller needs them too (the engine's cache). Latent
    attention (`cfg.attention == "mla"`) projects and expands its own."""
    causal = cfg.causal if causal is None else causal
    if cfg.attention == "mla":
        q, c, k_pe = mla_project(cfg, params, x, positions)
        k, v = mla_expand(cfg, params, c, k_pe)
        return out_proj(cfg, params, attend(cfg, q, k, v, positions, positions, k_valid,
                                            causal))
    q = project_q(cfg, params, x, positions)
    k, v = kv if kv is not None else project_kv(cfg, params, x, positions)
    ctx = attend(cfg, q, k, v, positions, positions, k_valid, causal)
    return out_proj(cfg, params, ctx)


def _prefill_attend(cfg, q, k, v, positions):
    """Causal attention of a serving prefill over positions 0..T-1: the fused
    kernel for a CUDA tensor, `attend` (the same bits as `self_attention`)
    for any other. Each call is noted in `kernel_calls["attention_prefill"]`."""
    if not cfg.causal:
        raise ValueError("a serving prefill's self-attention is causal")
    kernel_calls.note("attention_prefill")
    if uses_kernel("auto", q):
        return attention_prefill_cuda(q, k, v)
    return attend(cfg, q, k, v, positions, positions, None, True)


def prefill_self_attention(cfg, params, x, positions, kv):
    """Causal `self_attention` of a serving prefill, no gradient, `kv` the
    (k, v) that `project_kv` gives for x (`_prefill_attend`)."""
    q = project_q(cfg, params, x, positions)
    k, v = kv
    return out_proj(cfg, params, _prefill_attend(cfg, q, k, v, positions))


def prefill_mla_attention(cfg, params, x, positions):
    """Latent attention of a serving prefill, no gradient: (out, c, k_pe),
    c (B, T, r) and k_pe (B, T, rope) what the cache keeps. The expansion
    to per-head K and V is the span `mla.expand`; v is a strided view of
    it, read by the kernel in place."""
    q, c, k_pe = mla_project(cfg, params, x, positions)
    with spans.span("mla.expand"):
        k, v = mla_expand(cfg, params, c, k_pe)
    out = out_proj(cfg, params, _prefill_attend(cfg, q, k, v, positions))
    return out, c, k_pe[:, :, 0]


def _mla_rope(cfg, t, positions):
    """`t` with its last `qk_rope_head_dim` columns rotated (a new tensor)."""
    nope = t.shape[-1] - cfg.qk_rope_head_dim
    return torch.cat([t[..., :nope], rope(t[..., nope:], positions, cfg.rope_theta)], dim=-1)


def mla_project(cfg, params, x, positions):
    """x (B, T, d) -> q (B, T, H, nope + rope) with its rope part rotated,
    c (B, T, r) normalised, k_pe (B, T, 1, rope) rotated."""
    b, t, _ = x.shape
    r = cfg.kv_lora_rank
    q = (x @ params.wq.to(x.dtype)).reshape(b, t, cfg.n_heads, -1)
    q = _mla_rope(cfg, q, positions)
    ckv = x @ params.wkva.to(x.dtype)
    c = rmsnorm(params.kv_norm, ckv[..., :r], cfg.norm_eps)
    k_pe = rope(ckv[..., None, r:], positions, cfg.rope_theta)
    return q, c, k_pe


def mla_expand(cfg, params, c, k_pe):
    """The latent to per-head keys and values: k (B, S, H, nope + rope), k_pe
    repeated in every head; v (B, S, H, v) a strided view of W_kvb's product."""
    b, s, _ = c.shape
    h, nope = cfg.n_heads, cfg.qk_nope_head_dim
    kv = (c @ params.wkvb.to(c.dtype)).reshape(b, s, h, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, cfg.qk_rope_head_dim)], dim=-1)
    return k, kv[..., nope:]


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


def decode_mla_attention(cfg, params, x, cache_c, cache_pe, position):
    """One-token latent attention in the absorbed form: x (B, 1, d); the
    cache's c (B, S, r) and k_pe (B, S, rope); position (B,). Writes the new
    token's c and k_pe into the cache in place at `position` (clamped as
    `decode_self_attention` clamps it) and returns out (B, 1, d):
      q_lat = q_nope W_uk^T      (B, H, r), W_uk W_kvb's key columns
      s = (q_lat · c + q_pe · k_pe) / sqrt(nope + rope), over the valid slots
      out = (softmax(s) c) W_uv, then W_o, W_uv W_kvb's value columns.
    Products in the compute dtype, the softmax in the softmax dtype, as
    `attend`'s."""
    b = x.shape[0]
    h, r, nope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    pos = position[:, None]
    q, c, k_pe = mla_project(cfg, params, x, pos)
    s = cache_c.shape[1]
    slot = position.clamp(0, s - 1)
    rows = torch.arange(b, device=x.device)
    cache_c[rows, slot] = c[:, 0].to(cache_c.dtype)
    cache_pe[rows, slot] = k_pe[:, 0, 0].to(cache_pe.dtype)
    w = params.wkvb.to(x.dtype).reshape(r, h, nope + cfg.v_head_dim)
    q = q[:, 0]  # (B, H, nope + rope)
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :nope], w[..., :nope])
    scores = (torch.matmul(q_lat, cache_c.transpose(1, 2))
              + torch.matmul(q[..., nope:], cache_pe.transpose(1, 2)))  # (B, H, S)
    scores = scores.to(_softmax_dtype(cfg))
    scores.div_((nope + cfg.qk_rope_head_dim) ** 0.5)
    valid = torch.arange(s, device=x.device)[None] <= pos  # (B, S)
    scores.masked_fill_(~valid[:, None], NEG_INF)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhr,rhv->bhv", torch.matmul(p, cache_c), w[..., nope:])
    return out_proj(cfg, params, ctx[:, None])
