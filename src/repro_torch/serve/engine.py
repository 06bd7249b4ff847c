"""Serving: KV cache, prefill and one-token decode for the dense, vlm and moe
families.

Counterpart of `repro/serve/engine.py`. The cache is a dict of tensors on
one device, written in place: `prefill` fills it and returns the last
token's logits, `decode_step` appends one token and returns float32 logits.
A MoE model given a `VirtualMesh` dispatches its experts through the
mesh's shuffle, ChaCha20-encrypted in prefill when `secure_moe` is set (a
decode step whose single token does not split over the shards takes the
replicated dispatch, which has no exchange). The reference's `cache_specs`
(a PartitionSpec tree) has no counterpart on one card; the ssm, hybrid and
audio families are ROADMAP item 10 and raise NotImplementedError.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_norm, compute_dtype, embed_apply, mlp_apply, unembed_apply
from repro_torch.models.lm import check_family


def init_cache(cfg, batch: int, max_seq: int, device=None, dtype=None) -> dict:
    """{"k", "v": (L, B, S, Hkv, Dh) in the compute dtype, "pos": (B,) int32}."""
    check_family(cfg)
    device = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(cfg, model, tokens, cache, mesh=None, secure_moe=None):
    """Fill `cache` with `tokens` (B, Tp) in place; returns the last token's
    logits (B, V_pad) in the compute dtype. Cache positions past Tp are
    zeroed, as the reference's padded cache has them."""
    check_family(cfg)
    b, t = tokens.shape
    x = embed_apply(cfg, model.embed, tokens)
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    for i, p in enumerate(model.layers):
        hn = apply_norm(cfg, p.ln1, x)
        k, v = attn.project_kv(cfg, p.attn, hn, positions)
        x = x + attn.self_attention(cfg, p.attn, hn, positions, kv=(k, v))
        for store, new in ((cache["k"][i], k), (cache["v"][i], v)):
            store[:, :t] = new
            store[:, t:] = 0
        del k, v
        hn = apply_norm(cfg, p.ln2, x)
        if cfg.family == "moe":
            y, _, _ = moe_mod.moe_apply(cfg, p.moe, hn, mesh=mesh, secure=secure_moe)
            x = x + y
        else:
            x = x + mlp_apply(cfg, p.mlp, hn)
    cache["pos"].fill_(t)
    x = apply_norm(cfg, model.final_norm, x[:, -1:])
    return unembed_apply(cfg, model.embed, x)[:, 0]


@torch.no_grad()
def decode_step(cfg, model, cache, tokens, mesh=None):
    """tokens: (B, 1) -- append one token at `cache["pos"]`; returns float32
    logits (B, V_pad)."""
    check_family(cfg)
    pos = cache["pos"]
    x = embed_apply(cfg, model.embed, tokens)
    for i, p in enumerate(model.layers):
        hn = apply_norm(cfg, p.ln1, x)
        a, _, _ = attn.decode_self_attention(cfg, p.attn, hn, cache["k"][i], cache["v"][i], pos)
        x = x + a
        hn = apply_norm(cfg, p.ln2, x)
        if cfg.family == "moe":
            y, _, _ = moe_mod.moe_apply(cfg, p.moe, hn, mesh=mesh)
            x = x + y
        else:
            x = x + mlp_apply(cfg, p.mlp, hn)
    pos.add_(1)
    x = apply_norm(cfg, model.final_norm, x)
    return unembed_apply(cfg, model.embed, x)[:, 0].float()
