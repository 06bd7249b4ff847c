"""Serving: KV / state caches, prefill and one-token decode, per family.

Counterpart of `repro/serve/engine.py`. The cache is a dict of tensors on
one device, written in place: `prefill` fills it and returns the last
token's logits, `decode_step` appends one token and returns float32 logits.
Per family:
  dense | vlm | moe  "k", "v" (L, B, S, Hkv, Dh); with latent attention
                     (`cfg.attention == "mla"`) "ckv" (L, B, S, r), the
                     normalised latent, and "kpe" (L, B, S, rope), the
                     rotated key every head shares, in their place
  ssm                "tshift", "cshift" (L, B, 1, d): the normalised inputs'
                     last tokens; "wkv" (L, B, H, Dk, Dv) float32
  hybrid             "ssm_h" (L, B, H, N, P) float32, "conv" (L, B, W-1,
                     d_inner); "attn_k", "attn_v" per invocation of the
                     shared attention block
  audio              "k", "v" for the decoder's self-attention; "xk", "xv"
                     (L, B, S_enc, Hkv, Dh), the encoder's cross K/V that
                     prefill computes once and decode only reads
and "pos" (B,) int32 for all. A MoE model given a `VirtualMesh` dispatches
its experts through the mesh's shuffle, ChaCha20-encrypted in prefill when
`secure_moe` is set (a decode step whose single token does not split over
the shards takes the replicated dispatch, which has no exchange). The
reference's `cache_specs` (a PartitionSpec tree) has no counterpart on one
card.

A prefill's self-attention is `attention.prefill_self_attention`: on the
card one launch a layer of the fused attention kernel, counted in
`kernels.kernel_calls["attention_prefill"]` (as its plain version is on
the CPU); a decode step's is the plain path. A prefill's MoE layers move
their routed rows by the slot map (`models.moe._dispatch_rows`,
`_combine_rows`: on the card the dispatch and combine kernels, counted in
`kernel_calls["moe_dispatch"]` and `["moe_combine"]`).

A layer's kind (`models.lm.layer_kind`) decides whether it runs an MLP or
a MoE: a moe model's first `cfg.first_dense_layers` layers are dense.

Instruments (`repro_torch.tools.opcount`): a prefill is the span
`engine.prefill`, each self-attention in it `engine.attention` (a layer of
the dense, MoE and VLM families tagged with its index, `layer`, which the
MoE's `moe.route`, `shuffle.exchange`, `moe.experts`, `moe.combine` and
`moe.shared` spans and latent attention's `mla.expand` inherit);
every MoE layer of a prefill or a decode step adds its dropped expert
entries to the counter `moe.dropped_entries` and its routed ones (B·T·k) to
`moe.routed_entries`; every prefill adds the bytes it writes into the cache
(its tokens' entries, not the zeroed positions past them) to
`engine.cache_bytes`.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_norm, compute_dtype, embed_apply, mlp_apply, unembed_apply
from repro_torch.models.lm import check_family, encode_audio, layer_kind, output_head
from repro_torch.tools.opcount import counters, spans


def init_cache(cfg, batch: int, max_seq: int, device=None, dtype=None) -> dict:
    """The family's cache, zeroed (see the module's docstring); K/V and
    shifts in the compute dtype unless `dtype` is given."""
    check_family(cfg)
    device = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    l, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (l, batch, max_seq, hkv, dh)
    c = {"pos": zeros((batch,), torch.int32)}
    if cfg.attention == "mla" and cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(f"{cfg.name}: latent attention in the {cfg.family} family")
    if cfg.family == "ssm":
        h, dk = rwkv_mod.rwkv_dims(cfg)
        c.update(tshift=zeros((l, batch, 1, cfg.d_model)),
                 wkv=zeros((l, batch, h, dk, dk), torch.float32),
                 cshift=zeros((l, batch, 1, cfg.d_model)))
    elif cfg.family == "hybrid":
        d_inner, h = ssm_mod.ssm_dims(cfg)
        n_inv = max(cfg.n_layers // cfg.attn_every if cfg.attn_every else 0, 1)
        c.update(ssm_h=zeros((l, batch, h, cfg.ssm_state, ssm_mod.HEAD_P), torch.float32),
                 conv=zeros((l, batch, cfg.ssm_conv - 1, d_inner)),
                 attn_k=zeros((n_inv,) + kv[1:]), attn_v=zeros((n_inv,) + kv[1:]))
    elif cfg.attention == "mla":
        c.update(ckv=zeros((l, batch, max_seq, cfg.kv_lora_rank)),
                 kpe=zeros((l, batch, max_seq, cfg.qk_rope_head_dim)))
    else:
        c.update(k=zeros(kv), v=zeros(kv))
        if cfg.family == "audio":
            xkv = (l, batch, cfg.encoder_seq, hkv, dh)
            c.update(xk=zeros(xkv), xv=zeros(xkv))
    return c


def _cache_write(store, new):
    """`store.copy_(new)`, its bytes counted in `engine.cache_bytes`."""
    store.copy_(new)
    counters.add("engine.cache_bytes", new.numel() * store.element_size())


def _store_kv(cache_k, cache_v, k, v):
    """Write a prefill's (B, T, ...) entries (K and V, or latent attention's
    c and k_pe) into one layer's cache; the positions past T are zeroed, as
    the reference's padded cache has them."""
    t = k.shape[1]
    for store, new in ((cache_k, k), (cache_v, v)):
        _cache_write(store[:, :t], new)
        store[:, t:] = 0


def _layer_cache(cfg, cache, i):
    """Layer i's self-attention cache: (k, v), or latent attention's (ckv, kpe)."""
    names = ("ckv", "kpe") if cfg.attention == "mla" else ("k", "v")
    return cache[names[0]][i], cache[names[1]][i]


def _prefill_attn(cfg, p, x, positions, cache_a, cache_b):
    """Self-attention of a prefill, its cache entries (K and V, or latent
    attention's c and k_pe) into `cache_a`, `cache_b`; returns x + attn."""
    with spans.span("engine.attention"):
        hn = apply_norm(cfg, p.ln1, x)
        if cfg.attention == "mla":
            a, c, k_pe = attn.prefill_mla_attention(cfg, p.attn, hn, positions)
            _store_kv(cache_a, cache_b, c, k_pe)
            return x + a
        k, v = attn.project_kv(cfg, p.attn, hn, positions)
        x = x + attn.prefill_self_attention(cfg, p.attn, hn, positions, kv=(k, v))
        _store_kv(cache_a, cache_b, k, v)
        return x


def _moe_layer(cfg, p, hn, mesh, secure=None):
    """A MoE layer's output; its dropped and routed entries are counted."""
    y, _, dropped = moe_mod.moe_apply(cfg, p.moe, hn, mesh=mesh, secure=secure)
    counters.add("moe.dropped_entries", dropped)
    counters.add("moe.routed_entries", hn.shape[0] * hn.shape[1] * cfg.n_experts_per_tok)
    return y


@torch.no_grad()
def prefill(cfg, model, tokens, cache, mesh=None, frames=None, secure_moe=None):
    """Fill `cache` with `tokens` (B, Tp) in place (audio: and `frames` (B,
    S_enc, d), the frontend embeddings); returns the last token's logits
    (B, V_pad) in the compute dtype."""
    with spans.span("engine.prefill"):
        return _prefill(cfg, model, tokens, cache, mesh, frames, secure_moe)


def _prefill(cfg, model, tokens, cache, mesh, frames, secure_moe):
    check_family(cfg)
    b, t = tokens.shape
    x = embed_apply(cfg, model.embed, tokens)
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    fam = cfg.family
    if fam == "ssm":
        for i, p in enumerate(model.layers):
            x, states = B.apply_rwkv_block(cfg, p, x)
            for name, s in zip(("tshift", "wkv", "cshift"), states):
                _cache_write(cache[name][i], s)
    elif fam == "hybrid":
        every = cfg.attn_every or (cfg.n_layers + 1)
        inv = 0
        for i, p in enumerate(model.layers):
            x, h_end, conv_end = B.apply_mamba_block(cfg, p, x)
            _cache_write(cache["ssm_h"][i], h_end)
            _cache_write(cache["conv"][i], conv_end)
            if i % every == every - 1:
                sp = model.shared_attn
                x = _prefill_attn(cfg, sp, x, positions, cache["attn_k"][inv],
                                  cache["attn_v"][inv])
                x = x + mlp_apply(cfg, sp.mlp, apply_norm(cfg, sp.ln2, x))
                inv += 1
    elif fam == "audio":
        if frames is None:
            raise ValueError("audio prefill needs the frontend's frames")
        xk, xv = encode_audio(cfg, model, frames)
        _cache_write(cache["xk"], xk)
        _cache_write(cache["xv"], xv)
        del xk, xv
        for i, p in enumerate(model.decoder):
            x = _prefill_attn(cfg, p, x, positions, cache["k"][i], cache["v"][i])
            x = x + attn.cross_attention(cfg, p.xattn, apply_norm(cfg, p.lnx, x),
                                         (cache["xk"][i], cache["xv"][i]), positions)
            x = x + mlp_apply(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
    else:
        for i, p in enumerate(model.layers):
            with spans.tagged(layer=i):
                x = _prefill_attn(cfg, p, x, positions, *_layer_cache(cfg, cache, i))
                hn = apply_norm(cfg, p.ln2, x)
                if layer_kind(cfg, i) == "moe":
                    x = x + _moe_layer(cfg, p, hn, mesh, secure_moe)
                else:
                    x = x + mlp_apply(cfg, p.mlp, hn)
    cache["pos"].fill_(t)
    x = apply_norm(cfg, model.final_norm, x[:, -1:])
    return unembed_apply(cfg, output_head(cfg, model), x)[:, 0]


def _decode_attn(cfg, p, x, cache_a, cache_b, pos):
    hn = apply_norm(cfg, p.ln1, x)
    if cfg.attention == "mla":
        return x + attn.decode_mla_attention(cfg, p.attn, hn, cache_a, cache_b, pos)
    a, _, _ = attn.decode_self_attention(cfg, p.attn, hn, cache_a, cache_b, pos)
    return x + a


@torch.no_grad()
def decode_step(cfg, model, cache, tokens, mesh=None):
    """tokens: (B, 1) -- append one token at `cache["pos"]`; returns float32
    logits (B, V_pad)."""
    check_family(cfg)
    pos = cache["pos"]
    x = embed_apply(cfg, model.embed, tokens)
    fam = cfg.family
    if fam == "ssm":
        for i, p in enumerate(model.layers):
            y, tsh, wkv = rwkv_mod.rwkv_time_mix_step(cfg, p.tmix, apply_norm(cfg, p.ln1, x),
                                                      cache["tshift"][i], cache["wkv"][i])
            x = x + y
            y, csh = rwkv_mod.rwkv_channel_mix(cfg, p.tmix, apply_norm(cfg, p.ln2, x),
                                               cache["cshift"][i])
            x = x + y
            for name, s in (("tshift", tsh), ("wkv", wkv), ("cshift", csh)):
                cache[name][i].copy_(s)
    elif fam == "hybrid":
        every = cfg.attn_every or (cfg.n_layers + 1)
        inv = 0
        for i, p in enumerate(model.layers):
            y, h_new, conv_new = ssm_mod.ssm_decode_step(cfg, p.ssm, apply_norm(cfg, p.ln1, x),
                                                         cache["ssm_h"][i], cache["conv"][i])
            x = x + y
            cache["ssm_h"][i].copy_(h_new)
            cache["conv"][i].copy_(conv_new)
            if i % every == every - 1:
                sp = model.shared_attn
                x = _decode_attn(cfg, sp, x, cache["attn_k"][inv], cache["attn_v"][inv], pos)
                x = x + mlp_apply(cfg, sp.mlp, apply_norm(cfg, sp.ln2, x))
                inv += 1
    elif fam == "audio":
        for i, p in enumerate(model.decoder):
            x = _decode_attn(cfg, p, x, cache["k"][i], cache["v"][i], pos)
            x = x + attn.cross_attention(cfg, p.xattn, apply_norm(cfg, p.lnx, x),
                                         (cache["xk"][i], cache["xv"][i]), pos[:, None])
            x = x + mlp_apply(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
    else:
        for i, p in enumerate(model.layers):
            x = _decode_attn(cfg, p, x, *_layer_cache(cfg, cache, i), pos)
            hn = apply_norm(cfg, p.ln2, x)
            if layer_kind(cfg, i) == "moe":
                x = x + _moe_layer(cfg, p, hn, mesh)
            else:
                x = x + mlp_apply(cfg, p.mlp, hn)
    pos.add_(1)
    x = apply_norm(cfg, model.final_norm, x)
    return unembed_apply(cfg, output_head(cfg, model), x)[:, 0].float()
