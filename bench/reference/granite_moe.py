"""granite-moe's forward pass in plain PyTorch, float32 with TF32 off.

The equations are the port's (pre-norm blocks, RMSNorm with eps 1e-6,
rotary embeddings on half-split heads, grouped-query attention with a
causal mask, a softmax router whose top-k gates are renormalised, SwiGLU
experts, tied embeddings): granite's embedding, attention, residual and
logits multipliers are not modelled, by the port or here. Expert dispatch
follows the deployment the benchmark states: the prompt's tokens are split
over `shards` sequence shards, each shard's tokens batch-major, and each
(shard, expert) pair keeps at most `capacity` entries in token order; a
dropped entry adds nothing. Tokens past the prompt (decoded one at a time,
whose dispatch has room for all) are never dropped.

Weights come as the benchmark made them (`weight_specs`): `W[name]`,
per-layer tensors stacked on a leading layer axis (`layers.attn.wq` is (L,
d, H*Dh)). Each layer is upcast to float32 when it is used, so the
reference holds one float32 layer at a time. `quant="fp8"` is the control:
every matrix product's operands rounded to float8 e4m3 with one scale per
tensor.

As every language model's reference module (`bench/drivers/lm.py`), this
one also gives the model's weights by name (`weight_specs`) and the counts
its metrics are held to, from shapes alone: parameters, a prefill's model
and attention operations, a decode step's, and the expert exchange's legs
and bytes. The counts are a copy of `repro_torch/tools/roofline.py`'s
formulas for the moe family (`param_counts`, `model_flops`), with causal
attention counted once: a later change to the program does not move them.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-6
FP8_MAX = 448.0


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    """Entries an expert takes from one shard: ceil(k n / E * factor), +1,
    rounded up to a multiple of 4, at least 4."""
    c = int(n_tokens * top_k / n_experts * factor) + 1
    return max(4, -(-c // 4) * 4)


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def weight_specs(m: dict, shards: int) -> dict:
    """name -> (shape, kind, fan_in): kind "matrix", "embed" or "scale";
    `layers.<name>` stacks every layer's tensor on a leading axis."""
    d, dh, l = m["d_model"], head_dim(m), m["n_layers"]
    h, hkv, f = m["n_heads"], m["n_kv_heads"], m.get("moe_d_ff") or m["d_ff"]
    e = -(-m["n_experts"] // shards) * shards
    return {
        "embed.table": ((padded_vocab(m), d), "embed", None),
        "layers.ln1.scale": ((l, d), "scale", None),
        "layers.attn.wq": ((l, d, h * dh), "matrix", d),
        "layers.attn.wk": ((l, d, hkv * dh), "matrix", d),
        "layers.attn.wv": ((l, d, hkv * dh), "matrix", d),
        "layers.attn.wo": ((l, h * dh, d), "matrix", h * dh),
        "layers.ln2.scale": ((l, d), "scale", None),
        "layers.moe.router": ((l, d, e), "matrix", d),
        "layers.moe.wi": ((l, e, d, f), "matrix", d),
        "layers.moe.wg": ((l, e, d, f), "matrix", d),
        "layers.moe.wo": ((l, e, f, d), "matrix", f),
        "final_norm.scale": ((d,), "scale", None),
    }


# --- counts, from shapes -------------------------------------------------------


def param_counts(m: dict) -> tuple[int, int]:
    """(total, active per token) parameters, the embedding counted once."""
    d, dh, l = m["d_model"], head_dim(m), m["n_layers"]
    attn = d * m["n_heads"] * dh + 2 * d * m["n_kv_heads"] * dh + m["n_heads"] * dh * d
    emb = padded_vocab(m) * d
    f = m.get("moe_d_ff") or m["d_ff"]
    router = d * m["n_experts"]
    expert = 3 * d * f
    total = emb + l * (attn + router + m["n_experts"] * expert)
    active = emb + l * (attn + router + m["n_experts_per_tok"] * expert)
    return total, active


def attention_flops(m: dict, batch: int, contexts) -> float:
    """Score and value products, 4 H Dh per (query, key) pair, summed over
    the keys each query sees (`contexts`: one count a query) and the layers."""
    return 4.0 * batch * m["n_heads"] * head_dim(m) * float(sum(contexts)) * m["n_layers"]


def prefill_attention_flops(m: dict, batch: int, tokens: int) -> float:
    """A prefill's causal attention over all layers: query i sees i + 1 keys."""
    return attention_flops(m, batch, [tokens * (tokens + 1) / 2])


def prefill_flops(m: dict, batch: int, tokens: int) -> float:
    """2 N_active per token, and causal attention counted once."""
    _, active = param_counts(m)
    return 2.0 * active * batch * tokens + prefill_attention_flops(m, batch, tokens)


def decode_step_flops(m: dict, batch: int, context: int) -> float:
    """One token a sequence over a cache of `context` positions (itself included)."""
    _, active = param_counts(m)
    return 2.0 * active * batch + attention_flops(m, batch, [context])


def exchange_legs(m: dict) -> int:
    """Legs of the expert exchange in a prefill: out and back, every layer."""
    return 2 * m["n_layers"]


def leg_wire_bytes(m: dict, batch: int, tokens: int, shards: int) -> int:
    """Bytes of one exchange leg of a prefill on the mesh: every shard's
    (S, E_loc x capacity, d) send buffer, in the model's dtype."""
    e_pad = -(-m["n_experts"] // shards) * shards
    cap = capacity(batch * tokens // shards, m["n_experts_per_tok"], e_pad,
                   m.get("capacity_factor", 1.25))
    itemsize = 2 if m["dtype"] == "bfloat16" else 4
    return shards * shards * (e_pad // shards) * cap * m["d_model"] * itemsize


# --- the forward pass ------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a, b, quant):
    if quant == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * scale


def _rope(x, positions, theta):
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(cfg, lw, h, positions, quant, q_block):
    b, t, _ = h.shape
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    dh = head_dim(cfg)
    q = _rope(_mm(h, lw["attn.wq"], quant).reshape(b, t, nh, dh), positions, cfg["rope_theta"])
    k = _rope(_mm(h, lw["attn.wk"], quant).reshape(b, t, nkv, dh), positions, cfg["rope_theta"])
    v = _mm(h, lw["attn.wv"], quant).reshape(b, t, nkv, dh)
    kh = k.repeat_interleave(nh // nkv, dim=2).permute(0, 2, 3, 1)  # (B, H, Dh, S)
    vh = v.repeat_interleave(nh // nkv, dim=2).transpose(1, 2)  # (B, H, S, Dh)
    out = torch.empty((b, t, nh, dh), dtype=torch.float32, device=h.device)
    for i in range(0, t, q_block):
        qi = q[:, i:i + q_block].transpose(1, 2)  # (B, H, Q, Dh)
        s = _mm(qi, kh, quant) / math.sqrt(dh)
        causal = positions[None, :] <= positions[i:i + q_block, None]
        s = s.masked_fill(~causal, float("-inf"))
        out[:, i:i + q_block] = _mm(torch.softmax(s, dim=-1), vh, quant).transpose(1, 2)
    return _mm(out.reshape(b, t, nh * dh), lw["attn.wo"], quant), k, v


def _moe(cfg, lw, h, quant, *, shards, prompt_len, factor, stats=None):
    """h (B, T, d) -> (B, T, d): route, drop past capacity, run the experts.
    `stats`, when given, adds the prompt's routed and dropped entries."""
    b, t, d = h.shape
    e, top = cfg["n_experts"], cfg["n_experts_per_tok"]
    probs = torch.softmax(_mm(h, lw["moe.router"], quant), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :top], experts[..., :top]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(experts, dtype=torch.bool)
    tp = min(prompt_len, t)
    if tp >= shards and tp % shards == 0:
        per = tp // shards
        cap = capacity(b * per, top, e, factor)
        # shard s holds positions [s*per, (s+1)*per) of every row, batch-major
        ex = experts[:, :tp].reshape(b, shards, per, top).transpose(0, 1).reshape(shards, -1, top)
        onehot = torch.nn.functional.one_hot(ex, e).to(torch.int32)  # (S, n, k, E)
        before = torch.cumsum(onehot.sum(2), dim=1) - onehot.sum(2)  # earlier tokens per expert
        rank = torch.gather(before, 2, ex)  # (S, n, k)
        kept = (rank < cap).reshape(shards, b, per, top).transpose(0, 1).reshape(b, tp, top)
        keep[:, :tp] = kept
        if stats is not None:
            stats["routed"] = stats.get("routed", 0) + kept.numel()
            stats["dropped"] = stats.get("dropped", 0) + int((~kept).sum())
    flat_h = h.reshape(-1, d)
    flat_e = experts.reshape(-1, top)
    flat_g = (gates * keep).reshape(-1, top)
    y = torch.zeros_like(flat_h)
    for x in range(e):
        tok, slot = torch.nonzero((flat_e == x) & keep.reshape(-1, top), as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat_h[tok]
        act = torch.nn.functional.silu(_mm(xe, lw["moe.wg"][x], quant)) * _mm(xe, lw["moe.wi"][x], quant)
        y.index_add_(0, tok, _mm(act, lw["moe.wo"][x], quant) * flat_g[tok, slot][:, None])
    return y.reshape(b, t, d)


def forward(W, cfg: dict, tokens: torch.Tensor, *, logit_positions, shards: int,
            prompt_len: int, quant: str | None = None, cache_sink=None, q_block: int = 512,
            stats: dict | None = None):
    """Logits (B, len(logit_positions), vocab) in float32 at the positions given.

    `cache_sink(layer, tensors)`, when given, sees each layer's cache
    entries by the names of the port's cache: "k", the rotated keys, and
    "v", the values, (B, T, Hkv, Dh) in float32. `stats`, when given, gains the
    prompt's expert entries over all layers: `routed` and `dropped` (past
    capacity).
    """
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(W, cfg, tokens, logit_positions, shards, prompt_len, quant,
                        cache_sink, q_block, stats)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def _forward(W, cfg, tokens, logit_positions, shards, prompt_len, quant, cache_sink, q_block,
             stats):
    b, t = tokens.shape
    table = W["embed.table"]
    x = table[tokens.long()].float()
    positions = torch.arange(t, device=tokens.device)
    names = [n[len("layers."):] for n in W if n.startswith("layers.")]
    for i in range(cfg["n_layers"]):
        lw = {n: W["layers." + n][i].float() for n in names}
        a, k, v = _attention(cfg, lw, _rms(x, lw["ln1.scale"]), positions, quant, q_block)
        if cache_sink is not None:
            cache_sink(i, {"k": k, "v": v})
        x = x + a
        x = x + _moe(cfg, lw, _rms(x, lw["ln2.scale"]), quant, shards=shards,
                     prompt_len=prompt_len, factor=cfg["capacity_factor"], stats=stats)
        del lw, a, k, v
    pos = torch.as_tensor(logit_positions, device=tokens.device)
    xn = _rms(x[:, pos], W["final_norm.scale"].float())
    return _mm(xn, table[:cfg["vocab_size"]].float().T, quant)
