"""Moonlight-16B-A3B's forward pass in plain PyTorch, float32 with TF32 off.

The equations (hf:moonshotai/Moonlight-16B-A3B, config.json, model_type
deepseek_v3), pre-norm blocks with RMSNorm (eps `norm_eps`, 1e-5):

  attention, every layer (multi-head latent attention, q_lora_rank null):
    q = h W_q                        (H, nope + rope), the rope part rotated
    [c, k_pe] = h W_kva              r + rope; c = RMSNorm(c); k_pe rotated,
                                     one for every head
    [k_nope, v] = c W_kvb            (H, nope + v), each head's key columns
                                     then its value columns
    k = [k_nope, k_pe]
    out = softmax(q k^T / sqrt(nope + rope), causal) v, then W_o
  layer 0 (first_k_dense_replace 1): a SwiGLU MLP of `d_ff`
  layers 1..L-1: 64 routed SwiGLU experts of `moe_d_ff`, top 6, and the
    shared experts, one SwiGLU of `shared_d_ff`, added ungated:
    scores = sigmoid(h W_r)                       float32
    experts = top 6 of scores + router_bias      (n_group = topk_group = 1)
    gates = their unbiased scores / their sum x routed_scaling (2.446)
  logits = RMSNorm(x) W_head^T                    an untied head

Rotation is the half-split rope (base `rope_theta`, 50,000, no scaling)
over the rope columns, the port's convention: the published model rotates
interleaved pairs, a fixed permutation of W_q's and W_kva's rope columns,
which random weights do not tell apart. Expert dispatch follows the
deployment the benchmark states, as `granite_moe.py`'s: the prompt's
tokens are split over `shards` sequence shards, each shard's tokens
batch-major, and each (shard, expert) pair keeps at most `capacity`
entries in token order; a dropped entry adds nothing (the published model
drops none). Tokens past the prompt are never dropped.

Weights come as the benchmark made them (`weight_specs`), per-layer tensors
stacked on a leading layer axis: `layers.<name>` over every layer,
`layers.0.<name>` layer 0's own, `layers.1:<L>.<name>` a stack over layers
1..L-1 (`bench/drivers/lm.py`). Each layer is upcast to float32 when it is
used, so the reference holds one float32 layer at a time beside the bf16
stacks. `quant="fp8"` is the control: every matrix product's operands
rounded to float8 e4m3 with one scale per tensor.

`cache_sink` sees the cache of the layers `checked_layers` names, unless
`cache_layers` says otherwise: the cell's check holds the program's cache
to the reference's there, where a bf16 program has not yet parted from
float32 on more than one routed layer's choices.

The counts the metrics are held to come from shapes alone: parameters, a
prefill's model and attention operations (2 H (nope + rope + v) a causal
query-key pair a layer), a decode step's, and the expert exchange's legs
(out and back, every MoE layer) and bytes.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    """Entries an expert takes from one shard: ceil(k n / E * factor), +1,
    rounded up to a multiple of 4, at least 4."""
    c = int(n_tokens * top_k / n_experts * factor) + 1
    return max(4, -(-c // 4) * 4)


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def padded_experts(m: dict, shards: int) -> int:
    return -(-m["n_experts"] // shards) * shards


def weight_specs(m: dict, shards: int) -> dict:
    """name -> (shape, kind, fan_in): kind "matrix", "embed" or "scale". The
    router's bias is a "matrix" of fan-in 10,000: N(0, 0.01^2) in the
    served dtype."""
    d, l, h, r = m["d_model"], m["n_layers"], m["n_heads"], m["kv_lora_rank"]
    nope, rope, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    fd, f, fs = m["d_ff"], m["moe_d_ff"], m["shared_d_ff"]
    e, dense = padded_experts(m, shards), m["first_dense_layers"]
    moe = f"layers.{dense}:{l}"
    n_moe = l - dense
    specs = {
        "embed.table": ((padded_vocab(m), d), "embed", None),
        "layers.ln1.scale": ((l, d), "scale", None),
        "layers.attn.wq": ((l, d, h * (nope + rope)), "matrix", d),
        "layers.attn.wkva": ((l, d, r + rope), "matrix", d),
        "layers.attn.kv_norm.scale": ((l, r), "scale", None),
        "layers.attn.wkvb": ((l, r, h * (nope + dv)), "matrix", r),
        "layers.attn.wo": ((l, h * dv, d), "matrix", h * dv),
        "layers.ln2.scale": ((l, d), "scale", None),
        f"{moe}.moe.router": ((n_moe, d, e), "matrix", d),
        f"{moe}.moe.router_bias": ((n_moe, e), "matrix", 10_000),
        f"{moe}.moe.wi": ((n_moe, e, d, f), "matrix", d),
        f"{moe}.moe.wg": ((n_moe, e, d, f), "matrix", d),
        f"{moe}.moe.wo": ((n_moe, e, f, d), "matrix", f),
        f"{moe}.moe.shared.wi": ((n_moe, d, fs), "matrix", d),
        f"{moe}.moe.shared.wg": ((n_moe, d, fs), "matrix", d),
        f"{moe}.moe.shared.wo": ((n_moe, fs, d), "matrix", fs),
        "final_norm.scale": ((d,), "scale", None),
        "head.table": ((padded_vocab(m), d), "matrix", d),
    }
    for i in range(dense):
        specs.update({f"layers.{i}.mlp.wi": ((d, fd), "matrix", d),
                      f"layers.{i}.mlp.wg": ((d, fd), "matrix", d),
                      f"layers.{i}.mlp.wo": ((fd, d), "matrix", fd)})
    return specs


# --- counts, from shapes -------------------------------------------------------


def _attention_params(m: dict) -> int:
    d, h, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    nope, rope, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    return d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) + h * dv * d


def param_counts(m: dict) -> tuple[int, int]:
    """(total, active per token) parameters of the layers, the embedding and
    the head left out (a lookup, and a product a prefill makes for its last
    tokens alone)."""
    d, l = m["d_model"], m["n_layers"]
    attn = _attention_params(m)
    dense = m["first_dense_layers"] * (attn + 3 * d * m["d_ff"])
    moe = attn + d * m["n_experts"] + 3 * d * m["shared_d_ff"]
    expert = 3 * d * m["moe_d_ff"]
    n_moe = l - m["first_dense_layers"]
    total = dense + n_moe * (moe + m["n_experts"] * expert)
    active = dense + n_moe * (moe + m["n_experts_per_tok"] * expert)
    return total, active


def attention_flops(m: dict, batch: int, contexts) -> float:
    """Score and value products, 2 H (nope + rope + v) per (query, key)
    pair, summed over the keys each query sees (`contexts`: one count a
    query) and the layers."""
    per_pair = 2 * m["n_heads"] * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                                   + m["v_head_dim"])
    return float(per_pair) * batch * float(sum(contexts)) * m["n_layers"]


def prefill_attention_flops(m: dict, batch: int, tokens: int) -> float:
    """A prefill's causal attention over all layers: query i sees i + 1 keys."""
    return attention_flops(m, batch, [tokens * (tokens + 1) / 2])


def _head_flops(m: dict, batch: int) -> float:
    return 2.0 * m["vocab_size"] * m["d_model"] * batch


def prefill_flops(m: dict, batch: int, tokens: int) -> float:
    """2 N_active per token, causal attention counted once, and the head on
    each prompt's last token."""
    _, active = param_counts(m)
    return (2.0 * active * batch * tokens + prefill_attention_flops(m, batch, tokens)
            + _head_flops(m, batch))


def decode_step_flops(m: dict, batch: int, context: int) -> float:
    """One token a sequence over a cache of `context` positions (itself included)."""
    _, active = param_counts(m)
    return 2.0 * active * batch + attention_flops(m, batch, [context]) + _head_flops(m, batch)


def exchange_legs(m: dict) -> int:
    """Legs of the expert exchange in a prefill: out and back, every MoE layer."""
    return 2 * (m["n_layers"] - m["first_dense_layers"])


def leg_wire_bytes(m: dict, batch: int, tokens: int, shards: int) -> int:
    """Bytes of one exchange leg of a prefill on the mesh: every shard's
    (S, E_loc x capacity, d) send buffer, in the model's dtype."""
    e_pad = padded_experts(m, shards)
    cap = capacity(batch * tokens // shards, m["n_experts_per_tok"], e_pad,
                   m.get("capacity_factor", 1.25))
    itemsize = 2 if m["dtype"] == "bfloat16" else 4
    return shards * shards * (e_pad // shards) * cap * m["d_model"] * itemsize


# --- the forward pass ------------------------------------------------------------


def checked_layers(m: dict) -> int:
    """Layers whose cache `forward` shows `cache_sink` by default: those
    whose input has passed one routed layer at most (the dense first layers
    and two more; 3 of Moonlight's 27).

    Past them a bf16 program and the float32 reference part by routing. At
    the first routed layer 5% of tokens pick another top 6, nearly all on
    near ties: the reference's gap between its 6th and 7th biased scores is
    0.0009 at their median, 0.011 over all tokens. A token so parted moves
    its next latent by ~30%, enough to part again at the next routed layer;
    with random weights every token has parted by the last layer. In bf16
    on an H100 at the cell's 4 x 8,192 tokens the cache reads 0.003, 0.009,
    0.07, 0.12 at layers 0-3 and 0.60 at 26; the fp8 control 0.31 by layer
    2, 4.3x the program."""
    return min(m["n_layers"], m["first_dense_layers"] + 2)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a, b, quant):
    if quant == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """x (B, T, H, D): the half-split rotation of all D columns."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(m, lw, h, positions, quant, q_block):
    """h (B, T, d) -> (out (B, T, d), c (B, T, r), k_pe (B, T, rope))."""
    b, t, _ = h.shape
    nh, r = m["n_heads"], m["kv_lora_rank"]
    nope, rope, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    theta = m["rope_theta"]
    q = _mm(h, lw["attn.wq"], quant).reshape(b, t, nh, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], positions, theta)], dim=-1)
    ckv = _mm(h, lw["attn.wkva"], quant)
    c = _rms(ckv[..., :r], lw["attn.kv_norm.scale"], m["norm_eps"])
    k_pe = _rope(ckv[..., None, r:], positions, theta)  # (B, T, 1, rope)
    kv = _mm(c, lw["attn.wkvb"], quant).reshape(b, t, nh, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, t, nh, rope)], dim=-1)
    kh = k.permute(0, 2, 3, 1)  # (B, H, Dqk, S)
    vh = kv[..., nope:].transpose(1, 2)  # (B, H, S, Dv)
    del kv, k
    out = torch.empty((b, t, nh, dv), dtype=torch.float32, device=h.device)
    for i in range(0, t, q_block):
        qi = q[:, i:i + q_block].transpose(1, 2)  # (B, H, Q, Dqk)
        s = _mm(qi, kh, quant) / math.sqrt(nope + rope)
        causal = positions[None, :] <= positions[i:i + q_block, None]
        s = s.masked_fill(~causal, float("-inf"))
        out[:, i:i + q_block] = _mm(torch.softmax(s, dim=-1), vh, quant).transpose(1, 2)
        del s
    return _mm(out.reshape(b, t, nh * dv), lw["attn.wo"], quant), c, k_pe[:, :, 0]


def _swiglu(h, wi, wg, wo, quant):
    return _mm(torch.nn.functional.silu(_mm(h, wg, quant)) * _mm(h, wi, quant), wo, quant)


def _route(m, lw, h, quant):
    """(gates, experts) (B, T, k): the top k of the biased sigmoid scores,
    ties to the lower index; gates the unbiased scores renormalised, times
    `routed_scaling`."""
    scores = torch.sigmoid(_mm(h, lw["moe.router"], quant))
    choice = scores + lw["moe.router_bias"]
    e = m["n_experts"]
    choice[..., e:] = float("-inf")  # padding experts never win
    experts = torch.sort(choice, dim=-1, descending=True, stable=True)[1][..., :m["n_experts_per_tok"]]
    gates = torch.gather(scores, -1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9) * m["routed_scaling"]
    return gates, experts


def _moe(m, lw, h, quant, *, shards, prompt_len, factor, stats=None):
    """h (B, T, d) -> (B, T, d): route, drop past capacity, run the routed
    experts, add the shared experts. `stats`, when given, adds the prompt's
    routed and dropped entries."""
    b, t, d = h.shape
    top = m["n_experts_per_tok"]
    e = lw["moe.wi"].shape[0]  # padded to the shards, as the port's
    gates, experts = _route(m, lw, h, quant)
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
        del onehot, before
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
        out = _swiglu(flat_h[tok], lw["moe.wi"][x], lw["moe.wg"][x], lw["moe.wo"][x], quant)
        y.index_add_(0, tok, out * flat_g[tok, slot][:, None])
    y = y + _swiglu(flat_h, lw["moe.shared.wi"], lw["moe.shared.wg"], lw["moe.shared.wo"], quant)
    return y.reshape(b, t, d)


def _layer(W, i: int) -> dict:
    """Layer i's weights in float32, by their names after `layers.[<spec>.]`."""
    out = {}
    for name, w in W.items():
        if not name.startswith("layers."):
            continue
        head, _, rest = name[len("layers."):].partition(".")
        if head.isdecimal():
            if int(head) == i:
                out[rest] = w.float()
        elif ":" in head:
            a, b = (int(v) for v in head.split(":"))
            if a <= i < b:
                out[rest] = w[i - a].float()
        else:
            out[name[len("layers."):]] = w[i].float()
    return out


def forward(W, cfg: dict, tokens: torch.Tensor, *, logit_positions, shards: int,
            prompt_len: int, quant: str | None = None, cache_sink=None, q_block: int = 512,
            stats: dict | None = None, cache_layers: int | None = None):
    """Logits (B, len(logit_positions), vocab) in float32 at the positions given.

    `cache_sink(layer, tensors)`, when given, sees the cache entries of
    the first `cache_layers` layers (by default `checked_layers(cfg)`) by
    the names of the port's cache: "ckv", the normalised latent (B, T, r),
    and "kpe", the rotated key (B, T, rope), in float32.
    `stats`, when given, gains the prompt's expert entries over all MoE
    layers: `routed` and `dropped` (past capacity).
    """
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if cache_layers is None:
            cache_layers = checked_layers(cfg)
        return _forward(W, cfg, tokens, logit_positions, shards, prompt_len, quant,
                        cache_sink, q_block, stats, cache_layers)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def _forward(W, m, tokens, logit_positions, shards, prompt_len, quant, cache_sink, q_block,
             stats, cache_layers):
    b, t = tokens.shape
    eps = m["norm_eps"]
    x = W["embed.table"][tokens.long()].float()
    positions = torch.arange(t, device=tokens.device)
    for i in range(m["n_layers"]):
        lw = _layer(W, i)
        a, c, k_pe = _attention(m, lw, _rms(x, lw["ln1.scale"], eps), positions, quant, q_block)
        if cache_sink is not None and i < cache_layers:
            cache_sink(i, {"ckv": c, "kpe": k_pe})
        x = x + a
        h = _rms(x, lw["ln2.scale"], eps)
        if i < m["first_dense_layers"]:
            x = x + _swiglu(h, lw["mlp.wi"], lw["mlp.wg"], lw["mlp.wo"], quant)
        else:
            x = x + _moe(m, lw, h, quant, shards=shards, prompt_len=prompt_len,
                         factor=m["capacity_factor"], stats=stats)
        del lw, a, c, k_pe, h
    pos = torch.as_tensor(logit_positions, device=tokens.device)
    xn = _rms(x[:, pos], W["final_norm.scale"].float(), eps)
    return _mm(xn, W["head.table"][:m["vocab_size"]].float().T, quant)
