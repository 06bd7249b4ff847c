"""Operations, bytes and peaks that rooflines and `mfu` are counted against.

Counted from shapes, never from a kernel: a later kernel that does the same
work is held to the same count. Peaks are one NVIDIA H100 SXM's (NVIDIA's
data sheet, dense, at its 700 W power limit). The model's parameter count
and FLOPs are a copy of `repro_torch/tools/roofline.py`'s formulas for the
moe family (`param_counts`, `model_flops`), with causal attention counted
once: a later change to the program does not move the yardstick.
"""

from __future__ import annotations

from bench.reference import granite_moe as ref_lm

PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_TF32 = 495e12  # FLOP/s, tensor cores
HBM_BW = 3.35e12  # B/s


# --- k-means -------------------------------------------------------------------


def kmeans_assign_s(n: int, k: int, d: int) -> float:
    """Least time of one assignment pass over n real points: 2 n k d
    operations at the TF32 peak, or the points and centres read once and one
    index a point written once, at the HBM rate; the larger."""
    flops = 2.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d + n)
    return max(flops / PEAK_TF32, nbytes / HBM_BW)


def kmeans_round_flops(n: int, k: int, d: int) -> float:
    """A round's useful operations: the distances (2 n k d) and the
    per-centre sums of the points (n d)."""
    return 2.0 * n * k * d + 1.0 * n * d


def kmeans_wire_words(k: int, d: int, shards: int) -> int:
    """Words of one wire row of a k-means round: ceil(k / S) slots of a key
    (int32), a count and d sums (float32)."""
    return -(-k // shards) * (2 + d)


def crypt_s(wire_bytes: float) -> float:
    """Least time of one keystream XOR over a wire: read once, written once."""
    return 2.0 * wire_bytes / HBM_BW


# --- granite-moe ---------------------------------------------------------------


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def moe_param_counts(m: dict) -> tuple[int, int]:
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


def prefill_flops(m: dict, batch: int, tokens: int) -> float:
    """2 N_active per token, and causal attention counted once (query i sees i + 1 keys)."""
    _, active = moe_param_counts(m)
    return 2.0 * active * batch * tokens + attention_flops(m, batch, [tokens * (tokens + 1) / 2])


def decode_step_flops(m: dict, batch: int, context: int) -> float:
    """One token a sequence over a cache of `context` positions (itself included)."""
    _, active = moe_param_counts(m)
    return 2.0 * active * batch + attention_flops(m, batch, [context])


def moe_leg_wire_bytes(m: dict, batch: int, tokens: int, shards: int) -> int:
    """Bytes of one exchange leg of a prefill on the mesh: every shard's
    (S, E_loc x capacity, d) send buffer, in the model's dtype."""
    e_pad = -(-m["n_experts"] // shards) * shards
    cap = ref_lm.capacity(batch * tokens // shards, m["n_experts_per_tok"], e_pad,
                       m.get("capacity_factor", 1.25))
    itemsize = 2 if m["dtype"] == "bfloat16" else 4
    return shards * shards * (e_pad // shards) * cap * m["d_model"] * itemsize
