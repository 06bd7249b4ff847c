"""RWKV-6 "Finch" block: data-dependent-decay linear attention, attention-free.

Counterpart of `repro/models/rwkv.py`. Time-mix core (per head, state S:
(Dk, Dv)):
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    y_t = r_t S_{t-1} + (r_t ⊙ u · k_t) v_t
with w_t = exp(-exp(ww_t)) a data-dependent per-channel decay from a
low-rank MLP on the token-shift mix, and u the current token's bonus.
Channel-mix is the squared-ReLU variant. As the reference's: static
token-shift mixes, per-head RMS normalisation of y.

Dtypes follow the reference's: the token-shift mixes and the matrix
products run in the activations' dtype, `_decay` and the WKV in float32,
`_head_norm` in float32 before the cast back. `w0`, `w_lora_a`, `w_lora_b`
and `u`, which the reference uses uncast, stay float32 in a serving model.

The WKV has two forms: `_wkv_scan`, one state update per token, and
`_wkv_blocked` (GLA-style), one per `WKV_BLOCK` tokens. The blocked form's
intra-block terms, and each block's state increment, are computed for all
blocks at once; only the state's carry runs block by block (a multiply and
an add a block), and the inter-block outputs come from the carried states
in one product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import Params, compute_dtype

HEAD_K = 64  # per-head key/value channels
DECAY_RANK = 32
# per-channel decay exponents bounded by BLOCK·|log w|_max < 88 (fp32 overflow)
WKV_BLOCK = 16


def rwkv_dims(cfg):
    return cfg.d_model // HEAD_K, HEAD_K


class RWKV(Params):
    """Time-mix and channel-mix (`cm_*`) parameters, the reference's names."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        h, dk = rwkv_dims(cfg)
        f32, dt = torch.float32, compute_dtype(cfg)
        self.param("mix", (5, d), dt, device, ("uniform",))  # r, k, v, w, g shift mixes
        for name in ("wr", "wk", "wv", "wg", "wo"):
            self.weight(name, (d, d), cfg, device)
        self.param("w0", (d,), f32, device, ("fill", -1.0))  # base decay logit
        self.param("w_lora_a", (d, DECAY_RANK), f32, device, ("normal", (1.0 / d) ** 0.5))
        self.param("w_lora_b", (DECAY_RANK, d), f32, device,
                   ("normal", 0.1 * (1.0 / DECAY_RANK) ** 0.5))
        self.param("u", (h, dk), f32, device, ("fill", 0.0))  # current-token bonus
        self.param("cm_mix", (2, d), dt, device, ("uniform",))
        self.weight("cm_k", (d, cfg.d_ff), cfg, device)
        self.weight("cm_v", (cfg.d_ff, d), cfg, device)
        self.weight("cm_r", (d, d), cfg, device)


def _shift(x, prev):
    """Token shift: x_{t-1}, with `prev` (B, 1, d) as the t=0 predecessor."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _head_norm(y, eps=1e-5):
    return y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)


def _bonus_matmul(r, u, kv):
    """Σ_k r_k u_k kv_kv per (batch, head): r (B, H, Dk), kv (B, H, Dk, Dv)."""
    return ((r * u)[..., None, :] @ kv)[..., 0, :]


def _wkv_scan(r, k, v, w, u, s0, chunk: int):
    """r, k, v: (B, T, H, Dk); w: (B, T, H, Dk) decay in (0, 1); s0: (B, H, Dk, Dv).

    One state update per token, in float32. With autograd on, each `chunk`
    of tokens (halved until it divides T) runs under a checkpoint, as the
    reference's per-chunk `jax.checkpoint`. Returns (y (B, T, H, Dv), s_end).
    """
    t = r.shape[1]
    xs = [a.float() for a in (r, k, v, w)]
    q = min(chunk, t)
    while t % q != 0:
        q //= 2

    def run(s, lo):
        ys = []
        steps = zip(*(a[:, lo:lo + q].unbind(1) for a in xs))  # unbind: see _wkv_blocked
        for ri, ki, vi, wi in steps:
            kv = ki[..., :, None] * vi[..., None, :]
            ys.append((ri[..., None, :] @ s)[..., 0, :] + _bonus_matmul(ri, u, kv))
            s = s * wi[..., None] + kv
        return s, torch.stack(ys, dim=1)

    grad = torch.is_grad_enabled() and any(a.requires_grad for a in xs + [u, s0])
    s, ys = s0.float(), []
    for lo in range(0, t, q):
        s, y = checkpoint(run, s, lo, use_reentrant=False) if grad else run(s, lo)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _wkv_blocked(r, k, v, w, u, s0, block: int = WKV_BLOCK):
    """Block-parallel WKV (GLA-style): one state update per BLOCK tokens.

    Within a block (Λ = exclusive cumsum log w from block start; Lb = total):
        y_i   = r̃_i·S + (r̃_i·k̂_j)_{j<i} v_j + ((r_i⊙u)·k_i) v_i
        S'    = diag(e^{Lb}) S + k̃ᵀ v
        r̃ = r⊙e^Λ (≤1),  k̂ = k⊙e^{-(Λ+log w)},  k̃ = k⊙e^{Lb-Λ-log w} (≤1)
    The only growing exponent, -(Λ+log w) ≤ BLOCK·|log w|_max, stays under
    fp32 overflow because `_decay` clamps the per-step log-decay magnitude.
    """
    b, t, h, dk = r.shape
    if t % block != 0:
        raise ValueError(f"T={t} is not a multiple of the WKV block {block}")
    nb = t // block
    shp = (b, nb, block, h, dk)
    rb, kb, vb, wb = (a.float().reshape(shp) for a in (r, k, v, w))
    logw = torch.log(torch.clamp(wb, min=1e-38))  # (B, nb, S, H, C), <= 0
    lam = torch.cumsum(logw, dim=2) - logw  # exclusive cumsum Λ
    lb_tot = lam[:, :, -1] + logw[:, :, -1]  # (B, nb, H, C)

    # heads before the block's positions: (B, nb, H, S, C)
    r_t = (rb * torch.exp(lam)).transpose(2, 3)
    k_hat = (kb * torch.exp(-(lam + logw))).transpose(2, 3)
    k_tl = (kb * torch.exp(lb_tot[:, :, None] - lam - logw)).transpose(2, 3)
    vh = vb.transpose(2, 3)

    # intra-block causal pairs + current-token bonus
    a_pairs = r_t @ k_hat.transpose(-1, -2)  # (B, nb, H, S_i, S_j)
    mask = torch.tril(torch.ones((block, block), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    a_pairs = a_pairs.masked_fill(~mask, 0.0)
    a_bonus = (rb * u.float() * kb).sum(-1)  # (B, nb, S, H)
    y_intra = (a_pairs @ vh).transpose(2, 3)  # (B, nb, S, H, V)
    y_intra = y_intra + a_bonus[..., None] * vb

    # each block's state increment k̃ᵀ v, then the carry, block by block (by
    # unbind: its backward stacks the blocks' gradients once, where indexing
    # would scatter each into a zeroed tensor of all blocks)
    kv = k_tl.transpose(-1, -2) @ vh  # (B, nb, H, C, V)
    decay = torch.exp(lb_tot)[..., None]  # (B, nb, H, C, 1)
    s = s0.float()
    states = []
    for d_n, kv_n in zip(decay.unbind(1), kv.unbind(1)):
        states.append(s)
        s = s * d_n + kv_n
    y_inter = (r_t @ torch.stack(states, dim=1)).transpose(2, 3)  # (B, nb, S, H, V)
    return (y_intra + y_inter).reshape(b, t, h, dk), s


def _decay(params, zw):
    # log-decay magnitude clamped to exp(1.2)≈3.32/step: keeps the blocked
    # WKV's largest exponent at BLOCK·3.32≈53 < fp32 overflow (88)
    ww = params.w0 + torch.tanh(zw.float() @ params.w_lora_a) @ params.w_lora_b
    return torch.exp(-torch.exp(torch.clamp(ww, -12.0, 1.2)))  # (…, d) in (0, 1)


def _mixes(x, xp, mix, n: int):
    d = xp - x
    return [x + d * mix[i] for i in range(n)]


def time_mix_inputs(cfg, params, x, shift_state=None):
    """The WKV's inputs from x (B, T, d): r, k, v (B, T, H, Dk) in x's dtype,
    the decay w (B, T, H, Dk) float32 and the gate g (B, T, d)."""
    b, t, d = x.shape
    h, dk = rwkv_dims(cfg)
    prev = shift_state if shift_state is not None else torch.zeros((b, 1, d), dtype=x.dtype,
                                                                   device=x.device)
    zr, zk, zv, zw, zg = _mixes(x, _shift(x, prev), params.mix.to(x.dtype), 5)
    r = (zr @ params.wr.to(x.dtype)).reshape(b, t, h, dk)
    k = (zk @ params.wk.to(x.dtype)).reshape(b, t, h, dk)
    v = (zv @ params.wv.to(x.dtype)).reshape(b, t, h, dk)
    g = F.silu(zg @ params.wg.to(x.dtype))
    return r, k, v, _decay(params, zw).reshape(b, t, h, dk), g


def rwkv_time_mix(cfg, params, x, shift_state=None, wkv_state=None, chunk: int = 256,
                  impl: str = "blocked"):
    """x (B, T, d). Returns (out, (last input token (B, 1, d), wkv state))."""
    b, t, d = x.shape
    h, dk = rwkv_dims(cfg)
    r, k, v, w, g = time_mix_inputs(cfg, params, x, shift_state)
    if wkv_state is None:
        wkv_state = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=x.device)
    impl = getattr(cfg, "wkv_impl", impl)
    if impl == "blocked" and t % WKV_BLOCK == 0 and t >= WKV_BLOCK:
        y, s_end = _wkv_blocked(r, k, v, w, params.u, wkv_state)
    else:
        y, s_end = _wkv_scan(r, k, v, w, params.u, wkv_state, chunk)
    y = _head_norm(y).reshape(b, t, d).to(x.dtype) * g
    return y @ params.wo.to(x.dtype), (x[:, -1:, :], s_end)


def rwkv_channel_mix(cfg, params, x, shift_state=None):
    b, t, d = x.shape
    prev = shift_state if shift_state is not None else torch.zeros((b, 1, d), dtype=x.dtype,
                                                                   device=x.device)
    zk, zr = _mixes(x, _shift(x, prev), params.cm_mix.to(x.dtype), 2)
    kk = torch.square(F.relu(zk @ params.cm_k.to(x.dtype)))
    rr = torch.sigmoid(zr @ params.cm_r.to(x.dtype))
    return rr * (kk @ params.cm_v.to(x.dtype)), x[:, -1:, :]


def rwkv_time_mix_step(cfg, params, x, shift_state, wkv_state):
    """One-token decode. x (B, 1, d); shift (B, 1, d); wkv (B, H, Dk, Dv).
    Returns (out, x as the next shift state, new wkv state)."""
    b, _, d = x.shape
    r, k, v, w, g = time_mix_inputs(cfg, params, x, shift_state)
    r, k, v, w = (a[:, 0].float() for a in (r, k, v, w))  # (B, H, Dk)
    kv = k[..., :, None] * v[..., None, :]
    y = (r[..., None, :] @ wkv_state)[..., 0, :] + _bonus_matmul(r, params.u, kv)
    s_new = wkv_state * w[..., None] + kv
    y = _head_norm(y).reshape(b, 1, d).to(x.dtype) * g
    return y @ params.wo.to(x.dtype), x, s_new
