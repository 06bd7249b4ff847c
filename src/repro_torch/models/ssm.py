"""Mamba-2 / SSD block (zamba2's backbone), chunked-parallel form.

Counterpart of `repro/models/ssm.py`. Recurrence per head (state h: (N, P),
a scalar decay per head and step):
    h_t = a_t h_{t-1} + dt_t · B_t ⊗ x_t          a_t = exp(-dt_t·exp(A_log))
    y_t = C_t · h_t + D ⊙ x_t
Chunked evaluation (Mamba-2 SSD): within a chunk of Q steps the causal decay
matrix L_ij = exp(La_i − La_j) (i ≥ j, La = cumsum log a) gives an O(Q²)
intra-chunk term, and an O(N·P) state carries between chunks. As the
reference's: the short causal conv applies to x only, one B/C group.

One difference by design: the decay matrix is masked BEFORE its `exp`.
Above the diagonal La_i − La_j is a positive sum that passes fp32's exp
range within ~100 steps; the reference exponentiates it and then selects
0, which gives the same forward but a NaN gradient (0 · inf) for dt, a_log
and everything before them at its default chunk of 256. Here the masked
entries get an exponent of −inf: the same forward bits, finite gradients.

The intra-chunk terms and each chunk's state increment are computed for
all chunks at once; only the state's carry runs chunk by chunk (a multiply
and an add a chunk), and the inter-chunk outputs come from the carried
states in one product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, compute_dtype

HEAD_P = 64  # per-head channels (Mamba2 default headdim)


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // HEAD_P


class SSM(Params):
    """Projections, conv and per-head scalars, the reference's names;
    `a_log`, `dt_bias` and `d_skip` stay float32."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        d_inner, h = ssm_dims(cfg)
        n = cfg.ssm_state
        f32 = torch.float32
        # projections: x, z (gate), B, C, dt
        self.weight("in_proj", (d, 2 * d_inner + 2 * n + h), cfg, device)
        self.param("conv_w", (cfg.ssm_conv, d_inner), compute_dtype(cfg), device,
                   ("normal", 0.2))
        self.param("a_log", (h,), f32, device, ("fill", 0.0))
        self.param("dt_bias", (h,), f32, device, ("fill", 0.0))
        self.param("d_skip", (h,), f32, device, ("ones",))
        self.weight("out_proj", (d_inner, d), cfg, device)


def _split_proj(cfg, proj):
    d_inner, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    xz, rest = proj[..., :2 * d_inner], proj[..., 2 * d_inner:]
    return xz[..., :d_inner], xz[..., d_inner:], rest[..., :n], rest[..., n:2 * n], rest[..., 2 * n:]


def _causal_conv(x, w, state=None):
    """Depthwise causal conv; x (B, T, D), w (W, D), state (B, W-1, D) or None.
    Returns (silu(conv), the new state: the last W-1 steps of the padded
    pre-activation input)."""
    wlen = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], wlen - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    y = xp[:, :t] * w[0].to(x.dtype)
    for i in range(1, wlen):
        y = y + xp[:, i:i + t] * w[i].to(x.dtype)
    new_state = xp[:, -(wlen - 1):] if wlen > 1 else pad
    return F.silu(y), new_state


def ssd_chunked(xh, dt, a_log, bm, cm, h0, chunk: int):
    """Chunked SSD scan.

    xh: (B, T, H, P)  dt: (B, T, H)  bm/cm: (B, T, N)  h0: (B, H, N, P)
    Returns y (B, T, H, P) in xh's dtype, h_end (B, H, N, P) float32.
    """
    b, t, h, p = xh.shape
    n = bm.shape[-1]
    q = min(chunk, t)
    if t % q != 0:
        raise ValueError(f"T={t} is not a multiple of the chunk {q}")
    nc = t // q
    f32 = torch.float32

    loga = -dt * torch.exp(a_log.float())[None, None, :]  # (B, T, H) <= 0
    # chunk-major, heads before positions: (B, nc, H, Q[, ...])
    la = torch.cumsum(loga.reshape(b, nc, q, h), dim=2).transpose(2, 3)  # inclusive
    xdt = (xh.float() * dt[..., None]).reshape(b, nc, q, h, p).transpose(2, 3)
    bq = bm.float().reshape(b, nc, q, n)
    cq = cm.float().reshape(b, nc, q, n)

    # intra-chunk: y_i += sum_{j<=i} exp(la_i - la_j) (C_i·B_j) dt_j x_j
    decay = la[..., :, None] - la[..., None, :]  # (B, nc, H, Q_i, Q_j)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    ldec = torch.exp(decay.masked_fill(~mask, float("-inf")))
    cb = cq @ bq.transpose(-1, -2)  # (B, nc, Q_i, Q_j)
    y_intra = (cb[:, :, None] * ldec) @ xdt  # (B, nc, H, Q, P)
    # each chunk's state increment: sum_j exp(la_Q - la_j) dt_j B_j (x) x_j
    tail = torch.exp(la[..., -1:] - la)  # (B, nc, H, Q)
    hb = bq[:, :, None].transpose(-1, -2) @ (xdt * tail[..., None])  # (B, nc, H, N, P)
    chunk_decay = torch.exp(la[..., -1])[..., None, None]  # (B, nc, H, 1, 1)

    hc = h0.to(f32)
    states = []
    for d_c, hb_c in zip(chunk_decay.unbind(1), hb.unbind(1)):  # unbind: see rwkv.py
        states.append(hc)
        hc = hc * d_c + hb_c
    # inter-chunk: y_i += exp(la_i) C_i · h_in
    y_inter = (cq[:, :, None] @ torch.stack(states, dim=1)) * torch.exp(la)[..., None]
    y = (y_intra + y_inter).to(xh.dtype)  # (B, nc, H, Q, P)
    return y.transpose(2, 3).reshape(b, t, h, p), hc


def ssm_apply(cfg, params, x, h0=None, conv_state=None, chunk: int = 256):
    """Full-sequence SSM block. Returns (y, (h_end, conv_end))."""
    b, t, _ = x.shape
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm_state
    proj = x @ params.in_proj.to(x.dtype)
    xc, z, bm, cm, dt = _split_proj(cfg, proj)
    xc, conv_end = _causal_conv(xc, params.conv_w, conv_state)
    dt = F.softplus(dt.float() + params.dt_bias)  # (B, T, H)
    xh = xc.reshape(b, t, h, HEAD_P)
    if h0 is None:
        h0 = torch.zeros((b, h, n, HEAD_P), dtype=torch.float32, device=x.device)
    q = chunk  # halved until it divides T
    while t % q != 0:
        q //= 2
    y, h_end = ssd_chunked(xh, dt, params.a_log, bm, cm, h0, q)
    y = y + xh.float() * params.d_skip[None, None, :, None]
    y = y.reshape(b, t, d_inner).to(x.dtype) * F.silu(z)
    return y @ params.out_proj.to(x.dtype), (h_end, conv_end)


def ssm_decode_step(cfg, params, x, h_state, conv_state):
    """One-token step. x: (B, 1, d); h_state (B, H, N, P); conv (B, W-1, d_inner).
    Returns (out, new h, new conv state)."""
    b = x.shape[0]
    d_inner, h = ssm_dims(cfg)
    proj = x @ params.in_proj.to(x.dtype)
    xc, z, bm, cm, dt = _split_proj(cfg, proj)
    xc, conv_new = _causal_conv(xc, params.conv_w, conv_state)
    dt = F.softplus(dt.float() + params.dt_bias)[:, 0]  # (B, H)
    xh = xc.reshape(b, h, HEAD_P).float()
    a = torch.exp(-dt * torch.exp(params.a_log)[None, :])  # (B, H)
    upd = bm[:, 0].float()[:, None, :, None] * (xh * dt[..., None])[:, :, None, :]
    h_new = h_state * a[:, :, None, None] + upd
    y = (cm[:, 0].float()[:, None, None, :] @ h_new)[:, :, 0]  # (B, H, P)
    y = y + xh * params.d_skip[None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ params.out_proj.to(x.dtype), h_new, conv_new
